"""The port's training slice against the JAX package's, at reduced size in
fp32 on the CPU: AdamW (update, schedule, global norm) on identical grads
and state, byte-identical ``SyntheticLM`` batches, one train step at accum 1
and 2 on bridged weights, checkpoints that restore across the two packages
bit for bit, the five cases of tests/test_training.py re-run on the port,
and the training CLI's output."""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jloop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.bridge import (opt_state_from_numpy,  # noqa: E402
                                       params_from_numpy, params_to_numpy)
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import SyntheticLM, make_batch_iter  # noqa: E402
from repro_torch.training.optimizer import (adamw_init,  # noqa: E402
                                            adamw_update, cosine_schedule,
                                            global_norm)
from repro_torch.training.train_loop import make_train_step, train  # noqa: E402


def _tiny(pkg, dtype="float32"):
    """tests/test_training.py's config."""
    return pkg.reduced(pkg.get_config("deepseek-7b")).replace(
        num_layers=2, d_model=64, d_ff=128, vocab_size=128, dtype=dtype)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _ref_params(dtype="float32", key=0):
    """(JAX params, port params) of the tiny config on the same weights."""
    jcfg, cfg = _tiny(jconfigs, dtype), _tiny(configs, dtype)
    jp = jregistry.get_model(jcfg).init(jax.random.PRNGKey(key))
    return jcfg, cfg, jp, params_from_numpy(cfg, _np_tree(jp), device="cpu")


def _bits(x):
    """A leaf's raw bits as a numpy array (bfloat16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.kind == "V" else a


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Identical params, grads and (step 3, random m, v) state: params, m and
    v after one update within 1e-6 (fp32) or one bf16 ulp; the step agrees
    and the grad norm within rel 1e-5."""
    jcfg, cfg, jp, tp = _ref_params(dtype)
    rng = np.random.default_rng(0)
    shapes = jax.tree.map(lambda x: x.shape, jp)
    jdt = getattr(jnp, dtype)

    def rand(scale, positive=False):
        t = jax.tree.map(lambda s: (scale * rng.normal(size=s)).astype(
            np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
        return jax.tree.map(np.abs, t) if positive else t
    grads_np, m_np, v_np = rand(0.3), rand(0.01), rand(1e-3, positive=True)
    jgrads = jax.tree.map(lambda g: jnp.asarray(g).astype(jdt), grads_np)
    jstate = jopt.AdamWState(step=jnp.int32(3),
                             m=jax.tree.map(jnp.asarray, m_np),
                             v=jax.tree.map(jnp.asarray, v_np))
    lr = dict(base_lr=1e-2, warmup=2, total=50)
    jp2, js2, jn = jopt.adamw_update(
        jgrads, jstate, jp, lr_fn=jopt.cosine_schedule(*lr.values()))

    tgrads = params_from_numpy(cfg, grads_np, device="cpu")
    tstate = opt_state_from_numpy(cfg, (3, m_np, v_np), device="cpu")
    tp2, ts2, tn = adamw_update(tgrads, tstate, tp,
                                lr_fn=cosine_schedule(*lr.values()))
    assert int(ts2.step) == int(js2.step) == 4
    # the norm sums ~10^5 squares in fp32, in another order than XLA's
    assert abs(float(tn) - float(jn)) <= 1e-5 * float(jn)
    for (got, want) in ((tp2, jp2), (ts2.m, js2.m), (ts2.v, js2.v)):
        for g, w in zip(ckpt.flatten(got), jax.tree.leaves(want)):
            if g.dtype == torch.bfloat16:
                gb, wb = (_bits(g).astype(np.int32),
                          _bits(w).astype(np.int32))
                assert np.abs(gb - wb).max() <= 1
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)


def test_cosine_schedule_and_global_norm_match_reference():
    jl, tl = (jopt.cosine_schedule(3e-3, 10, 100),
              cosine_schedule(3e-3, 10, 100))
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray([float(jl(s)) for s in steps])
    got = np.asarray([float(tl(torch.tensor(s))) for s in steps])
    # fp32 cosines of two libraries: 1e-9 is 3e-7 of the base lr
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    _, _, jp, tp = _ref_params()
    assert abs(float(global_norm(tp)) - float(jopt.global_norm(jp))) \
        <= 1e-5 * float(jopt.global_norm(jp))


def test_adamw_init_dtypes_and_step():
    _, _, _, tp = _ref_params()
    st = adamw_init(tp, v_dtype=torch.bfloat16)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert all(x.dtype == torch.float32 and not x.any()
               for x in ckpt.flatten(st.m))
    assert all(x.dtype == torch.bfloat16 for x in ckpt.flatten(st.v))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,vocab", [(0, 0, 128), (3, 7, 128),
                                             (5, 123, 1000)])
def test_synthetic_batches_byte_identical(seed, step, vocab):
    want = jdata.SyntheticLM(vocab, seed=seed).batch_at(step, 3, 16)
    got = SyntheticLM(vocab, seed=seed).batch_at(step, 3, 16)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].tobytes() == want[k].tobytes()
    it = make_batch_iter(vocab, 3, 16, seed=seed, device="cpu")(step)
    assert it["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(it["labels"].numpy(), want["labels"])


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """Loss and grad norm within 1e-5; params after the step within the
    reference's own 5e-3 (AdamW's first step moves every parameter with a
    nonzero gradient by about lr, so the raw gradients are held tighter in
    test_torch_loss.py)."""
    jcfg, cfg, jp, tp = _ref_params()
    b = jdata.SyntheticLM(cfg.vocab_size, seed=2).batch_at(0, 8, 32)
    if accum > 1:
        b = {k: v.reshape(accum, 8 // accum, *v.shape[1:])
             for k, v in b.items()}
    _, jstep = jloop.make_train_step(jcfg, accum=accum, base_lr=1e-3,
                                     warmup=0)
    jm, jp2, _ = jstep(jp, jopt.adamw_init(jp),
                       {k: jnp.asarray(v) for k, v in b.items()})
    _, tstep = make_train_step(cfg, accum=accum, base_lr=1e-3, warmup=0)
    for x in ckpt.flatten(tp):
        x.requires_grad_(True)
    tm, tp2, to2 = tstep(tp, adamw_init(tp),
                         {k: torch.as_tensor(v) for k, v in b.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
    assert int(to2.step) == 1
    for g, w in zip(ckpt.flatten(tp2), jax.tree.leaves(jp2)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=5e-3)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def _ref_template(jcfg):
    japi = jregistry.get_model(jcfg)
    p_t = jax.eval_shape(japi.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    return {"params": p_t, "opt": jax.eval_shape(jopt.adamw_init, p_t)}


def test_checkpoint_saved_by_port_restores_in_reference(tmp_path):
    jcfg, cfg = _tiny(jconfigs, "bfloat16"), _tiny(configs, "bfloat16")
    params = registry.get_model(cfg).init(device="cpu", seed=3)
    opt = adamw_init(params)
    gen = torch.Generator().manual_seed(0)
    for x in ckpt.flatten(opt.m) + ckpt.flatten(opt.v):
        x.copy_(torch.randn(x.shape, generator=gen))
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32))
    d = str(tmp_path / "ck")
    ckpt.save(d, params, opt, {"step": 7})
    jparams, jopt_state, meta = jckpt.restore_latest(
        d, template=_ref_template(jcfg))
    assert meta["step"] == 7
    want = ckpt.flatten({"params": params, "opt": opt})
    got = jax.tree.leaves({"params": jparams, "opt": jopt_state})
    assert len(got) == len(want)
    assert str(jax.tree.leaves(jparams)[0].dtype) == "bfloat16"
    for g, w in zip(got, want):
        assert _bits(g).tobytes() == _bits(w).tobytes()


def test_checkpoint_saved_by_reference_restores_in_port(tmp_path):
    jcfg, cfg = _tiny(jconfigs, "bfloat16"), _tiny(configs, "bfloat16")
    jp = jregistry.get_model(jcfg).init(jax.random.PRNGKey(4))
    js = jopt.adamw_init(jp)
    js = js._replace(step=jnp.int32(11),
                     m=jax.tree.map(lambda x: x + 0.25, js.m))
    d = str(tmp_path / "ck")
    jckpt.save(d, jp, js, {"step": 11})
    specs = registry.param_specs(cfg)
    params, opt, meta = ckpt.restore_latest(
        d, template={"params": specs, "opt": adamw_init(specs)},
        device="cpu")
    assert meta["step"] == 11 and int(opt.step) == 11
    assert opt.step.dtype == torch.int32
    want = jax.tree.leaves({"params": jp, "opt": js})
    got = ckpt.flatten({"params": params, "opt": opt})
    assert params["embed"].dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert _bits(g).tobytes() == _bits(w).tobytes()
    # the restored tree is the port's own: it round-trips through the bridge
    back = params_from_numpy(cfg, params_to_numpy(params), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(ckpt.flatten(back), ckpt.flatten(params)))


def test_checkpoint_restore_rejects_a_wrong_template(tmp_path):
    cfg = _tiny(configs)
    params = registry.get_model(cfg).init(device="cpu", seed=0)
    d = str(tmp_path / "ck")
    ckpt.save(d, params, adamw_init(params), {"step": 1})
    other = registry.param_specs(cfg.replace(d_ff=64))
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_latest(d, template={"params": other,
                                         "opt": adamw_init(other)})


# ---------------------------------------------------------------------------
# tests/test_training.py, re-run on the port
# ---------------------------------------------------------------------------


def _iter(cfg, batch, seq, seed):
    return make_batch_iter(cfg.vocab_size, batch, seq, seed=seed,
                           device="cpu")


def test_loss_decreases():
    cfg = _tiny(configs)
    out = train(cfg, steps=40, batch_iter=_iter(cfg, 4, 32, 0),
                device="cpu", checkpoint_dir=None, base_lr=3e-3, warmup=2)
    losses = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == [0, 10, 20, 30, 39]
    assert min(losses) < losses[0] - 0.2, losses


def test_data_pipeline_deterministic():
    ds = SyntheticLM(128, seed=3)
    a = ds.batch_at(7, 4, 16)
    b = ds.batch_at(7, 4, 16)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = ds.batch_at(8, 4, 16)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_checkpoint_restart_exact(tmp_path):
    """Kill after step 16, resume to 24: the final state equals an
    uninterrupted run's bit for bit (the CPU path is deterministic)."""
    cfg = _tiny(configs)
    it = _iter(cfg, 4, 32, 1)
    full = train(cfg, steps=24, batch_iter=it, device="cpu",
                 checkpoint_dir=str(tmp_path / "uninterrupted"),
                 checkpoint_every=8)
    d2 = str(tmp_path / "crashy")
    train(cfg, steps=16, batch_iter=it, device="cpu", checkpoint_dir=d2,
          checkpoint_every=8)
    resumed = train(cfg, steps=24, batch_iter=it, device="cpu",
                    checkpoint_dir=d2, checkpoint_every=8, resume=True)
    assert [h["step"] for h in resumed["history"]] == [20, 23]
    assert int(resumed["opt"].step) == 24
    for a, b in zip(ckpt.flatten({"p": full["params"], "o": full["opt"]}),
                    ckpt.flatten({"p": resumed["params"],
                                  "o": resumed["opt"]})):
        assert torch.equal(a, b)


def test_checkpoint_atomic_pointer(tmp_path):
    """A half-written checkpoint directory never becomes LATEST."""
    cfg = _tiny(configs)
    api, _ = make_train_step(cfg)
    params = api.init(device="cpu", seed=0)
    opt = adamw_init(params)
    d = str(tmp_path / "ck")
    ckpt.save(d, params, opt, {"step": 5})
    os.makedirs(os.path.join(d, "step_9.tmp"), exist_ok=True)
    specs = registry.param_specs(cfg)
    restored = ckpt.restore_latest(
        d, template={"params": specs, "opt": adamw_init(specs)})
    assert restored is not None
    _, _, meta = restored
    assert meta["step"] == 5


def test_grad_accumulation_equivalence():
    """accum=2 over a split batch == accum=1 over the full batch (loss, and
    params within the reference's 5e-3; each step updates its own copy in
    place)."""
    cfg = _tiny(configs)
    api, step1 = make_train_step(cfg, accum=1)
    _, step2 = make_train_step(cfg, accum=2)
    batch = _iter(cfg, 8, 32, 2)(0)

    def fresh():
        p = api.init(device="cpu", seed=0)
        for x in ckpt.flatten(p):
            x.requires_grad_(True)
        return p, adamw_init(p)
    m1, p1, _ = step1(*fresh(), batch)
    micro = {k: v.reshape(2, 4, *v.shape[1:]) for k, v in batch.items()}
    m2, p2, _ = step2(*fresh(), micro)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    for a, b in zip(ckpt.flatten(p1), ckpt.flatten(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=5e-3)


# ---------------------------------------------------------------------------
# the CLI and the card
# ---------------------------------------------------------------------------


def test_train_cli_prints_the_reference_lines(capsys, tmp_path):
    train_cli.main(["--reduced", "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--ckpt-dir",
                    str(tmp_path / "ck")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3, lines
    for ln, step in zip(lines, (0, 2)):
        assert re.fullmatch(rf"step {step:5d} loss \d+\.\d{{4}}", ln), ln
    assert re.fullmatch(r"final loss \d+\.\d{4} in \d+\.\ds", lines[-1])
    assert open(tmp_path / "ck" / "LATEST").read() == "step_3"


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _tiny(configs)
    for call in (lambda: train(cfg, steps=1, batch_iter=None),
                 lambda: make_batch_iter(128, 2, 4),
                 lambda: train_cli.main(["--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

"""The port's training loss and attention gradient against the JAX package's,
on the same inputs and bridged fp32 weights at reduced size:
``streamed_xent`` (ignored labels, a ragged last chunk, grok's logit
softcap) and its gradients against ``jax.grad``; ``ModelAPI.loss`` for
every family (dense, moe, vlm with ``image_emb``, ssm, hybrid, encdec with
``enc_emb``); the loss's parameter gradients for dense (gemma-7b's GeGLU
too), moe, vlm (paligemma with ``image_emb``) and ssm against
``jax.grad``, and gemma-7b's and paligemma's at head_dim 256; and the
attention gradient the port's CUDA backward computes, through its plain
versions, against ``jax.grad`` of the reference's ``blockwise_attention``
(src/repro/models/common.py:102) at head_dim 32, 64 and 256."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models.common import blockwise_attention  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.training.checkpoint import flatten  # noqa: E402

B, S = 2, 24
FAMILIES = ["deepseek-7b", "granite-moe-1b-a400m", "paligemma-3b",
            "mamba2-780m", "zamba2-1.2b", "whisper-medium", "grok-1-314b"]
GRAD_FAMILIES = ["deepseek-7b", "granite-moe-1b-a400m", "mamba2-780m",
                 "gemma-7b", "paligemma-3b"]
# the families trained at head_dim 256 at full width, their reduced
# configs given it back (reduced() sets 32)
GRAD_HEAD_DIM_256 = ["gemma-7b", "paligemma-3b"]


def _pair(arch, key=0, **over):
    """(JAX api, port api, JAX params, port params) on the same fp32
    weights; ``over`` replaces fields of both reduced configs."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        dtype="float32", **over)
    cfg = configs.reduced(configs.get_config(arch)).replace(dtype="float32",
                                                            **over)
    japi, api = jregistry.get_model(jcfg), registry.get_model(cfg)
    jp = japi.init(jax.random.PRNGKey(key))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return japi, api, jp, tp


def _batches(cfg, seed=0):
    """Seeded tokens and labels (B, S) with ignored labels, plus a VLM's
    image rows or an encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lab[0, 3] = lab[1, -5:] = -100
    arrs = {"tokens": tok, "labels": lab}
    if cfg.family == "vlm":
        arrs["image_emb"] = rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        arrs["enc_emb"] = rng.normal(
            size=(B, cfg.enc_context, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.as_tensor(v) for k, v in arrs.items()})


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# (arch, S, xent_chunk): a chunk that divides S, one that does not (the
# last chunk padded with -100), one longer than S, and grok's logit softcap
XENT_CASES = [("deepseek-7b", 24, 8), ("deepseek-7b", 24, 10),
              ("deepseek-7b", 13, 64), ("grok-1-314b", 24, 10)]


@pytest.mark.parametrize("arch,seq,chunk", XENT_CASES)
def test_streamed_xent_and_its_grads_match_jax(arch, seq, chunk):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        dtype="float32", xent_chunk=chunk)
    cfg = configs.reduced(configs.get_config(arch)).replace(
        dtype="float32", xent_chunk=chunk)
    assert (cfg.logit_softcap > 0) == (arch == "grok-1-314b")
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(B, seq, cfg.d_model)).astype(np.float32)
    table = (0.05 * rng.normal(size=(cfg.vocab_size, cfg.d_model))
             ).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)
    labels[0, :3] = labels[1, -2:] = -100

    def jloss(h, t):
        return jregistry.streamed_xent(jcfg, {"embed": t}, h,
                                       jnp.asarray(labels))
    want, (jgh, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(table))

    h = torch.tensor(hidden, requires_grad=True)
    t = torch.tensor(table, requires_grad=True)
    got = registry.streamed_xent(cfg, {"embed": t}, h,
                                 torch.as_tensor(labels))
    gh, gt = torch.autograd.grad(got, (h, t))
    assert abs(got.item() - float(want)) <= 1e-5
    assert _rel(gh, jgh) <= 1e-4
    assert _rel(gt, jgt) <= 1e-4


def test_streamed_xent_ignores_every_label_without_nan():
    cfg = configs.reduced(configs.get_config("deepseek-7b")).replace(
        dtype="float32", xent_chunk=8)
    h = torch.randn(B, 12, cfg.d_model, requires_grad=True)
    t = torch.randn(cfg.vocab_size, cfg.d_model)
    loss = registry.streamed_xent(cfg, {"embed": t}, h,
                                  torch.full((B, 12), -100))
    (g,) = torch.autograd.grad(loss, (h,))
    assert loss.item() == 0.0 and torch.count_nonzero(g) == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_loss_matches_jax_for_every_family(arch):
    japi, api, jp, tp = _pair(arch)
    jb, tb = _batches(api.cfg)
    want, _ = japi.loss(jp, jb)
    got, metrics = api.loss(tp, tb)
    assert metrics == {}
    assert got.shape == ()
    assert abs(got.item() - float(want)) <= 1e-4, (got.item(), float(want))


@pytest.mark.parametrize("arch", GRAD_FAMILIES)
def test_loss_gradients_match_jax_grad(arch):
    """Every parameter leaf's gradient, in the reference's flatten order,
    within rel 1e-4 / atol 1e-6 of ``jax.grad``."""
    _check_loss_gradients(arch)


@pytest.mark.parametrize("arch", GRAD_HEAD_DIM_256)
def test_loss_gradients_match_jax_grad_at_head_dim_256(arch):
    """As above with head_dim 256 on both configs (4 heads of 256 over
    d_model 128; paligemma's one KV head and image prefix)."""
    _check_loss_gradients(arch, head_dim=256)


def _check_loss_gradients(arch, **over):
    japi, api, jp, tp = _pair(arch, **over)
    if "head_dim" in over:
        assert api.cfg.resolved_head_dim == over["head_dim"]
    jb, tb = _batches(api.cfg)
    jgrads = jax.grad(lambda p: japi.loss(p, jb)[0])(jp)
    leaves = flatten(tp)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = api.loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=f"leaf {i}")


# (B, Sq, Sk, H, KH, D, causal, prefix_len): causal GQA, causal with a
# bidirectional prefix, non-causal Sq != Sk (MQA); head_dim 256: MQA 8 / 1
# with a prefix at a ragged length (paligemma's heads) and MHA 4 / 4
# causal (gemma-7b's); head_dim 32 non-causal Sq != Sk (the reduced
# configs')
ATTN_GRAD_CASES = [(2, 37, 37, 14, 2, 64, True, 0),
                   (1, 40, 40, 4, 2, 32, True, 9),
                   (2, 17, 50, 4, 1, 64, False, 0),
                   (1, 37, 37, 8, 1, 256, True, 16),
                   (2, 33, 33, 4, 4, 256, True, 0),
                   (2, 19, 45, 4, 2, 32, False, 0)]


@pytest.mark.parametrize("case", ATTN_GRAD_CASES)
def test_attention_gradient_matches_jax_grad(case):
    """The CPU path of ``flash_attention`` (its plain version, which
    autograd differentiates) and ``flash_attention_bwd_ref`` (the CUDA
    backward's plain version, from the forward's log-sum-exp) against
    ``jax.grad`` of the reference's ``blockwise_attention``, within 2e-5."""
    Bq, Sq, Sk, H, KH, D, causal, prefix = case
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in (
        (Bq, Sq, H, D), (Bq, Sk, KH, D), (Bq, Sk, KH, D), (Bq, Sq, H, D)))

    def jf(q_, k_, v_):
        o = blockwise_attention(q_, k_, v_, causal=causal, prefix_len=prefix,
                                chunk=16)
        return jnp.sum(o * jnp.asarray(do))
    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, prefix_len=prefix)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)

    o, lse = ref.flash_attention_lse_ref(tq.detach(), tk.detach(),
                                         tv.detach(), causal=causal,
                                         prefix_len=prefix)
    np.testing.assert_allclose(o.numpy(), out.detach().numpy(), atol=2e-6)
    plain = ref.flash_attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), o, lse, torch.as_tensor(do),
        causal=causal, prefix_len=prefix)
    for p, g in zip(plain, got):
        np.testing.assert_allclose(p.numpy(), g.numpy(), atol=2e-5)


# cfg.remat: the transformer's "full" and "dots" (the reference's
# checkpoint_dots_with_no_batch_dims); the ssm, hybrid and encdec families
# remat only under "full", as the reference's
REMAT_CASES = [("deepseek-7b", "full"), ("deepseek-7b", "dots"),
               ("granite-moe-1b-a400m", "dots"), ("mamba2-780m", "full"),
               ("zamba2-1.2b", "full"), ("whisper-medium", "full")]
REMAT_GRAD = ("deepseek-7b", "mamba2-780m")


def _trainable(tree):
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _loss_and_grads(api, params, batch):
    """(loss, gradients in the reference's flatten order) on a trainable
    copy of ``params``."""
    tree = _trainable(params)
    loss, _ = api.loss(tree, batch)
    return loss.item(), torch.autograd.grad(loss, flatten(tree))


@pytest.mark.parametrize("arch,remat", REMAT_CASES)
def test_remat_loss_and_gradients_equal_none_and_jax(arch, remat):
    """Under remat the loss and every gradient leaf equal the un-rematted
    ones (fp32, 1e-6), and the reference's at the same remat: its loss
    (1e-4) and, for a dense and an ssm model, ``jax.grad`` (rel 1e-4 /
    atol 1e-6)."""
    japi, api, jp, tp = _pair(arch)
    jb, tb = _batches(api.cfg)
    rapi = registry.get_model(api.cfg.replace(remat=remat))
    loss0, grads0 = _loss_and_grads(api, tp, tb)
    loss, grads = _loss_and_grads(rapi, tp, tb)
    assert abs(loss - loss0) <= 1e-6, (loss, loss0)
    for i, (g, g0) in enumerate(zip(grads, grads0)):
        assert (g - g0).abs().max().item() <= 1e-6, i
    jrapi = jregistry.get_model(japi.cfg.replace(remat=remat))
    assert abs(loss - float(jrapi.loss(jp, jb)[0])) <= 1e-4
    if arch in REMAT_GRAD:
        want = jax.tree.leaves(jax.grad(lambda p: jrapi.loss(p, jb)[0])(jp))
        for i, (g, w) in enumerate(zip(grads, want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-6, err_msg=f"leaf {i}")


def _empty_like(tree):
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype).requires_grad_(True)


def _peak_step_bytes(remat):
    """Peak live bytes of a 4-layer loss + backward on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import LocalCounter
    cfg = configs.reduced(configs.get_config("deepseek-7b")).replace(
        dtype="float32", num_layers=4, remat=remat)
    api = registry.get_model(cfg)
    with FakeTensorMode():
        tree = _empty_like(registry.param_specs(cfg))
        tok = torch.zeros((2, 512), dtype=torch.int32)
        counter = LocalCounter()
        for x in flatten(tree):
            counter.track(x)
        with counter:
            loss, _ = api.loss(tree, {"tokens": tok, "labels": tok})
            torch.autograd.grad(loss, flatten(tree))
    return counter.peak


def test_remat_lowers_the_peak_of_a_four_layer_step():
    none, full, dots = (_peak_step_bytes(r) for r in ("none", "full",
                                                      "dots"))
    assert full < dots < none, (none, full, dots)

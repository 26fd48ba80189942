"""The port's kernels against the JAX package's: plain PyTorch versions on the
CPU against the jnp oracles and the Pallas kernels (interpret mode), and the
CUDA kernels against the plain versions on a card (``cuda`` marker).

JAX is imported by a fixture, so that the ``cuda`` tests also run where only
PyTorch is installed:  PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels.py"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.block_migration import migrate_blocks  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and oracles."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.block_migration import migrate_blocks as jmigrate
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro.kernels.paged_attention import paged_attention as jpallas
    from repro.models.common import blockwise_attention
    return types.SimpleNamespace(jnp=jnp, ref=ref, migrate=jmigrate,
                                 pallas=jpallas, flash=jflash,
                                 blockwise=blockwise_attention)


SWEEP = [(2, 4, 4, 64, 16, 3),    # MHA
         (3, 8, 2, 64, 16, 4),    # GQA
         (2, 8, 1, 128, 8, 5)]    # MQA
# the paper-7b pair's attention: target G=7 D=128, draft G=7 D=64, bs=8
MAIN = [(2, 28, 4, 128, 8, 4), (3, 14, 2, 64, 8, 5)]


def _attn_inputs(seed, B, T, H, KH, D, bs, maxb):
    rng = np.random.default_rng(seed)
    nblocks = maxb * B + 2
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kp = rng.normal(size=(nblocks, bs, KH, D)).astype(np.float32)
    vp = rng.normal(size=(nblocks, bs, KH, D)).astype(np.float32)
    tables = rng.integers(0, nblocks, size=(B, maxb)).astype(np.int32)
    # ragged: every sequence's length (incl. the T new tokens) differs
    lengths = np.asarray([T + (7 * i) % (maxb * bs - T + 1)
                          for i in range(B)], np.int32)
    return q, kp, vp, tables, lengths


def _torch(arrs, dtype):
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in arrs)
    return q.to(dtype), kp.to(dtype), vp.to(dtype), tables, lengths


def _jax(jx, arrs, dtype):
    q, kp, vp, tables, lengths = (jx.jnp.asarray(a) for a in arrs)
    dt = getattr(jx.jnp, dtype)
    return q.astype(dt), kp.astype(dt), vp.astype(dt), tables, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("B,H,KH,D,bs,maxb", SWEEP)
def test_plain_paged_attention_matches_jax_ref(jx, B, H, KH, D, bs, maxb, T,
                                               dtype):
    arrs = _attn_inputs(7, B, T, H, KH, D, bs, maxb)
    got = paged_attention(*_torch(arrs, getattr(torch, dtype)))
    want = jx.ref.paged_attention_ref(*_jax(jx, arrs, dtype))
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("T", [1, 4, 16])
@pytest.mark.parametrize("B,H,KH,D,bs,maxb", MAIN)
def test_plain_paged_attention_main_path_shapes(jx, B, H, KH, D, bs, maxb, T):
    arrs = _attn_inputs(11, B, T, H, KH, D, bs, maxb)
    got = paged_attention(*_torch(arrs, torch.float32))
    want = jx.ref.paged_attention_ref(*_jax(jx, arrs, "float32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("T,shape", [(1, SWEEP[1]), (4, SWEEP[2]),
                                     (4, MAIN[0]), (1, MAIN[1])])
def test_plain_paged_attention_matches_pallas_interpret(jx, T, shape):
    B, H, KH, D, bs, maxb = shape
    arrs = _attn_inputs(3, B, T, H, KH, D, bs, maxb)
    got = paged_attention(*_torch(arrs, torch.float32))
    want = jx.pallas(*_jax(jx, arrs, "float32"), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_paged_attention_single_query_rank(jx):
    arrs = _attn_inputs(5, *((2, 1) + SWEEP[1][1:]))
    q, kp, vp, tables, lengths = _torch(arrs, torch.float32)
    got = paged_attention(q[:, 0], kp, vp, tables, lengths)
    want = jx.ref.paged_attention_ref(*_jax(jx, (arrs[0][:, 0],) + arrs[1:],
                                            "float32"))
    assert got.shape == q[:, 0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _plan(nb, seed=1):
    m = max(nb // 2, 1)
    src = np.random.default_rng(seed).choice(nb, m, replace=False)
    dst = np.asarray([i for i in range(nb) if i not in src][:m])
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb,row_shape", [(8, (4, 2, 4)), (16, (2, 8, 16)),
                                          (5, (3, 2, 2))])
def test_plain_migrate_blocks_bitwise_equals_jax(jx, dtype, nb, row_shape):
    x = np.random.default_rng(0).normal(size=(3, nb) + row_shape).astype(
        np.float32)
    src, dst = _plan(nb)
    jnp = jx.jnp
    want = jx.migrate(jnp.asarray(x).astype(getattr(jnp, dtype)),
                      jnp.asarray(src), jnp.asarray(dst), use_kernel=False)
    pool = torch.from_numpy(x).to(getattr(torch, dtype))
    got = migrate_blocks(pool, src, dst)
    assert got is pool                     # in place
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("src,dst,msg", [
    ([0, 1], [1, 2], "overlap"),
    ([0, 1], [2, 2], "repeat"),
    ([0], [9], "out of range"),
    ([0, 1], [2], "destinations"),
])
def test_migrate_blocks_rejects_unsafe_plans(src, dst, msg):
    pool = torch.zeros((2, 4, 2, 1, 4))
    with pytest.raises(ValueError, match=msg):
        migrate_blocks(pool, src, dst)


# the reference's flash sweep (tests/test_kernels.py): (B, S, H, KH, D)
FLASH_SWEEP = [(2, 256, 4, 4, 64), (1, 128, 8, 2, 128), (2, 384, 4, 1, 64)]
# ragged lengths, the paper-7b pair's heads (G = 7 at D = 128 and D = 64) and
# G = 1: (B, Sq, Sk, H, KH, D)
FLASH_RAGGED = [(1, 16, 16, 28, 4, 128), (2, 37, 37, 14, 2, 64),
                (1, 200, 200, 4, 4, 32), (2, 37, 200, 14, 2, 64)]


def _flash_inputs(seed, B, Sq, Sk, H, KH, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KH, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KH, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KH,D", FLASH_SWEEP)
def test_plain_flash_attention_matches_pallas_interpret(jx, B, S, H, KH, D,
                                                        causal, dtype):
    arrs = _flash_inputs(3, B, S, S, H, KH, D)
    got = flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                            for a in arrs), causal=causal)
    jnp = jx.jnp
    want = jx.flash(*(jnp.asarray(a).astype(getattr(jnp, dtype))
                      for a in arrs), causal=causal, interpret=True)
    atol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("prefix_len", [0, 5])
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", FLASH_RAGGED)
def test_plain_flash_attention_matches_jax_blockwise(jx, B, Sq, Sk, H, KH, D,
                                                     prefix_len):
    """Ragged lengths, a bidirectional prefix and a non-causal Sq != Sk,
    against the model's chunked jnp attention (64-key chunks, so the ragged
    tail is padded there)."""
    arrs = _flash_inputs(4, B, Sq, Sk, H, KH, D)
    causal = Sq == Sk
    got = flash_attention(*map(torch.from_numpy, arrs), causal=causal,
                          prefix_len=prefix_len)
    want = jx.blockwise(*map(jx.jnp.asarray, arrs), causal=causal,
                        prefix_len=prefix_len, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_wrappers_count_no_launch_on_cpu():
    before = (paged_attention.launches, migrate_blocks.launches,
              flash_attention.launches)
    arrs = _attn_inputs(0, *((2, 1) + SWEEP[0][1:]))
    paged_attention(*_torch(arrs, torch.float32))
    migrate_blocks(torch.zeros((1, 4, 2, 1, 4)), [0], [1])
    flash_attention(*map(torch.from_numpy, _flash_inputs(0, 1, 8, 8, 4, 2,
                                                         32)), causal=True)
    assert (paged_attention.launches, migrate_blocks.launches,
            flash_attention.launches) == before


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 4, 16])
@pytest.mark.parametrize("B,H,KH,D,bs,maxb", SWEEP + MAIN)
def test_cuda_paged_attention_matches_plain(B, H, KH, D, bs, maxb, T, dtype):
    _need_cuda()
    arrs = _attn_inputs(13, B, T, H, KH, D, bs, maxb)
    args = [a.cuda() for a in _torch(arrs, getattr(torch, dtype))]
    n = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == n + 1
    want = tref.paged_attention_ref(*args)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb,row_shape", [(8, (4, 2, 4)), (16, (2, 8, 16)),
                                          (5, (3, 2, 2)), (33, (8, 4, 128))])
def test_cuda_migrate_blocks_bitwise_equals_plain(dtype, nb, row_shape):
    _need_cuda()
    x = torch.randn((3, nb) + row_shape, generator=torch.Generator()
                    .manual_seed(0)).to(getattr(torch, dtype)).cuda()
    src, dst = _plan(nb)
    want = tref.migrate_blocks_ref(x.clone(), src, dst)
    got = migrate_blocks(x, src, dst)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


FLASH_CUDA = [(shape, causal, prefix)
              for shape in ([(b, s, s, h, kh, d)
                             for b, s, h, kh, d in FLASH_SWEEP]
                            + FLASH_RAGGED + [(2, 384, 384, 28, 4, 128)])
              for causal, prefix in ((True, 0), (True, 5), (False, 0))
              if shape[1] == shape[2] or not causal]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,prefix_len", FLASH_CUDA)
def test_cuda_flash_attention_matches_plain(shape, causal, prefix_len,
                                            dtype):
    _need_cuda()
    B, Sq, Sk, H, KH, D = shape
    arrs = _flash_inputs(13, B, Sq, Sk, H, KH, D)
    args = [torch.from_numpy(a).to(getattr(torch, dtype)).cuda()
            for a in arrs]
    n = flash_attention.launches
    got = flash_attention(*args, causal=causal, prefix_len=prefix_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    want = tref.flash_attention_ref(*args, causal=causal,
                                    prefix_len=prefix_len)
    atol = 3e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw,msg", [
    ((1, 16, 4, 48), {}, "head_dim"),
    ((1, 16, 4, 64), {"k_len": 8}, "Sq == Sk"),
])
def test_cuda_flash_attention_rejects_unsupported(shape, kw, msg):
    _need_cuda()
    B, S, H, D = shape
    q = torch.zeros(shape, device="cuda")
    k = torch.zeros((B, kw.get("k_len", S), 2, D), device="cuda")
    with pytest.raises(ValueError, match=msg):
        flash_attention(q, k, k, causal=True)


@pytest.mark.cuda
def test_cuda_paged_decoder_matches_cpu():
    """The reduced paper-7b decoder on the card (every attention call through
    the kernel) equals the CPU decoder on the same weights."""
    _need_cuda()
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = configs.reduced(configs.get_config("paper-7b")).replace(
        dtype="float32")
    api = registry.get_model(cfg)
    params = api.init(device="cpu", seed=0)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 12)))
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = registry.tree_to(params, dev)
        pages = api.init_paged_cache(8, 4, device=dev)
        n = paged_attention.launches
        logits = []
        for lo, hi in ((0, 8), (8, 9), (9, 12)):
            lg, pages = api.decode_step_paged(
                p, pages, tok[:, lo:hi].to(dev), tables.to(dev),
                torch.full((2,), lo, dtype=torch.int32, device=dev))
            logits.append(lg.cpu())
        out[dev] = logits
        launched = paged_attention.launches - n
        assert launched == (0 if dev == "cpu" else 3 * cfg.num_layers)
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=0)

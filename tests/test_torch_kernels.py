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
from repro_torch.kernels.block_migration import (  # noqa: E402
    INLINE_CAP, migrate_blocks)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    TILE, paged_attention, split_plan)


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
# paged: (B, H, KH, D, bs, maxb) — paligemma's target (MQA, G = 8, D 256),
# its draft (G = 4, D 128), granite's target and draft (G = 2, D 64)
PAGED_NEW = [(2, 8, 1, 256, 8, 5), (3, 8, 1, 256, 4, 4),
             (2, 4, 1, 128, 8, 5), (3, 16, 8, 64, 8, 4),
             (2, 8, 4, 64, 8, 4)]
# flash: (B, Sq, Sk, H, KH, D, causal, prefix_len) — paligemma's image
# prefix (256 rows + 16 text tokens), ragged corners at D 256, gemma-7b's
# MHA heads
FLASH_256 = [(2, 272, 272, 8, 1, 256, True, 256),
             (1, 37, 37, 8, 1, 256, True, 0),
             (1, 200, 200, 8, 1, 256, True, 130),
             (2, 37, 200, 8, 1, 256, False, 0),
             (1, 130, 130, 16, 16, 256, True, 0)]


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
@pytest.mark.parametrize("B,H,KH,D,bs,maxb", SWEEP + PAGED_NEW[:2])
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


# rows that see no position (lengths[b] < T): every position of the table
# scores -1e30 alike, so such a row gets the mean of V over the whole table
BLIND = [(4, [2, 40], 6), (4, [0, 3], 2), (16, [5, 16], 3)]


def _blind_inputs(seed, T, lengths, maxb, H=8, KH=2, D=64, bs=8):
    arrs = list(_attn_inputs(seed, len(lengths), T, H, KH, D, bs, maxb))
    arrs[4] = np.asarray(lengths, np.int32)
    return arrs


@pytest.mark.parametrize("T,lengths,maxb", BLIND)
def test_plain_paged_attention_rows_seeing_nothing_match_jax(jx, T, lengths,
                                                             maxb):
    arrs = _blind_inputs(29, T, lengths, maxb)
    got = paged_attention(*_torch(arrs, torch.float32)).numpy()
    for want in (jx.ref.paged_attention_ref(*_jax(jx, arrs, "float32")),
                 jx.pallas(*_jax(jx, arrs, "float32"), interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
    _, _, vp, tables, _ = arrs
    mean = vp[tables].mean(axis=(1, 2))          # (B, KH, D)
    G = got.shape[2] // mean.shape[1]
    for b, n in enumerate(lengths):
        for t in range(T - n):
            np.testing.assert_allclose(got[b, t], np.repeat(mean[b], G, 0),
                                       atol=2e-5)


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


# the paper-7b pair's four page tensors at narrow widths: target (L=3, bs 4,
# KH 2, hd 8) and draft (L=2, bs 4, KH 1, hd 4) K and V, unequal layer
# counts and segment sizes over one NB+1
PAIR_POOLS = [(3, (4, 2, 8)), (3, (4, 2, 8)), (2, (4, 1, 4)), (2, (4, 1, 4))]


def _pair_pools(nb, dtypes, seed=0, pools=PAIR_POOLS):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(L, nb) + rs).astype(np.float32)
            for L, rs in pools], list(dtypes)


@pytest.mark.parametrize("dtypes", [("float32",) * 4, ("bfloat16",) * 4,
                                    ("float32", "float32", "bfloat16",
                                     "bfloat16")])
def test_plain_migrate_blocks_four_pools_bitwise_equals_jax(jx, dtypes):
    """One call over the four page tensors equals the JAX migrate_blocks
    applied to each tensor."""
    xs, dtypes = _pair_pools(17, dtypes)
    src, dst = _plan(17)
    jnp = jx.jnp
    pools = [torch.from_numpy(x).to(getattr(torch, dt))
             for x, dt in zip(xs, dtypes)]
    got = migrate_blocks(pools, src, dst)
    assert got is pools                    # in place
    for x, dt, pool in zip(xs, dtypes, pools):
        want = jx.migrate(jnp.asarray(x).astype(getattr(jnp, dt)),
                          jnp.asarray(src), jnp.asarray(dst),
                          use_kernel=False)
        np.testing.assert_array_equal(pool.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("other", [torch.zeros((2, 5, 2, 1, 4)),
                                   torch.zeros((2, 4, 2, 1, 4),
                                               device="meta")],
                         ids=["nb", "device"])
def test_migrate_blocks_rejects_mismatched_pools(other):
    with pytest.raises(ValueError, match="NB\\+1 or device differ"):
        migrate_blocks([torch.zeros((2, 4, 2, 1, 4)), other], [0], [1])


@pytest.mark.parametrize("src,dst,msg", [
    ([0, 1], [1, 2], "overlap"),
    ([0, 1], [2, 2], "repeat"),
    ([0], [9], "out of range"),
    ([-1], [2], "out of range"),
    ([0, 1], [2], "destinations"),
])
def test_migrate_blocks_four_pools_reject_unsafe_plans(src, dst, msg):
    pools = [torch.zeros((L, 4) + rs) for L, rs in PAIR_POOLS]
    with pytest.raises(ValueError, match=msg):
        migrate_blocks(pools, src, dst)
    assert all(not p.any() for p in pools)


@pytest.mark.parametrize("n", [0, 9])
def test_migrate_blocks_rejects_pool_counts(n):
    with pytest.raises(ValueError, match="1 to 8 pools"):
        migrate_blocks([torch.zeros((1, 4, 2))] * n, [0], [1])


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


# the host-side split-KV plan of paged_attention: (KH, G) of the paper-7b
# target and draft, the query counts of decode, verify (gamma <= 3) and the
# 16-token prefill / chunk appends
SERVE_HEADS = [(4, 7), (2, 7)]
SERVE_T = [1, 2, 3, 4, 16]


@pytest.mark.parametrize("T", SERVE_T)
@pytest.mark.parametrize("KH,G", SERVE_HEADS)
def test_split_plan_one_split_at_serve_shapes(KH, G, T):
    """The served contexts (16-token prompts, 16 outputs, gamma <= 3) need
    tables of at most 8 blocks of 8 positions: one split, so one launch."""
    for B in (1, 2, 3, 4):
        for width in (1, 2, 4, 8):
            for sms in (132, 114):
                n, per = split_plan(B, KH, T * G, width * 8, sms)
                assert n == 1 and per * TILE >= width * 8


@pytest.mark.parametrize("B,width", [(4, 256), (4, 512), (8, 256)])
def test_split_plan_fills_the_card_at_2048_tokens(B, width):
    """Decode at 2,048 tokens of context (tables of 8-position blocks, the
    width a power of two as the serve buckets it): the splits that hold
    positions of the context give at least one block per SM of an H100."""
    n, per = split_plan(B, 4, 7, width * 8, 132)
    assert n > 1
    busy = -(-2048 // (per * TILE))     # splits holding positions < 2048
    assert B * 4 * min(busy, n) >= 132


@pytest.mark.parametrize("max_positions", [8, 64, 256, 257, 512, 1000, 2048,
                                           4096, 16384])
@pytest.mark.parametrize("B,KH,rows", [(1, 1, 1), (4, 4, 7), (4, 2, 112),
                                       (64, 8, 8)])
def test_split_plan_covers_the_table(B, KH, rows, max_positions):
    """Every position of the table falls in exactly one split, no split is
    wholly past the table, and each split has at least 4 tiles unless
    there is a single split."""
    n, per = split_plan(B, KH, rows, max_positions, 132)
    assert n >= 1 and per >= 1
    assert n * per * TILE >= max_positions > (n - 1) * per * TILE
    assert n == 1 or per >= 4


def test_profile_serve_matches_every_kernel_by_name():
    """profile_serve sums the device time of the package's own kernels by
    name: its list must be exactly the __global__ functions of csrc/."""
    import pathlib
    import re
    from repro_torch.launch.profile_serve import OWN_KERNELS
    csrc = pathlib.Path(tref.__file__).resolve().parent / "csrc"
    names = set()
    for src in csrc.glob("*.cu"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
            r"(\w+)\s*\(", src.read_text()))
    assert names == set(OWN_KERNELS)


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
@pytest.mark.parametrize("B,H,KH,D,bs,maxb", SWEEP + MAIN + PAGED_NEW)
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


def _cuda_pair_pools(nb, dtypes, pools=PAIR_POOLS):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn((L, nb) + rs, generator=gen).to(
        getattr(torch, dt)).cuda() for (L, rs), dt in zip(pools, dtypes)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", sorted({1, INLINE_CAP, INLINE_CAP + 1, 2048}))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_migrate_blocks_four_pools_one_launch(M, dtype):
    """The four-tensor call at the paper-7b target's block (8, 4, 128) and
    the draft's (8, 2, 64), with ids inline (M <= INLINE_CAP) and uploaded:
    bitwise equal to the plain version, one launch per call."""
    _need_cuda()
    nb = 2 * M + 3
    pools = _cuda_pair_pools(nb, (dtype,) * 4,
                             [(3, (8, 4, 128))] * 2 + [(2, (8, 2, 64))] * 2)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(M))
    src, dst = perm[:M].tolist(), perm[M:2 * M].tolist()
    want = [tref.migrate_blocks_ref(p.clone(), src, dst) for p in pools]
    n = migrate_blocks.launches
    migrate_blocks(pools, src, dst)
    torch.cuda.synchronize()
    assert migrate_blocks.launches == n + 1
    for got, w in zip(pools, want):
        assert torch.equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("float32", "bfloat16") * 2,
                                    ("bfloat16", "float32") * 2])
@pytest.mark.parametrize("pools", [
    [(3, (3, 2, 2)), (3, (4, 2, 4)), (2, (3, 2, 2)), (2, (2, 8, 16))],
    PAIR_POOLS], ids=["ragged", "pair"])
def test_cuda_migrate_blocks_mixed_and_ragged_pools(pools, dtypes):
    """Float32 and bfloat16 pools in one call, and segments that are not a
    multiple of 16 bytes (the (3, 2, 2) rows, which take the word loop)
    beside ones that are: bitwise equal to the plain version."""
    _need_cuda()
    ps = _cuda_pair_pools(33, dtypes, pools)
    src, dst = _plan(33)
    want = [tref.migrate_blocks_ref(p.clone(), src, dst) for p in ps]
    n = migrate_blocks.launches
    migrate_blocks(ps, src, dst)
    torch.cuda.synchronize()
    assert migrate_blocks.launches == n + 1
    for got, w in zip(ps, want):
        assert torch.equal(got, w)


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


def _long_paged_inputs(seed, B, T, H, KH, D, bs, lengths):
    """Paged inputs at long contexts: each sequence's pages drawn from a
    shuffled pool, the table padded (to a power-of-two width, as the serve
    buckets it) with a trash page holding large finite garbage."""
    rng = np.random.default_rng(seed)
    need = [-(-n // bs) for n in lengths]
    width = 1 << max(max(need) - 1, 0).bit_length()
    nb = sum(need) + 3
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kp = rng.normal(size=(nb + 1, bs, KH, D)).astype(np.float32)
    vp = rng.normal(size=(nb + 1, bs, KH, D)).astype(np.float32)
    kp[nb], vp[nb] = 1e4, -1e4
    perm = rng.permutation(nb)
    tables = np.full((B, width), nb, np.int32)
    for b, n in enumerate(need):
        tables[b, :n], perm = perm[:n], perm[n:]
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 4, 16])
@pytest.mark.parametrize("H,KH,D,bs", [(28, 4, 128, 8), (14, 2, 64, 4),
                                      (8, 1, 256, 8), (16, 8, 64, 8)])
def test_cuda_paged_attention_split_kv_long_context(H, KH, D, bs, T, dtype):
    """Contexts up to 2,048 with ragged lengths in one batch: one sequence
    shorter than one split, one ending exactly on a split boundary; the
    call takes several splits and the combine pass.  The heads of the
    paper-7b pair, paligemma's target (D 256, one KV head) and granite's
    target."""
    _need_cuda()
    B = 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, per = split_plan(B, KH, T * (H // KH), 2048, sms)
    assert n > 1
    split = per * TILE
    lengths = [2048, split - 5, split * min(n - 1, 3), 1500]
    arrs = _long_paged_inputs(17, B, T, H, KH, D, bs, lengths)
    args = [a.cuda() for a in _torch(arrs, getattr(torch, dtype))]
    before = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert paged_attention.last_splits == n
    want = tref.paged_attention_ref(*args)
    assert torch.isfinite(got).all()
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [8, 256])
def test_cuda_paged_attention_rows_seeing_nothing_match_plain(dtype, width):
    """lengths[b] < T: the rows that see no position get the mean of V over
    the whole table, as the plain version does, with one split and with
    several; the other rows match it too."""
    _need_cuda()
    arrs = _blind_inputs(19, 4, [2, 40, 0], width, H=4, KH=4)
    args = [a.cuda() for a in _torch(arrs, getattr(torch, dtype))]
    n = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == n + 1
    assert (paged_attention.last_splits > 1) == (width > 8)
    want = tref.paged_attention_ref(*args)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


# the tensor-core kernel's corners: a long causal prompt, S not a multiple
# of the 64-row tile, a prefix longer than one tile, Sq != Sk, D = 32 / 64 /
# 128 and G = 1 / 7: (B, Sq, Sk, H, KH, D, causal, prefix_len)
FLASH_TC = [(1, 2048, 2048, 28, 4, 128, True, 0),
            (2, 37, 37, 28, 4, 128, True, 0),
            (1, 200, 200, 14, 2, 64, True, 0),
            (1, 200, 200, 28, 4, 128, True, 130),
            (2, 37, 200, 14, 2, 64, False, 0),
            (1, 200, 37, 28, 4, 128, False, 0),
            (1, 200, 200, 4, 4, 32, True, 0),
            (2, 130, 130, 4, 4, 64, True, 130),
            (1, 64, 64, 1, 1, 128, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_TC)
def test_cuda_flash_attention_tensor_core_corners(case, dtype):
    _need_cuda()
    B, Sq, Sk, H, KH, D, causal, prefix_len = case
    arrs = _flash_inputs(23, B, Sq, Sk, H, KH, D)
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


# ---------------------------------------------------------------------------
# head_dim 256 (paligemma-3b's target, gemma-7b) and the new pairs' heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FLASH_256)
def test_plain_flash_attention_head_dim_256_matches_jax_blockwise(jx, case):
    """The image-prefix attention of paligemma's prefill at D 256 against
    the model's chunked jnp attention with ``prefix_len``."""
    B, Sq, Sk, H, KH, D, causal, prefix_len = case
    arrs = _flash_inputs(37, B, Sq, Sk, H, KH, D)
    got = flash_attention(*map(torch.from_numpy, arrs), causal=causal,
                          prefix_len=prefix_len)
    want = jx.blockwise(*map(jx.jnp.asarray, arrs), causal=causal,
                        prefix_len=prefix_len, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_256)
def test_cuda_flash_attention_head_dim_256_matches_plain(case, dtype):
    """Both flash kernels at D 256: the tensor-core one (bf16, Q read per
    k-step from shared memory) and the CUDA-core one (fp32, TF32 off)."""
    _need_cuda()
    B, Sq, Sk, H, KH, D, causal, prefix_len = case
    arrs = _flash_inputs(47, B, Sq, Sk, H, KH, D)
    args = [torch.from_numpy(a).to(getattr(torch, dtype)).cuda()
            for a in arrs]
    n = flash_attention.launches
    got = flash_attention(*args, causal=causal, prefix_len=prefix_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    want = tref.flash_attention_ref(*args, causal=causal,
                                    prefix_len=prefix_len)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# The flash backward (csrc/flash_attention_bwd.cu) and autograd
# ---------------------------------------------------------------------------

# chip_smoke.py's flash_grad shapes at small B: (B, Sq, Sk, H, KH, D,
# causal, prefix_len) — the reference sweep's D 64 / 128 rows, the draft's
# training heads, granite's, a prefix and a non-causal Sq != Sk; then every
# head_dim x {causal GQA, MQA with a bidirectional prefix, non-causal MQA
# with Sq != Sk}, at ragged lengths (MQA's few KV heads take the dK/dV
# pass's split path in bf16)
FLASH_GRAD = [(2, 256, 256, 4, 4, 64, True, 0),
              (2, 256, 256, 4, 4, 64, False, 0),
              (1, 128, 128, 8, 2, 128, True, 0),
              (1, 384, 384, 14, 2, 64, True, 0),
              (1, 256, 256, 16, 8, 64, True, 0),
              (1, 200, 200, 28, 4, 128, True, 130),
              (2, 130, 130, 4, 4, 64, True, 130),
              (2, 37, 200, 14, 2, 64, False, 0),
              (1, 200, 37, 28, 4, 128, False, 0)] + [
    case for D in (32, 64, 128, 256)
    for case in ((2, 130, 130, 8, 2, D, True, 0),
                 (1, 200, 200, 8, 1, D, True, 130),
                 (2, 37, 200, 8, 1, D, False, 0))]


@pytest.mark.parametrize("shape,want", [
    ((2, 4096, 14, 2), 1),     # the draft's training step: 256 blocks
    ((2, 1024, 16, 8), 1),     # granite's: 256 blocks
    ((2, 1024, 8, 1), 8),      # paligemma's MQA: 32 blocks, 8 heads
    ((1, 4096, 32, 32), 1),    # deepseek-7b's MHA
    ((8, 128, 4, 4), 1),       # gemma-7b --reduced: 64 blocks, G = 1
    ((1, 200, 12, 2), 6)])     # 8 blocks: G = 6 takes 6 (2 and 3 fall short)
def test_bwd_split_count_fills_the_card(shape, want):
    """The bf16 dK/dV pass cuts a KV head's group only when its grid of
    (b, KV head, 64-key tile) blocks would leave SMs of the 132 idle, by the
    smallest divisor of the group that fills them."""
    from repro_torch.kernels.flash_attention import kv_splits
    B, Sk, H, KH = shape
    got = kv_splits(B, Sk, H, KH, 132, 64)
    assert got == want
    assert (H // KH) % got == 0


def _grad_inputs(case, dtype, seed=21):
    B, Sq, Sk, H, KH, D = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        getattr(torch, dtype)).cuda()
        for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D),
                  (B, Sq, H, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_GRAD)
def test_cuda_flash_lse_and_backward_match_plain(case, dtype):
    """The forward's log-sum-exp (2e-5) and the backward kernel against
    ``flash_attention_bwd_ref`` on the same saved tensors: fp32 within 2e-4
    (a gradient sums over every key), bf16 within 1e-2 relative."""
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)
    _need_cuda()
    causal, prefix = case[6], case[7]
    q, k, v, do = _grad_inputs(case, dtype)
    out, lse = _forward(q, k, v, causal, prefix, with_lse=True)
    _, want_lse = tref.flash_attention_lse_ref(
        q, k, v, causal=causal, prefix_len=prefix)
    n = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                              prefix_len=prefix)
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                        prefix_len=prefix)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == n + 1
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g).all()
        if dtype == "float32":
            torch.testing.assert_close(g, w, atol=2e-4, rtol=0)
        else:
            rel = (g.float() - w.float()).norm() / w.float().norm()
            assert rel.item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 130, 130, 14, 2, 64),
                                  (2, 130, 130, 8, 1, 256)])
def test_cuda_blockwise_attention_has_a_kernel_gradient(case, dtype):
    """The repair: on the card, attention under autograd has a grad_fn, its
    forward and backward are the CUDA kernels, and q.grad, k.grad and v.grad
    match the plain version's autograd gradient (the draft's heads, and
    paligemma's: head_dim 256, MQA)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models.common import blockwise_attention
    _need_cuda()
    q, k, v, do = _grad_inputs(case, dtype)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    nf, nb = flash_attention.launches, flash_attention_bwd.launches
    out = blockwise_attention(q, k, v, causal=True, prefix_len=5)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        nf + 1, nb + 1)
    want = torch.autograd.grad(
        tref.flash_attention_ref(q, k, v, causal=True, prefix_len=5),
        (q, k, v), do)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        rel = (g.float() - w.float()).norm() / w.float().norm()
        assert rel.item() <= (1e-5 if dtype == "float32" else 1e-2)
    with torch.no_grad():   # serving: the plain launch, no graph
        assert blockwise_attention(q, k, v, causal=True).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 272, 272, 8, 1, 256, True, 256),
                                  (1, 384, 384, 14, 2, 64, True, 0),
                                  (2, 37, 200, 4, 4, 32, False, 0),
                                  (1, 200, 200, 28, 4, 128, True, 130)])
def test_cuda_flash_backward_is_deterministic(case, dtype):
    """Two launches on the same inputs give the same bits: no atomics, and
    the split path's partial sums (paligemma's MQA) added in a fixed
    order."""
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)
    _need_cuda()
    causal, prefix = case[6], case[7]
    q, k, v, do = _grad_inputs(case, dtype)
    out, lse = _forward(q, k, v, causal, prefix, with_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                prefix_len=prefix)
    second = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 prefix_len=prefix)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_paged_and_migration_wrappers_refuse_a_graph():
    _need_cuda()
    arrs = _attn_inputs(0, *((2, 1) + SWEEP[0][1:]))
    q, kp, vp, tables, lengths = (a.cuda() for a in _torch(arrs,
                                                           torch.float32))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_attention(q, kp, vp, tables, lengths)
    with torch.no_grad():
        paged_attention(q, kp, vp, tables, lengths)
    pool = torch.zeros((2, 5, 4), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        migrate_blocks(pool, [0], [1])
    with torch.no_grad():
        migrate_blocks(pool, [0], [1])


# ---------------------------------------------------------------------------
# the flash kernel on the sharded path: custom ops, local_map, fake tensors
# ---------------------------------------------------------------------------


def _one_rank_mesh():
    """A one-rank NCCL group and a (1, 1) ("data", "model") mesh; the
    caller destroys the group."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    return make_debug_mesh(1, 1, device_type="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_local_map_equals_direct_call(dtype):
    """DTensor q / k / v on a one-rank mesh reach the kernel through
    ``blockwise_attention``'s ``local_map``: the output and the gradients
    equal the direct call's bit for bit, and both launch the kernels."""
    _need_cuda()
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models.common import blockwise_attention
    mesh = _one_rank_mesh()
    try:
        g = torch.Generator(device="cuda").manual_seed(3)
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((2, 200, H, 64), device="cuda", generator=g,
                               dtype=dt) for H in (8, 2, 2))
        dq, dk, dv = (distribute_tensor(t, mesh, [Replicate(), Replicate()])
                      .requires_grad_(True) for t in (q, k, v))
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        n, nb = flash_attention.launches, flash_attention_bwd.launches
        want = flash_attention(q, k, v, causal=True)
        got = blockwise_attention(dq, dk, dv, causal=True)
        assert torch.equal(got.to_local(), want)
        want.float().sum().backward()
        got.float().sum().backward()
        for a, b in ((dq, q), (dk, k), (dv, v)):
            assert torch.equal(a.grad.to_local(), b.grad)
        assert flash_attention.launches == n + 2
        assert flash_attention_bwd.launches == nb + 2
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_flash_fake_implementations_have_the_kernels_shapes():
    """Under FakeTensorMode the custom ops return the kernels' shapes and
    dtypes and launch nothing; FlopCounterMode counts the backward at 5/2
    of the forward (this PyTorch's formula call convention)."""
    _need_cuda()
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    n = flash_attention.launches
    with FakeTensorMode():
        q = torch.empty((2, 300, 8, 128), device="cuda",
                        dtype=torch.bfloat16)
        k = torch.empty((2, 300, 2, 128), device="cuda",
                        dtype=torch.bfloat16)
        out = torch.ops.repro_torch.flash_attention(q, k, k, True, 0)
        with FlopCounterMode(display=False) as fwd:
            o2, lse = torch.ops.repro_torch.flash_attention_lse(
                q, k, k, True, 0)
        with FlopCounterMode(display=False) as bwd:
            dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
                q, k, k, o2, lse, o2, True, 0)
    assert fwd.get_total_flops() == 4 * 2 * 8 * 128 * (300 * 301 // 2)
    assert bwd.get_total_flops() == 5 * fwd.get_total_flops() // 2
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (2, 8, 300) and lse.dtype == torch.float32
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert flash_attention.launches == n


@pytest.mark.cuda
def test_cuda_flash_wrapper_refuses_a_dtensor():
    """A DTensor handed to the raw wrapper raises: it never reaches a
    launch and never falls back to the plain version."""
    _need_cuda()
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = _one_rank_mesh()
    try:
        q = distribute_tensor(torch.zeros((1, 16, 4, 64), device="cuda"),
                              mesh, [Replicate(), Replicate()])
        n = flash_attention.launches
        with pytest.raises(TypeError, match="not DTensors"):
            flash_attention(q, q, q, causal=True)
        assert flash_attention.launches == n
    finally:
        dist.destroy_process_group()

// Full-sequence (flash) attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:87
// (`flash_attention`, body `_flash_kernel`), and with it the jnp
// `blockwise_attention` of the reference's models (models/common.py), which
// the port's `forward` and dense-cache `prefill` call.  Unlike the Pallas
// kernel it takes any sequence length (the ragged tail is masked here, so a
// 16-token prompt needs no padding), maps GQA by head index instead of
// repeating K/V in memory, and takes the bidirectional `prefix_len` of
// `blockwise_attention`.
//
// What it computes: q (B, Sq, H, D), k/v (B, Sk, KH, D), contiguous, in the
// JAX layout; query head h reads KV head h / (H / KH).  Scores are
// (q * D^-0.5) . k in fp32, masked by select with the finite -1e30 (causal:
// key j visible to query i iff j <= i or j < prefix_len; non-causal: every
// key), and an online softmax keeps the running max, sum and accumulator in
// fp32.  The output is acc / max(l, 1e-30), cast to q's type.
//
// What bounds it on the H100: operations.  Prefill attention does
// 4 * D flops per visible (query, key) pair and reads each K/V row once per
// query tile, so at the serving shapes (S >= 128) it sits far above the
// ~295 flop/byte ridge.  Two kernels, picked by dtype, both hand-written:
//
// bf16 — `flash_tc_kernel`, on the tensor cores (mma.sync.m16n8k16, bf16 in,
// fp32 accumulate), in the FlashAttention-2 shape:
//   * grid (B * H, ceil(Sq / 64)), the query-tile axis reversed so that the
//     longest causal tiles are dispatched first; one block of 4 warps per
//     64-row query tile of one head, each warp owning 16 rows.  The G heads
//     of a GQA group are neighbours on the grid's fast axis, so their K/V
//     tiles come from L2 rather than being shared in one block: a grouped
//     block would cut the blocks of a 16-token prompt from 28 to 4;
//   * Q, K and V stay bf16 in shared memory, rows padded by 16 bytes so
//     that `ldmatrix` reads are free of bank conflicts; they arrive by
//     16-byte `cp.async` (zero-filled past Sq / Sk) into a two-stage ring,
//     so the loads of key tile t + 1 overlap the products of tile t, with
//     one barrier per tile.  Up to D = 128, Q is loaded once and kept in
//     registers as A fragments;
//   * D = 256: the O accumulator of 16 rows x 256 columns alone takes 128
//     registers a lane, Q's 16 k-steps 64 more and S 32: past the 255 a
//     thread may hold (ptxas spilled ~300 bytes a thread when D was simply
//     raised).  So the block has 8 warps: the two warps of a 16-row tile
//     each own half of O's columns (64 registers) and both compute the
//     tile's S (the Q K^T product is done twice, 1.5x the flops), and each
//     k-step reads its Q fragment from the staged tile with `ldmatrix`;
//   * S = Q K^T accumulates in fp32 registers (K rows through `ldmatrix`
//     are the col-major B operand as stored); the online softmax runs on
//     those registers (row max over the 4 lanes of a quad, two shuffles);
//     P is re-packed to bf16 in registers — the m16n8k16 accumulator
//     layout of two 8-key tiles is the A layout of one 16-key step — and
//     O += P V takes V through `ldmatrix.trans` (the key axis is the
//     reduction axis).  No round trip of P through shared memory;
//   * the output tile goes through shared memory (the Q area) to 16-byte
//     stores.
// wgmma (warpgroup tiles with shared-memory descriptors) and TMA loads are
// the next step; mma.sync's fragment layouts are fixed and checkable
// element by element, where a wrong wgmma descriptor fails silently.
//
// float32 — `flash_simt_kernel`, on the CUDA cores: fp32 must stay within
// 2e-5 of the plain version with TF32 off, which the tensor cores cannot
// give.  Grid (B * H, ceil(Sq / 64)), 256 threads on a 16 x 16 register
// tile per 64 x 64 block of scores, K/V staged in shared memory; a row's
// 64 scores live in one half-warp, so its max and sum are four shuffles.
// At D = 256 its tiles take 218,368 B of shared memory (under the 227 KB
// opt-in): one block per SM.
//
// Both skip causal tiles past the diagonal and past the prefix.  Launches on
// the given stream, does not synchronise and allocates nothing; returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kThreads = 256;   // 16 x 16 thread layout
constexpr int kPStride = kBK + 16;  // half-warps write disjoint banks

// reduce over the 16 lanes of a half-warp (the lanes holding one row)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 1) + kBK * D + kBQ * kPStride;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Sk, int H, int KH,
                  int causal, int prefix_len, float scale) {
  constexpr int QS = D + 4;     // row strides in floats
  constexpr int KS = D + 1;     // odd: a column read across keys is free
  constexpr int DC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBQ][QS], pre-scaled
  float* ks = qs + kBQ * QS;             // [kBK][KS]
  float* vs = ks + kBK * KS;             // [kBK][D]
  float* ps = vs + kBK * D;              // [kBQ][kPStride]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int row = q0 + r;
    float x = 0.f;
    if (row < Sq)
      x = q[((static_cast<size_t>(b) * Sq + row) * H + h) * D + d] * scale;
    qs[r * QS + d] = x;
  }

  float acc[4][DC];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // keys a causal tile can see: up to its last row, or the whole prefix
  const int n_keys = causal ? min(Sk, max(q0 + kBQ, prefix_len)) : Sk;
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < Sk) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + key) * KH + kh) * D + d;
        kx = k[off];
        vx = v[off];
      }
      ks[j * KS + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float smax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && (kpos <= qpos || kpos < prefix_len);
        s[i][j] = ok ? s[i][j] : kNegInf;
        smax = fmaxf(smax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(smax));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + half_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // the tile's probabilities are in shared memory

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[i][c] * inv;
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int KH, int causal,
           int prefix_len, float scale, cudaStream_t stream) {
  constexpr int smem = sizeof(float) * smem_floats<D>();
  const cudaError_t err = kern::allow_smem<flash_simt_kernel<D>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_simt_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Sk, H,
      KH, causal, prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block, 16 per warp
constexpr int kBK = 64;            // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a tile of 64 rows of D bf16, each row padded by 16 bytes: the 8 rows an
// ldmatrix phase reads start 4 banks apart, and every 16-byte chunk stays
// aligned for cp.async
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;  // elements
  static constexpr int kElems = 64 * kStride;
  // Q (reused for the output) + a two-stage ring of K and V
  static constexpr int kSmemBytes = 5 * kElems * 2;
};

// warps sharing a 16-row tile, each owning D / kColSplit columns of O
template <int D>
constexpr int kColSplit = D > 128 ? 2 : 1;
template <int D>
constexpr int kBlockThreads = kThreads * kColSplit<D>;

using kern::cp_async16;
using kern::cp_async_commit;
using kern::cp_async_wait;
using kern::ldmatrix_x4;
using kern::ldmatrix_x4_trans;
using kern::mma_bf16;
using kern::pack_bf16;

// rows [row0, row0 + 64) of one head of a (B, S, heads, D) tensor into a
// padded tile; rows at or past n_rows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* head,
                                          int row_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * kChunks / kBlockThreads<D>; ++it) {
    const int i = threadIdx.x + it * kBlockThreads<D>;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + r * Tile<D>::kStride + c * 8,
               head + static_cast<size_t>(ok ? row : 0) * row_stride + c * 8,
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kBlockThreads<D>)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Sq, int Sk, int H, int KH, int causal, int prefix_len,
                float scale) {
  constexpr int S = Tile<D>::kStride;
  constexpr int E = Tile<D>::kElems;
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int NT = kBK / 8;      // 8-key n-tiles of S
  constexpr int CS = kColSplit<D>;
  constexpr int DT = D / 8 / CS;   // 8-column n-tiles of the warp's O
  constexpr bool kQInRegs = D <= 128;  // else Q's fragments per k-step
  extern __shared__ __align__(128) __nv_bfloat16 sm[];
  __nv_bfloat16* qs = sm;               // [64][S], later the output tile
  __nv_bfloat16* ks = sm + E;           // [2][64][S]
  __nv_bfloat16* vs = sm + 3 * E;       // [2][64][S]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int warp = (threadIdx.x / 32) % kWarps;  // the warp's row tile
  const int col0 = threadIdx.x / kThreads * (D / CS);  // its O columns
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row of the quad in an mma fragment
  const int t4 = lane % 4;  // column pair of the quad

  const __nv_bfloat16* q_head = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const __nv_bfloat16* k_head =
      k + (static_cast<size_t>(b) * Sk * KH + kh) * D;
  const __nv_bfloat16* v_head =
      v + (static_cast<size_t>(b) * Sk * KH + kh) * D;

  // keys a causal tile can see: up to its last row, or the whole prefix
  const int n_keys = causal ? min(Sk, max(q0 + kBQ, prefix_len)) : Sk;
  const int n_tiles = (n_keys + kBK - 1) / kBK;

  load_tile<D>(qs, q_head, H * D, q0, Sq);
  load_tile<D>(ks, k_head, KH * D, 0, Sk);
  load_tile<D>(vs, v_head, KH * D, 0, Sk);
  cp_async_commit();

  uint32_t qf[kQInRegs ? KSTEPS : 1][4];
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  const float scale_log2 = scale * kLog2e;
  const int row_a = q0 + warp * 16 + g;  // query positions of rows g, g + 8

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (kQInRegs && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQInRegs ? KSTEPS : 0); ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * S + kk * 16 +
                                (lane / 16) * 8);
    }
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      load_tile<D>(ks + nxt * E, k_head, KH * D, (t + 1) * kBK, Sk);
      load_tile<D>(vs + nxt * E, v_head, KH * D, (t + 1) * kBK, Sk);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = ks + (t & 1) * E;
    const __nv_bfloat16* vt = vs + (t & 1) * E;
    const int k0 = t * kBK;

    // S = Q K^T: the 64 keys as 8 n-tiles of 8
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, qs + (warp * 16 + lane % 16) * S + kk * 16 +
                            (lane / 16) * 8);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];  // b0, b1 of n-tiles 2 np and 2 np + 1
        ldmatrix_x4(kb, kt + (np * 16 + lane % 8 + 8 * (lane / 16)) * S +
                            kk * 16 + 8 * ((lane / 8) % 2));
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // mask by select: the ragged key tail, the causal diagonal and prefix
    const bool need_mask =
        k0 + kBK > Sk ||
        (causal && k0 + kBK - 1 > q0 && k0 + kBK > prefix_len);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (need_mask) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          const bool ok = key < Sk &&
                          (!causal || key <= row || key < prefix_len);
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
      }

    // online softmax (base 2) on rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m[r] - mx);
      m[r] = mx;
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * r] = exp2f(s[n][2 * r] - mx);
        s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - mx);
        psum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // O += P V: the accumulators of n-tiles 2 kk and 2 kk + 1 are the A
    // fragment of the 16-key step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];  // b0, b1 of column tiles 2 dp and 2 dp + 1
        ldmatrix_x4_trans(vb, vt + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2))
                                       * S + col0 + dp * 16 +
                                  8 * (lane / 16));
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // epilogue: normalise, stage the warp's 16 rows (its columns) in its
  // own rows of the Q tile, then 16-byte stores.  Only the warps of the
  // row tile read those rows; with two, the barrier keeps one from
  // writing them while the other still reads its Q fragments.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lsum = l[r];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    inv[r] = 1.f / fmaxf(lsum, 1e-30f);
    // the row's natural log-sum-exp of the scaled scores (m is base 2)
    const int row = row_a + 8 * r;
    if (lse != nullptr && t4 == 0 && col0 == 0 && row < Sq)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
          (m[r] + log2f(fmaxf(lsum, 1e-30f))) * kLn2;
  }
  if constexpr (CS > 1) __syncthreads();
  __nv_bfloat16* os = qs + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(os + (g + 8 * r) * S + col0 + 8 * n +
                                   2 * t4) =
          pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  __syncwarp();
  constexpr int kChunks = D / 8 / CS;  // the warp's 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks;
    const int c = col0 / 8 + i % kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(b) * Sq + row) * H + h) * D + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * S + c * 8);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int KH, int causal,
           int prefix_len, float scale, cudaStream_t stream) {
  constexpr int smem = Tile<D>::kSmemBytes;
  const cudaError_t err = kern::allow_smem<flash_tc_kernel<D>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_tc_kernel<D><<<grid, kBlockThreads<D>, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H, KH, causal,
      prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           void* out, float* lse, int B, int Sq, int Sk, int H, int KH,
           int causal, int prefix_len, float scale, cudaStream_t s) {
  if (dtype == 0)
    return simt::launch<D>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal,
                           prefix_len, scale, s);
  if (dtype == 1)
    return tc::launch<D>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal,
                         prefix_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q/out:
// (B, Sq, H, D); k/v: (B, Sk, KH, D); causal requires Sq == Sk (checked by
// the wrapper).  lse: null, or (B, H, Sq) float32 that receives each row's
// natural log-sum-exp of the scaled, masked scores (what the backward,
// flash_attention_bwd.cu, needs to recompute the probabilities).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Sk, int H, int KH,
                                      int D, int causal, int prefix_len,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 32:
      return launch<32>(dtype, q, k, v, out, l, B, Sq, Sk, H, KH, causal,
                        prefix_len, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, out, l, B, Sq, Sk, H, KH, causal,
                        prefix_len, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, out, l, B, Sq, Sk, H, KH, causal,
                         prefix_len, scale, s);
    case 256:
      return launch<256>(dtype, q, k, v, out, l, B, Sq, Sk, H, KH, causal,
                         prefix_len, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward of full-sequence (flash) attention for Hopper (sm_90a), plain C
// interface.
//
// No Pallas counterpart: the reference differentiates its jnp
// `blockwise_attention` (src/repro/models/common.py:102) with jax.grad, and
// its Pallas flash kernel (src/repro/kernels/flash_attention.py:87) has no
// backward.  On the card the port's `blockwise_attention` is the forward
// kernel of flash_attention.cu, so the gradient of every attention layer in
// training comes from here.
//
// What it computes, for q (B, Sq, H, D), k/v (B, Sk, KH, D), the forward's
// output o and per-row log-sum-exp lse (B, H, Sq) fp32, and the incoming
// gradient dO (B, Sq, H, D), with the forward's mask (causal: key j
// visible to query i iff j <= i or j < prefix_len; non-causal: every key)
// and query head h reading KV head h / (H / KH):
//   S = Q K^T * D^-0.5,  P = exp(S - lse)  (0 where masked),
//   delta_i = sum_d dO_i,d O_i,d,
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),
//   dQ = dS K * D^-0.5,  dK = dS^T Q * D^-0.5,
// dK and dV summed over the G query heads of a KV head.  Everything is
// accumulated in fp32; inputs and outputs are in q's type (fp32 or bf16).
// head_dim 32, 64, 128 and 256: every head_dim the forward takes.
//
// Three launches (four when the dK/dV grid is split, below), deterministic
// (no atomics: every output element is summed by one thread in a fixed
// order, so two launches give the same bits):
//   1. `flash_bwd_delta_kernel`: delta, one warp per (b, i, h) row;
//   2. dK/dV: one block per (b, KV head, key tile).  K_j and V_j stay in
//      shared memory while the block walks every query tile that can see
//      the key tile (from the diagonal on under causal, all of them when
//      the tile holds prefix keys or the call is non-causal) and, inside
//      that, the G query heads of the group, so GQA's sum over the group
//      needs no atomics.  dK_j and dV_j stay in registers.  When that grid
//      does not fill the card's SMs (MQA: paligemma's 8 heads over one),
//      the wrapper cuts the group into `splits` parts, each block writes
//      fp32 partial sums and `flash_bwd_sum_kernel` adds them in split order;
//   3. dQ: one block per (b, head, query tile), walking the key tiles the
//      forward visited; dQ_i stays in registers.
// Both recompute S and P from the saved log-sum-exp, so nothing of size
// Sq x Sk is stored.  Both grids put the longest causal tiles first.
//
// What bounds it on the H100: operations, 2.5 times the forward's (five
// products of 2 D flops per visible (query, key) pair).  This design does
// seven: the dQ pass recomputes S and dP, since adding dQ from the dK/dV
// pass across blocks deterministically needs an ordered (serialising)
// accumulation.  At 64-row tiles the shared-memory read of an SS product
// (4 KB per m64n64k16, 32 cycles of math) is already the 128 B a clock
// the SM's shared memory gives, and the TMA writes compete with it: at
// the draft's shape the dK/dV pass reaches about 27 % and the dQ pass
// about 40 % of the bf16 peak (PERF.md).
//
// bf16 — `flash_bwd_dkdv_wgmma_kernel` / `flash_bwd_dq_wgmma_kernel`
// (namespace wg), on the tensor cores with Hopper's warpgroup products at
// every head_dim (mma.sync nowhere):
//   * 64-row tiles of Q, K, V and dO arrive by TMA (4-d tensor maps over
//     (D, heads, S, B), rows past S zero-filled by the copy engine) into
//     shared memory in the 128-byte swizzle (64-byte at D = 32) that
//     `wgmma` reads through matrix descriptors.  One producer warp keeps a
//     ring of 3 stages (2 at D = 256) in flight behind full / empty
//     mbarriers; the consumer warpgroup computes.  The block's resident
//     pair (K and V for dK/dV, Q and dO for dQ) is loaded once;
//   * the dK/dV pass computes the scores transposed, S^T = K Q^T and
//     dP^T = V dO^T (`wgmma` m64n64k16, both operands from shared memory,
//     K-major), in two commit groups, so P^T = exp2(S^T - lse) runs while
//     dP^T is still in the tensor cores.  P^T and dS^T leave the fp32
//     accumulators in exactly the register layout of `wgmma`'s A operand,
//     so dV += P^T dO and dK += dS^T Q take them from registers, with dO
//     and Q read from the same staged tiles as the MN-major B operand:
//     P never touches shared memory.  The dQ pass does the same with S =
//     Q K^T, dP = dO V^T and dQ += dS K;
//   * a software pipeline: an iteration's S / dP products are queued right
//     behind the previous iteration's register-A products, which stay in
//     flight across the loop's edge (the dQ pass the same);
//   * every register-A product is m64n64k16 (m64n32k16 at D = 32), one per
//     64 output columns, so a descriptor never spans two swizzle atoms
//     along N;
//   * ptxas serialises every `wgmma` of a kernel it cannot follow (its
//     notes C7511-C7518 in the build output): the role branch is on a
//     warp-uniform value, the mbarrier wait loops inside its asm, every
//     product is unconditional, each batch has its own fence, and dQ's
//     accumulator starts from its first product (scale-d 0), not from a
//     zeroing.  At D <= 128 no product is serialised;
//   * D = 256: dK and dV of 64 keys x 256 columns would take 256 fp32
//     registers a thread in one warpgroup.  So the block has two consumer
//     warpgroups: each owns 128 of the output columns (dK, dV: 128
//     registers) and both compute the tile's S^T and dP^T (4/3 of the
//     products).  Nine warps cap ptxas at 168 registers a thread: the
//     dK/dV pass spills (1,060 bytes of stores, 1,312 of loads a thread
//     on CUDA 12.8) and both passes' products are serialised (C7511 /
//     C7512); the loop drains its products every iteration there.
//   What is left: a fused dQ (an ordered cross-block sum), two consumer
//   warpgroups on 128-row tiles to halve the shared-memory reads per
//   product, the D = 256 registers (setmaxnreg with a producer warpgroup
//   did not lift ptxas' cap), and the causal imbalance (pairing each SM's
//   longest block with its shortest by dispatch order measured slower).
//
// float32 — `simt::flash_bwd_dkdv_kernel` / `simt::flash_bwd_dq_kernel`,
// on the CUDA cores: fp32 must stay within 2e-4 of the plain version with
// TF32 off, which the tensor cores cannot give.  Inputs staged in shared
// memory (row stride D + 1, so a column read across rows is free of bank
// conflicts), 256 threads holding a register tile of each score block;
// 64-row tiles, 32-row at D = 256 (four 64 x 256 fp32 tiles alone would
// pass the 227 KB of shared memory).
//
// Launches on the given stream, does not synchronise and allocates nothing
// (delta's scratch and the partial sums come from the caller); returns
// cudaGetLastError(), or cudaErrorNotSupported when libcuda gives no
// tensor-map encoder.
#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

constexpr int kDeltaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H,
                       int D) {
  const int row = (blockIdx.x * kDeltaThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  const T* orow = o + static_cast<size_t>(row) * D;
  const T* drow = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (b * Sq + i) * H + h  ->  delta[(b * H + h) * Sq + i]
    const int h = row % H;
    const int i = (row / H) % Sq;
    const int b = row / H / Sq;
    delta[(static_cast<size_t>(b) * H + h) * Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// float32: dK/dV and dQ on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 256;  // 16 x 16 thread layout

// rows of a query tile and of a key tile
template <int D>
constexpr int kTileRows = D == 256 ? 32 : 64;

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int prefix_len) {
  if (qpos >= Sq || kpos >= Sk) return false;
  return !causal || kpos <= qpos || kpos < prefix_len;
}

// rows [row0, row0 + BR) of one head of a (B, S, heads, D) tensor into a
// tile of row stride D + 1; rows at or past n_rows are zero
template <int BR, int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ head,
                                          int row_stride, int row0,
                                          int n_rows) {
  for (int i = threadIdx.x; i < BR * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] =
        row < n_rows ? head[static_cast<size_t>(row) * row_stride + d] : 0.f;
  }
}

// lse and delta of rows [row0, row0 + BR) of one (b, h); 0 past Sq
template <int BR>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ dl,
                                               int row0, int Sq) {
  for (int r = threadIdx.x; r < BR; r += kThreads) {
    const int row = row0 + r;
    lse_s[r] = row < Sq ? lse[row] : 0.f;
    delta_s[r] = row < Sq ? dl[row] : 0.f;
  }
}

// The thread's (query, key) pairs of a BR x BR tile (queries ty + 16 a,
// keys tx + 16 c): P = exp(S * scale - lse) and dS = P * (dP - delta),
// with S = Q K^T and dP = dO V^T, written into the shared P (if given) and
// dS tiles (row stride BR + 1), rows by query.
template <int BR, int D>
__device__ __forceinline__ void probs_and_grads(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, float* ps, float* dss, int q0,
    int k0, int Sq, int Sk, int causal, int prefix_len, float scale) {
  constexpr int S = D + 1;
  constexpr int R = BR / 16;
  constexpr int PS = BR + 1;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      qv[a] = qs[(ty + 16 * a) * S + d];
      dov[a] = dos[(ty + 16 * a) * S + d];
      kv[a] = ks[(tx + 16 * a) * S + d];
      vv[a] = vs[(tx + 16 * a) * S + d];
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[a][c] += qv[a] * kv[c];
        dp[a][c] += dov[a] * vv[c];
      }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = ty + 16 * a;
    const float l = lse_s[r];
    const float dl = delta_s[r];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = tx + 16 * c;
      const float p = visible(q0 + r, k0 + j, Sq, Sk, causal, prefix_len)
                          ? expf(s[a][c] * scale - l)
                          : 0.f;
      if (ps != nullptr) ps[r * PS + j] = p;
      dss[r * PS + j] = p * (dp[a][c] - dl);
    }
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  constexpr int BR = kTileRows<D>;
  return 4 * BR * (D + 1) + 2 * BR * (BR + 1) + 2 * BR;
}

// dK, dV: one block per (b, KV head, key tile)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int Sq, int Sk, int H, int KH,
                      int causal, int prefix_len, float scale) {
  constexpr int BR = kTileRows<D>;
  constexpr int S = D + 1;
  constexpr int R = BR / 16;   // key rows per thread
  constexpr int DC = D / 16;   // output columns per thread
  constexpr int PS = BR + 1;
  extern __shared__ float smem[];
  float* ks = smem;            // [BR][S]
  float* vs = ks + BR * S;     // [BR][S]
  float* qs = vs + BR * S;     // [BR][S]
  float* dos = qs + BR * S;    // [BR][S]
  float* ps = dos + BR * S;    // [BR][PS], rows by query
  float* dss = ps + BR * PS;   // [BR][PS], rows by query
  float* lse_s = dss + BR * PS;
  float* delta_s = lse_s + BR;

  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  const int G = H / KH;
  const int k0 = blockIdx.y * BR;  // tile 0, the most work, goes first
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_rows<BR, D>(ks, k + (static_cast<size_t>(b) * Sk * KH + kh) * D,
                   KH * D, k0, Sk);
  load_rows<BR, D>(vs, v + (static_cast<size_t>(b) * Sk * KH + kh) * D,
                   KH * D, k0, Sk);

  float dk_acc[R][DC], dv_acc[R][DC];  // keys ty + 16 a, columns tx + 16 c
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  // query tiles that see a key of this tile: under causal, those from the
  // diagonal on (Sq == Sk, equal tiles), or all when it holds prefix keys
  const int qt0 = causal && k0 >= prefix_len ? blockIdx.y : 0;
  const int n_qt = (Sq + BR - 1) / BR;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BR;
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      __syncthreads();  // every thread is done with the previous tiles
      load_rows<BR, D>(qs, q + (static_cast<size_t>(b) * Sq * H + h) * D,
                       H * D, q0, Sq);
      load_rows<BR, D>(dos,
                       dout + (static_cast<size_t>(b) * Sq * H + h) * D,
                       H * D, q0, Sq);
      const size_t stats = (static_cast<size_t>(b) * H + h) * Sq;
      load_row_stats<BR>(lse_s, delta_s, lse + stats, delta + stats, q0, Sq);
      __syncthreads();
      probs_and_grads<BR, D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0,
                             k0, Sq, Sk, causal, prefix_len, scale);
      __syncthreads();
      // dV_j += P^T dO_i, dK_j += dS^T Q_i (scaled at the end)
#pragma unroll 4
      for (int i = 0; i < BR; ++i) {
        float pv[R], dsv[R], dov[DC], qv[DC];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pv[a] = ps[i * PS + ty + 16 * a];
          dsv[a] = dss[i * PS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dov[c] = dos[i * S + tx + 16 * c];
          qv[c] = qs[i * S + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[a][c] += pv[a] * dov[c];
            dk_acc[a][c] += dsv[a] * qv[c];
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= Sk) continue;
    const size_t off = ((static_cast<size_t>(b) * Sk + key) * KH + kh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = dk_acc[a][c] * scale;
      dv[off + tx + 16 * c] = dv_acc[a][c];
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  constexpr int BR = kTileRows<D>;
  return 4 * BR * (D + 1) + BR * (BR + 1) + 2 * BR;
}

// dQ: one block per (b, head, query tile)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Sk, int H, int KH, int causal, int prefix_len,
                    float scale) {
  constexpr int BR = kTileRows<D>;
  constexpr int S = D + 1;
  constexpr int R = BR / 16;
  constexpr int DC = D / 16;
  constexpr int PS = BR + 1;
  extern __shared__ float smem[];
  float* qs = smem;            // [BR][S]
  float* dos = qs + BR * S;    // [BR][S]
  float* ks = dos + BR * S;    // [BR][S]
  float* vs = ks + BR * S;     // [BR][S]
  float* dss = vs + BR * S;    // [BR][PS], rows by query
  float* lse_s = dss + BR * PS;
  float* delta_s = lse_s + BR;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // longest tiles first
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_rows<BR, D>(qs, q + (static_cast<size_t>(b) * Sq * H + h) * D, H * D,
                   q0, Sq);
  load_rows<BR, D>(dos, dout + (static_cast<size_t>(b) * Sq * H + h) * D,
                   H * D, q0, Sq);
  const size_t stats = (static_cast<size_t>(b) * H + h) * Sq;
  load_row_stats<BR>(lse_s, delta_s, lse + stats, delta + stats, q0, Sq);

  float acc[R][DC];  // queries ty + 16 a, columns tx + 16 c
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  // the key tiles the forward visited: up to the tile's last row, or the
  // whole prefix
  const int n_keys = causal ? min(Sk, max(q0 + BR, prefix_len)) : Sk;
  const int n_kt = (n_keys + BR - 1) / BR;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BR;
    __syncthreads();  // every thread is done with the previous key tile
    load_rows<BR, D>(ks, k + (static_cast<size_t>(b) * Sk * KH + kh) * D,
                     KH * D, k0, Sk);
    load_rows<BR, D>(vs, v + (static_cast<size_t>(b) * Sk * KH + kh) * D,
                     KH * D, k0, Sk);
    __syncthreads();
    probs_and_grads<BR, D>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0,
                           k0, Sq, Sk, causal, prefix_len, scale);
    __syncthreads();
    // dQ_i += dS K_j (scaled at the end)
#pragma unroll 4
    for (int j = 0; j < BR; ++j) {
      float dsv[R], kv[DC];
#pragma unroll
      for (int a = 0; a < R; ++a) dsv[a] = dss[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[j * S + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] += dsv[a] * kv[c];
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
    float* out = dq + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) out[tx + 16 * c] = acc[a][c] * scale;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: dK/dV and dQ on the tensor cores (wgmma, TMA, mbarriers)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kRows = 64;  // rows of every tile: 64 queries or 64 keys

template <int D>
struct Cfg {
  static constexpr int kWG = D == 256 ? 2 : 1;   // consumer warpgroups
  static constexpr int kDW = D / kWG;            // output columns of each
  static constexpr int kN = D < 64 ? D : 64;     // N of a register-A product
  static constexpr int kNB = kDW / kN;           // those products per k-step
  static constexpr int kRowBytes = D == 32 ? 64 : 128;  // one swizzled row
  static constexpr int kBoxCols = kRowBytes / 2;  // columns of a TMA box
  static constexpr int kBlocks = D / kBoxCols;    // column blocks of a tile
  static constexpr int kBlockBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kBlocks * kBlockBytes;
  static constexpr int kLayout = D == 32 ? 2 : 1;  // descriptor: 64B, 128B
  static constexpr int kStages = D == 256 ? 2 : 3;
  // + the producer warp.  Nine warps put three on one sub-partition,
  // which caps ptxas at 168 registers a thread: D = 256's dK/dV pass
  // spills
  static constexpr int kThreads = 128 * kWG + 32;
  // one iteration's products stay in flight across the loop's edge (the
  // software pipeline below); not at D = 256, where ptxas serialises the
  // products for want of registers and the pipeline only adds spills
  static constexpr bool kPipe = kWG == 1;
  // tiles 0, 1: the resident pair; 2 + 2 s, 3 + 2 s: stage s of the ring;
  // then per stage 64 log2-scaled log-sum-exps and 64 deltas; then the
  // barriers full[kStages], empty[kStages], resident
  static constexpr int kStatsOff = (2 + 2 * kStages) * kTileBytes;
  static constexpr int kBarOff = kStatsOff + kStages * 2 * kRows * 4;
  static constexpr int kSmemBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   kern::smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   kern::smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          kern::smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// until the barrier's phase of this parity has completed.  The loop is
// inside the asm: a C++ loop on a per-thread predicate would put the
// products after it on a divergent path, and ptxas serialises `wgmma`
// there
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(kern::smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the warp's index as a warp-uniform value (a broadcast), so that a branch
// on it is not divergent to ptxas
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
}

// one box (kBoxCols columns x 64 rows of one head of one sequence) by TMA
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int head, int row, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(b), "r"(kern::smem_u32(bar))
      : "memory");
}

// rows [row0, row0 + 64) of one head as a swizzled tile at `dst`
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int head, int row0, int b,
                                          uint64_t* bar) {
  using C = Cfg<D>;
#pragma unroll
  for (int cb = 0; cb < C::kBlocks; ++cb)
    tma_load(dst + cb * C::kBlockBytes, map, cb * C::kBoxCols, head, row0, b,
             bar);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}
// K-major operand, k-step kk (16 columns) of a 64-row tile: the rows are
// M or N, 8-row groups kRowBytes * 8 apart
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using C = Cfg<D>;
  const int byte = kk * 32;
  return make_desc(tile + (byte / C::kRowBytes) * C::kBlockBytes +
                       byte % C::kRowBytes,
                   16, 8 * C::kRowBytes, C::kLayout);
}
// MN-major B operand: the tile's rows 16 kk .. 16 kk + 15 are K, its
// columns c0 .. c0 + kN - 1 (one swizzle atom) are N.  Only the stride of
// the 8-row groups along K is read; both offsets carry it.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int c0) {
  using C = Cfg<D>;
  return make_desc(tile + (c0 / C::kBoxCols) * C::kBlockBytes +
                       kk * 16 * C::kRowBytes,
                   8 * C::kRowBytes, 8 * C::kRowBytes, C::kLayout);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the compiler may not move reads or writes of these registers across
// this point (an asynchronous product reads or writes them until its wait)
template <int N>
__device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void keep(float (&x)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) keep(x[i]);
}
template <int M>
__device__ __forceinline__ void keep(uint32_t (&x)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// d (64 x 64) {=, +=} A (64 x 16, smem) * B (16 x 64, smem); both K-major
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) {=, +=} A (64 x 16, registers) * B (16 x 32, smem,
// MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[16],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64) {=, +=} A (64 x 16, registers) * B (16 x 64, smem,
// MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// a 64 x 64 fp32 accumulator (the m64n64 layout) as the A operand of four
// k-steps of 16: the accumulator of n-tiles 2 kk, 2 kk + 1 is the A
// fragment of k-step kk, packed to bf16 pairs
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = kern::pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t at = kern::smem_u32(raw);
  return raw + (((at + 1023u) & ~1023u) - at);
}

template <int D>
__device__ __forceinline__ void init_barriers(uint64_t* bars,
                                              int full_count) {
  using C = Cfg<D>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + s, full_count);
      mbar_init(bars + C::kStages + s, 128 * C::kWG);
    }
    mbar_init(bars + 2 * C::kStages, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The warpgroup's 64 x kN accumulators (rows row0 + 16 w + g, + 8) into a
// (B, S, heads, D) tensor from column c0, times `mult`: bf16 pairs, or
// fp32 pairs into a partial sum
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(dst) = kern::pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <int NB, int N, typename T>
__device__ __forceinline__ void store_rows(T* head, int row_stride,
                                           int row0, int n_rows, int c0,
                                           const float (&acc)[NB][N / 2],
                                           float mult) {
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * (tid / 32) + g + 8 * r;
    if (row >= n_rows) continue;
    T* dst = head + static_cast<size_t>(row) * row_stride + c0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        store_pair(dst + nb * N + 8 * j + 2 * t4,
                   acc[nb][4 * j + 2 * r] * mult,
                   acc[nb][4 * j + 2 * r + 1] * mult);
  }
}

// dK, dV: one block per (b, KV head, split, 64-key tile).  The resident
// pair is K, V; the ring carries (Q, dO, the rows' log2-scaled lse and
// delta) of each (query tile, head of the split's part of the group) in
// turn.  With one split the block writes dK and dV; with several (a grid
// too small for the card, as MQA's) each writes its fp32 partial sums to
// `part` ([2][splits][B, Sk, KH, D]), which `flash_bwd_sum_kernel` adds up.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int splits,
    int Sq, int Sk, int H, int KH, int causal, int prefix_len, float scale) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = kern::smem_u32(sm);
  float* stats = reinterpret_cast<float*>(sm + C::kStatsOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  uint64_t* resident = full + 2 * C::kStages;

  const int split = blockIdx.x % splits;
  const int b = blockIdx.x / splits / KH;
  const int kh = blockIdx.x / splits % KH;
  const int G = H / KH / splits;           // heads of this split
  const int h0 = kh * (H / KH) + split * G;
  const int k0 = blockIdx.y * kRows;  // tile 0, the most work, goes first
  // query tiles that see a key of this tile: under causal, those from the
  // diagonal on (Sq == Sk, equal tiles), or all when it holds prefix keys
  const int qt0 = causal && k0 >= prefix_len ? blockIdx.y : 0;
  const int n_it = ((Sq + kRows - 1) / kRows - qt0) * G;
  init_barriers<D>(full, 32);

  const int warp = warp_index();
  if (warp >= 4 * C::kWG) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(resident, 2 * C::kTileBytes);
      load_tile<D>(base, &tm_k, kh, k0, b, resident);
      load_tile<D>(base + C::kTileBytes, &tm_v, kh, k0, b, resident);
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % C::kStages;
      mbar_wait(empty + st, ((it / C::kStages) & 1) ^ 1);
      const int q0 = (qt0 + it / G) * kRows;
      const int h = h0 + it % G;
      const size_t row = (static_cast<size_t>(b) * H + h) * Sq;
      float* st_s = stats + st * 2 * kRows;
      for (int r = lane; r < kRows; r += 32) {
        const bool ok = q0 + r < Sq;
        st_s[r] = ok ? lse[row + q0 + r] * kLog2e : 0.f;
        st_s[kRows + r] = ok ? delta[row + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(full + st, 2 * C::kTileBytes);
        const uint32_t qt = base + (2 + 2 * st) * C::kTileBytes;
        load_tile<D>(qt, &tm_q, h, q0, b, full + st);
        load_tile<D>(qt + C::kTileBytes, &tm_do, h, q0, b, full + st);
      } else {
        mbar_arrive(full + st);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int c0 = warp / 4 * C::kDW;  // this warpgroup's columns
  const float scale_log2 = scale * kLog2e;
  const int key_a = k0 + 16 * (warp % 4) + lane / 4;  // rows g, g + 8

  float dk_acc[C::kNB][C::kN / 2], dv_acc[C::kNB][C::kN / 2];
  float s[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int nb = 0; nb < C::kNB; ++nb)
#pragma unroll
    for (int i = 0; i < C::kN / 2; ++i) dk_acc[nb][i] = dv_acc[nb][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = da[kk][j] = 0u;
  const uint32_t kt = base, vt = base + C::kTileBytes;
  mbar_wait(resident, 0);

  // A software pipeline: iteration it's scores are queued right behind
  // iteration it - 1's dV / dK products, which stay in flight across the
  // loop's edge, so the tensor cores do not wait for this warpgroup's
  // exp2 and packing; a stage is released once the products that read it
  // are done.  Every product is unconditional and each batch has its own
  // fence: ptxas serialises `wgmma` it cannot follow.
  for (int it = 0; it < n_it; ++it) {
    const int st = it % C::kStages;
    const uint32_t qt = base + (2 + 2 * st) * C::kTileBytes;
    const uint32_t dot = qt + C::kTileBytes;
    const float* lse_s = stats + st * 2 * kRows;
    const float* delta_s = lse_s + kRows;
    const int q0 = (qt0 + it / G) * kRows;

    mbar_wait(full + st, (it / C::kStages) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
      mma_ss_n64(s, desc_k<D>(kt, kk), desc_k<D>(qt, kk), kk);
    wg_commit();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
      mma_ss_n64(dp, desc_k<D>(vt, kk), desc_k<D>(dot, kk), kk);
    wg_commit();
    wg_wait<1>();  // S^T, and iteration it - 1's products, are done
    keep(s);
    keep(dk_acc);
    keep(dv_acc);
    keep(pa);
    keep(da);
    if (C::kPipe && it > 0) mbar_arrive(empty + (it - 1) % C::kStages);
    const bool need_mask =
        q0 + kRows > Sq ||
        (causal && k0 + kRows - 1 > q0 && k0 + kRows > prefix_len);
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // P^T, while dP^T is in the tensor cores
      const int col = 8 * (i / 4) + 2 * t4 + (i & 1);  // query in the tile
      float x = exp2f(s[i] * scale_log2 - lse_s[col]);
      if (need_mask) {
        const int qpos = q0 + col;
        const int key = key_a + 8 * ((i / 2) & 1);
        x = qpos < Sq && (!causal || key <= qpos || key < prefix_len) ? x
                                                                      : 0.f;
      }
      s[i] = x;
    }
    to_a(pa, s);
    wg_wait<0>();
    keep(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)  // dS^T
      dp[i] = s[i] * (dp[i] - delta_s[8 * (i / 4) + 2 * t4 + (i & 1)]);
    to_a(da, dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < C::kNB; ++nb) {  // dV += P^T dO, dK += dS^T Q
        mma_rs(dv_acc[nb], pa[kk], desc_mn<D>(dot, kk, c0 + nb * C::kN), 1);
        mma_rs(dk_acc[nb], da[kk], desc_mn<D>(qt, kk, c0 + nb * C::kN), 1);
      }
    wg_commit();
    if constexpr (!C::kPipe) {
      wg_wait<0>();
      keep(dk_acc);
      keep(dv_acc);
      keep(pa);
      keep(da);
      mbar_arrive(empty + st);
    }
  }
  wg_wait<0>();
  keep(dk_acc);
  keep(dv_acc);
  keep(pa);
  keep(da);

  const size_t out = (static_cast<size_t>(b) * Sk * KH + kh) * D;
  if (splits == 1) {
    store_rows<C::kNB, C::kN>(dk + out, KH * D, k0, Sk, c0, dk_acc, scale);
    store_rows<C::kNB, C::kN>(dv + out, KH * D, k0, Sk, c0, dv_acc, 1.f);
  } else {
    const size_t n = static_cast<size_t>(gridDim.x / splits) * Sk * D;
    store_rows<C::kNB, C::kN>(part + split * n + out, KH * D, k0, Sk, c0,
                              dk_acc, scale);
    store_rows<C::kNB, C::kN>(part + (splits + split) * n + out, KH * D, k0,
                              Sk, c0, dv_acc, 1.f);
  }
}

// dK, dV = the splits' partial sums, added in split order: n elements
// each, four per thread
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, int splits, size_t n,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* src = part + static_cast<size_t>(which) * splits * n + i;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(src + s * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 packed;
    packed.x = kern::pack_bf16(acc.x, acc.y);
    packed.y = kern::pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>((which ? dv : dk) + i) = packed;
  }
}

// dQ: one block per (b, head, 64-query tile).  The resident pair is Q,
// dO; the ring carries (K, V) of each key tile the forward visited.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int H, int KH, int causal, int prefix_len, float scale) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = kern::smem_u32(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  uint64_t* resident = full + 2 * C::kStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  // the key tiles the forward visited: up to the tile's last row, or the
  // whole prefix
  const int n_keys = causal ? min(Sk, max(q0 + kRows, prefix_len)) : Sk;
  const int n_kt = (n_keys + kRows - 1) / kRows;
  init_barriers<D>(full, 1);

  const int warp = warp_index();
  if (warp >= 4 * C::kWG) {  // the producer warp
    if (threadIdx.x % 32 != 0) return;
    mbar_arrive_tx(resident, 2 * C::kTileBytes);
    load_tile<D>(base, &tm_q, h, q0, b, resident);
    load_tile<D>(base + C::kTileBytes, &tm_do, h, q0, b, resident);
    for (int t = 0; t < n_kt; ++t) {
      const int st = t % C::kStages;
      mbar_wait(empty + st, ((t / C::kStages) & 1) ^ 1);
      mbar_arrive_tx(full + st, 2 * C::kTileBytes);
      const uint32_t kt = base + (2 + 2 * st) * C::kTileBytes;
      load_tile<D>(kt, &tm_k, kh, t * kRows, b, full + st);
      load_tile<D>(kt + C::kTileBytes, &tm_v, kh, t * kRows, b, full + st);
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int c0 = warp / 4 * C::kDW;
  const float scale_log2 = scale * kLog2e;
  const int row_a = q0 + 16 * (warp % 4) + lane / 4;  // rows g, g + 8
  float lse2[2], dl[2];
  const size_t stats = (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < Sq ? lse[stats + row] * kLog2e : 0.f;
    dl[r] = row < Sq ? delta[stats + row] : 0.f;
  }

  // dQ starts from the first product (scale-d 0): zeroing it here instead
  // makes ptxas serialise every `wgmma` of the kernel (C7515)
  float acc[C::kNB][C::kN / 2];
  float s[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) da[kk][j] = 0u;
  const uint32_t qt = base, dot = base + C::kTileBytes;
  mbar_wait(resident, 0);

  // the dK/dV pass's pipeline: tile t's scores go right behind tile
  // t - 1's dQ product
  for (int t = 0; t < n_kt; ++t) {
    const int st = t % C::kStages;
    const uint32_t kt = base + (2 + 2 * st) * C::kTileBytes;
    const int k0 = t * kRows;

    mbar_wait(full + st, (t / C::kStages) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
      mma_ss_n64(s, desc_k<D>(qt, kk), desc_k<D>(kt, kk), kk);
    wg_commit();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
      mma_ss_n64(dp, desc_k<D>(dot, kk), desc_k<D>(kt + C::kTileBytes, kk),
                 kk);
    wg_commit();
    wg_wait<1>();  // S, and tile t - 1's product, are done
    keep(s);
    keep(acc);
    keep(da);
    if (C::kPipe && t > 0) mbar_arrive(empty + (t - 1) % C::kStages);
    const bool need_mask =
        k0 + kRows > Sk ||
        (causal && k0 + kRows - 1 > q0 && k0 + kRows > prefix_len);
    float p[32];  // P apart from S: only `wgmma` writes an accumulator
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) & 1;
      float x = exp2f(s[i] * scale_log2 - lse2[r]);
      if (need_mask) {
        const int key = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        const int row = row_a + 8 * r;
        x = key < Sk && (!causal || key <= row || key < prefix_len) ? x
                                                                    : 0.f;
      }
      p[i] = x;
    }
    wg_wait<0>();
    keep(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)  // dS
      dp[i] = p[i] * (dp[i] - dl[(i / 2) & 1]);
    to_a(da, dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < C::kNB; ++nb)  // dQ += dS K
        mma_rs(acc[nb], da[kk], desc_mn<D>(kt, kk, c0 + nb * C::kN),
               t > 0 || kk > 0);
    wg_commit();
    if constexpr (!C::kPipe) {
      wg_wait<0>();
      keep(acc);
      keep(da);
      mbar_arrive(empty + st);
    }
  }
  wg_wait<0>();
  keep(acc);
  keep(da);

  store_rows<C::kNB, C::kN>(dq + (static_cast<size_t>(b) * Sq * H + h) * D,
                            H * D, q0, Sq, c0, acc, scale);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no
// -lcuda at link time)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, S, heads, D) bf16 tensor as 4-d TMA boxes of kBoxCols columns x
// 64 rows of one head, swizzled for wgmma; rows past S read as zeros
template <int D>
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* base,
                int B, int S, int heads) {
  using C = wg::Cfg<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads,
                                 2ull * D * heads * S};
  const cuuint32_t box[4] = {C::kBoxCols, 1, wg::kRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, float* part,
           int splits, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
           int H, int KH, int causal, int prefix_len, float scale,
           cudaStream_t stream) {
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T>
      <<<(rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32),
         kDeltaThreads, 0, stream>>>(static_cast<const T*>(o),
                                     static_cast<const T*>(dout), delta,
                                     rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    using C = wg::Cfg<D>;
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    CUtensorMap tm_q, tm_k, tm_v, tm_do;
    if (!tensor_map<D>(&tm_q, encode, q, B, Sq, H) ||
        !tensor_map<D>(&tm_k, encode, k, B, Sk, KH) ||
        !tensor_map<D>(&tm_v, encode, v, B, Sk, KH) ||
        !tensor_map<D>(&tm_do, encode, dout, B, Sq, H))
      return static_cast<int>(cudaErrorInvalidValue);
    err = kern::allow_smem<wg::flash_bwd_dkdv_wgmma_kernel<D>>(
        C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = kern::allow_smem<wg::flash_bwd_dq_wgmma_kernel<D>>(
        C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (splits < 1 || (H / KH) % splits)
      return static_cast<int>(cudaErrorInvalidValue);
    __nv_bfloat16* tdk = static_cast<__nv_bfloat16*>(dk);
    __nv_bfloat16* tdv = static_cast<__nv_bfloat16*>(dv);
    wg::flash_bwd_dkdv_wgmma_kernel<D>
        <<<dim3(B * KH * splits, (Sk + wg::kRows - 1) / wg::kRows),
           C::kThreads, C::kSmemBytes, stream>>>(
            tm_q, tm_k, tm_v, tm_do, lse, delta, tdk, tdv, part, splits, Sq,
            Sk, H, KH, causal, prefix_len, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (splits > 1) {
      const size_t n = static_cast<size_t>(B) * Sk * KH * D;
      wg::flash_bwd_sum_kernel<<<(n / 4 + 255) / 256, 256, 0, stream>>>(
          part, splits, n, tdk, tdv);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    wg::flash_bwd_dq_wgmma_kernel<D>
        <<<dim3(B * H, (Sq + wg::kRows - 1) / wg::kRows), C::kThreads,
           C::kSmemBytes, stream>>>(tm_q, tm_k, tm_v, tm_do, lse, delta,
                                    static_cast<__nv_bfloat16*>(dq), Sq, Sk,
                                    H, KH, causal, prefix_len, scale);
    return static_cast<int>(cudaGetLastError());
  } else {
    constexpr int BR = simt::kTileRows<D>;
    constexpr int dkdv_smem = sizeof(float) * simt::dkdv_smem_floats<D>();
    constexpr int dq_smem = sizeof(float) * simt::dq_smem_floats<D>();
    const float* tq = static_cast<const float*>(q);
    const float* tk = static_cast<const float*>(k);
    const float* tv = static_cast<const float*>(v);
    const float* tdo = static_cast<const float*>(dout);
    err = kern::allow_smem<simt::flash_bwd_dkdv_kernel<D>>(dkdv_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = kern::allow_smem<simt::flash_bwd_dq_kernel<D>>(dq_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    simt::flash_bwd_dkdv_kernel<D>
        <<<dim3(B * KH, (Sk + BR - 1) / BR), simt::kThreads, dkdv_smem,
           stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
                     static_cast<float*>(dv), Sq, Sk, H, KH, causal,
                     prefix_len, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    simt::flash_bwd_dq_kernel<D><<<dim3(B * H, (Sq + BR - 1) / BR),
                                   simt::kThreads, dq_smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), Sq, Sk, H, KH,
        causal, prefix_len, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* delta,
           float* part, int splits, void* dq, void* dk, void* dv, int B,
           int Sq, int Sk, int H, int KH, int causal, int prefix_len,
           float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, dout, lse, delta, part, splits, dq,
                            dk, dv, B, Sq, Sk, H, KH, causal, prefix_len,
                            scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, part,
                                    splits, dq, dk, dv, B, Sq, Sk, H, KH,
                                    causal, prefix_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o/dout/dq: (B, Sq, H, D);
// k/v/dk/dv: (B, Sk, KH, D); lse (from flash_attention_launch) and the
// scratch delta: (B, H, Sq) float32.  All contiguous and 16-byte aligned;
// causal requires Sq == Sk (checked by the wrapper).  D: 32, 64, 128 or
// 256.  splits (bf16 only; 1 for float32) divides H / KH: the dK/dV pass
// runs that many blocks per (b, KV head, key tile), each over its part of
// the group, and with splits > 1 `part` is float32 scratch of
// 2 * splits * B * Sk * KH * D.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* part, int splits,
    void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
    int D, int causal, int prefix_len, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  if (dtype == 0 && splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return launch<32>(dtype, q, k, v, o, dout, l, dl, pt, splits, dq, dk,
                        dv, B, Sq, Sk, H, KH, causal, prefix_len, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, dout, l, dl, pt, splits, dq, dk,
                        dv, B, Sq, Sk, H, KH, causal, prefix_len, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, dout, l, dl, pt, splits, dq, dk,
                         dv, B, Sq, Sk, H, KH, causal, prefix_len, scale, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, dout, l, dl, pt, splits, dq, dk,
                         dv, B, Sq, Sk, H, KH, causal, prefix_len, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Keys of a bf16 dK/dV block: the wrapper sizes `splits` by the grid this
// gives (B * KH * ceil(Sk / rows) blocks before the split).
extern "C" int flash_attention_bwd_rows() { return wg::kRows; }

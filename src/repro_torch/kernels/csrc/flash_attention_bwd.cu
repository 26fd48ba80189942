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
//
// Three launches, in the FlashAttention-2 shape, deterministic (no
// atomics):
//   1. `flash_bwd_delta_kernel`: delta, one warp per (b, i, h) row;
//   2. `flash_bwd_dkdv_kernel`: one block per (b, KV head, 64-key tile).
//      K_j and V_j stay in shared memory while the block walks every query
//      tile that can see the key tile (from the diagonal on under causal,
//      all of them when the tile holds prefix keys or the call is
//      non-causal) and, inside that, the G query heads of the group, so
//      GQA's sum over the group needs no atomics.  dK_j and dV_j stay in
//      registers;
//   3. `flash_bwd_dq_kernel`: one block per (b, head, 64-query tile),
//      walking the key tiles the forward visited; dQ_i stays in registers.
// Both recompute S and P from the saved log-sum-exp, so nothing of size
// Sq x Sk is stored.
//
// What bounds it on the H100: operations (7 products of 2 * D flops per
// visible (query, key) pair against 2 in the forward).  Two versions of
// kernels 2 and 3:
//   * bf16 at head_dim 64 (every model trained at full width here: the
//     paper-7b draft, granite-moe-1b) runs on the tensor cores
//     (`flash_bwd_dkdv_tc_kernel`, `flash_bwd_dq_tc_kernel`: 4 warps of 16
//     rows, mma.sync m16n8k16 bf16 -> fp32 with the forward's fragment
//     layouts).  The dK/dV kernel computes the scores transposed
//     (S^T = K Q^T, keys as rows), so P^T and dS^T leave the accumulators
//     already in the A layout of dV += P^T dO and dK += dS^T Q, packed to
//     bf16 in registers; Q and dO of the next (query tile, head) arrive by
//     cp.async while the current one computes.  The dQ kernel keeps Q and
//     dO as A fragments and rings K and V as the forward does.  At D = 128
//     its accumulators would pass 255 registers a thread;
//   * everything else (fp32, and bf16 at D = 128) runs on the CUDA cores:
//     inputs converted to fp32 in shared memory (tiles padded to an odd
//     row stride, so a column read across rows is free of bank conflicts),
//     256 threads holding a 4 x 4 register tile of each 64 x 64 score
//     block, as the forward's fp32 kernel does.  fp32 is exact to rounding
//     with TF32 off.
// Launches on the given stream, does not synchronise and allocates nothing
// (delta's scratch comes from the caller); returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kB = 64;          // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 16 x 16 thread layout
constexpr int kPS = kB + 1;     // row stride of the P and dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the forward's mask: rows past Sq and keys past Sk see nothing
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int prefix_len) {
  if (qpos >= Sq || kpos >= Sk) return false;
  return !causal || kpos <= qpos || kpos < prefix_len;
}

// rows [row0, row0 + 64) of one head of a (B, S, heads, D) tensor into a
// fp32 tile of row stride D + 1; rows at or past n_rows are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const T* __restrict__ head,
                                          int row_stride, int row0,
                                          int n_rows) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] =
        row < n_rows ? to_f(head[static_cast<size_t>(row) * row_stride + d])
                     : 0.f;
  }
}

// lse and delta of rows [row0, row0 + 64) of one (b, h); 0 past Sq
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ dl,
                                               int row0, int Sq) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const int row = row0 + r;
    lse_s[r] = row < Sq ? lse[row] : 0.f;
    delta_s[r] = row < Sq ? dl[row] : 0.f;
  }
}

// The thread's 4 x 4 (query, key) pairs of a 64 x 64 tile (queries
// ty + 16 a, keys tx + 16 b): P = exp(S * scale - lse) and
// dS = P * (dP - delta), with S = Q K^T and dP = dO V^T, written into the
// shared P (if given) and dS tiles, rows by query.
template <int D>
__device__ __forceinline__ void probs_and_grads(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, float* ps, float* dss, int q0,
    int k0, int Sq, int Sk, int causal, int prefix_len, float scale) {
  constexpr int S = D + 1;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = qs[(ty + 16 * a) * S + d];
      dov[a] = dos[(ty + 16 * a) * S + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = ks[(tx + 16 * c) * S + d];
      vv[c] = vs[(tx + 16 * c) * S + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] += qv[a] * kv[c];
        dp[a][c] += dov[a] * vv[c];
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const float l = lse_s[r];
    const float dl = delta_s[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const float p = visible(q0 + r, k0 + j, Sq, Sk, causal, prefix_len)
                          ? expf(s[a][c] * scale - l)
                          : 0.f;
      if (ps != nullptr) ps[r * kPS + j] = p;
      dss[r * kPS + j] = p * (dp[a][c] - dl);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H,
                       int D) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;  // warp's row
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
// 2. dK, dV: one block per (b, KV head, key tile)
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkdv_smem_floats() {
  return 4 * kB * (D + 1) + 2 * kB * kPS + 2 * kB;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int KH,
                      int causal, int prefix_len, float scale) {
  constexpr int S = D + 1;
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* ks = smem;            // [kB][S]
  float* vs = ks + kB * S;     // [kB][S]
  float* qs = vs + kB * S;     // [kB][S]
  float* dos = qs + kB * S;    // [kB][S]
  float* ps = dos + kB * S;    // [kB][kPS], rows by query
  float* dss = ps + kB * kPS;  // [kB][kPS], rows by query
  float* lse_s = dss + kB * kPS;
  float* delta_s = lse_s + kB;

  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  const int G = H / KH;
  const int k0 = blockIdx.y * kB;  // tile 0, the most work, goes first
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_rows<T, D>(ks, k + (static_cast<size_t>(b) * Sk * KH + kh) * D,
                  KH * D, k0, Sk);
  load_rows<T, D>(vs, v + (static_cast<size_t>(b) * Sk * KH + kh) * D,
                  KH * D, k0, Sk);

  float dk_acc[4][DC], dv_acc[4][DC];  // keys ty + 16 a, columns tx + 16 c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  // query tiles that see a key of this tile: under causal, those from the
  // diagonal on (Sq == Sk, equal tiles), or all when it holds prefix keys
  const int qt0 = causal && k0 >= prefix_len ? blockIdx.y : 0;
  const int n_qt = (Sq + kB - 1) / kB;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kB;
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      __syncthreads();  // every thread is done with the previous tiles
      load_rows<T, D>(qs, q + (static_cast<size_t>(b) * Sq * H + h) * D,
                      H * D, q0, Sq);
      load_rows<T, D>(dos,
                      dout + (static_cast<size_t>(b) * Sq * H + h) * D,
                      H * D, q0, Sq);
      const size_t stats = (static_cast<size_t>(b) * H + h) * Sq;
      load_row_stats(lse_s, delta_s, lse + stats, delta + stats, q0, Sq);
      __syncthreads();
      probs_and_grads<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0,
                         Sq, Sk, causal, prefix_len, scale);
      __syncthreads();
      // dV_j += P^T dO_i, dK_j += dS^T Q_i (scaled at the end)
#pragma unroll 4
      for (int i = 0; i < kB; ++i) {
        float pv[4], dsv[4], dov[DC], qv[DC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = ps[i * kPS + ty + 16 * a];
          dsv[a] = dss[i * kPS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dov[c] = dos[i * S + tx + 16 * c];
          qv[c] = qs[i * S + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[a][c] += pv[a] * dov[c];
            dk_acc[a][c] += dsv[a] * qv[c];
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= Sk) continue;
    const size_t off = ((static_cast<size_t>(b) * Sk + key) * KH + kh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(dk_acc[a][c] * scale);
      dv[off + tx + 16 * c] = from_f<T>(dv_acc[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (b, head, query tile)
// ---------------------------------------------------------------------------

template <int D>
constexpr int dq_smem_floats() {
  return 4 * kB * (D + 1) + kB * kPS + 2 * kB;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int KH, int causal,
                    int prefix_len, float scale) {
  constexpr int S = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;            // [kB][S]
  float* dos = qs + kB * S;    // [kB][S]
  float* ks = dos + kB * S;    // [kB][S]
  float* vs = ks + kB * S;     // [kB][S]
  float* dss = vs + kB * S;    // [kB][kPS], rows by query
  float* lse_s = dss + kB * kPS;
  float* delta_s = lse_s + kB;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;  // longest tiles first
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_rows<T, D>(qs, q + (static_cast<size_t>(b) * Sq * H + h) * D, H * D,
                  q0, Sq);
  load_rows<T, D>(dos, dout + (static_cast<size_t>(b) * Sq * H + h) * D,
                  H * D, q0, Sq);
  const size_t stats = (static_cast<size_t>(b) * H + h) * Sq;
  load_row_stats(lse_s, delta_s, lse + stats, delta + stats, q0, Sq);

  float acc[4][DC];  // queries ty + 16 a, columns tx + 16 c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  // the key tiles the forward visited: up to the tile's last row, or the
  // whole prefix
  const int n_keys = causal ? min(Sk, max(q0 + kB, prefix_len)) : Sk;
  const int n_kt = (n_keys + kB - 1) / kB;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // every thread is done with the previous key tile
    load_rows<T, D>(ks, k + (static_cast<size_t>(b) * Sk * KH + kh) * D,
                    KH * D, k0, Sk);
    load_rows<T, D>(vs, v + (static_cast<size_t>(b) * Sk * KH + kh) * D,
                    KH * D, k0, Sk);
    __syncthreads();
    probs_and_grads<D>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0,
                       k0, Sq, Sk, causal, prefix_len, scale);
    __syncthreads();
    // dQ_i += dS K_j (scaled at the end)
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = dss[(ty + 16 * a) * kPS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[j * S + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] += dsv[a] * kv[c];
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
    T* out = dq + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      out[tx + 16 * c] = from_f<T>(acc[a][c] * scale);
  }
}


// ---------------------------------------------------------------------------
// bf16 at head_dim 64: the same two kernels on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;  // 16 rows of the tile per warp
constexpr int D = 64;
constexpr int S = D + 8;                 // padded row stride (elements)
constexpr int kTile = kB * S;            // one 64-row tile
constexpr int KSTEPS = D / 16;           // k-steps over the head dim
constexpr int NT = kB / 8;               // 8-column n-tiles of a score tile
constexpr int DT = D / 8;                // 8-column n-tiles of an output
constexpr float kLog2e = 1.4426950408889634f;
// two resident tiles + a two-stage ring of two tiles, then 2 x 2 x 64
// fp32 row statistics
constexpr int kSmemBytes = 6 * kTile * 2 + 4 * kB * 4;

using kern::cp_async16;
using kern::cp_async_commit;
using kern::cp_async_wait;
using kern::ldmatrix_x4;
using kern::ldmatrix_x4_trans;
using kern::mma_bf16;
using kern::pack_bf16;

// rows [row0, row0 + 64) of one head of a (B, S, heads, D) tensor into a
// padded tile by 16-byte cp.async; rows at or past n_rows are zero-filled
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* head,
                                          int row_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < kB * kChunks / kTcThreads; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + r * S + c * 8,
               head + static_cast<size_t>(ok ? row : 0) * row_stride + c * 8,
               ok);
  }
}

// A fragments (16 rows x D) of the warp's rows of a padded tile
__device__ __forceinline__ void load_a(uint32_t (&f)[KSTEPS][4],
                                       const __nv_bfloat16* tile, int warp,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(f[kk], tile + (warp * 16 + lane % 16) * S + kk * 16 +
                           (lane / 16) * 8);
}

// acc (16 x 64) = A (16 x D, fragments) * tile^T: the tile's 64 rows are
// the n axis (B is the tile as stored, col-major)
__device__ __forceinline__ void product_nt(float (&acc)[NT][4],
                                           const uint32_t (&a)[KSTEPS][4],
                                           const __nv_bfloat16* tile,
                                           int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];  // b0, b1 of n-tiles 2 np and 2 np + 1
      ldmatrix_x4(b, tile + (np * 16 + lane % 8 + 8 * (lane / 16)) * S +
                         kk * 16 + 8 * ((lane / 8) % 2));
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// out (16 x D) += P (16 x 64, fp32 accumulators, packed to bf16 here) *
// tile (64 x D): the tile's rows are the reduction axis (B through
// ldmatrix.trans)
__device__ __forceinline__ void product_nn(float (&out)[DT][4],
                                           const float (&p)[NT][4],
                                           const __nv_bfloat16* tile,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t b[4];  // b0, b1 of column tiles 2 dp and 2 dp + 1
      ldmatrix_x4_trans(b, tile + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2))
                                      * S + dp * 16 + 8 * (lane / 16));
      mma_bf16(out[2 * dp], pa, b[0], b[1]);
      mma_bf16(out[2 * dp + 1], pa, b[2], b[3]);
    }
  }
}

// the warp's 16 x D accumulator rows (rows g and g + 8 of the m16n8 layout)
// into a (B, S, heads, D) tensor as bf16 pairs, times `mult`
__device__ __forceinline__ void store_rows(__nv_bfloat16* head,
                                           int row_stride, int row0,
                                           int n_rows,
                                           const float (&acc)[DT][4],
                                           float mult, int lane) {
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* dst = head + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * t4) =
          pack_bf16(acc[n][2 * r] * mult, acc[n][2 * r + 1] * mult);
  }
}

// dK, dV: one block per (b, KV head, 64-key tile); warp w owns keys
// k0 + 16 w ...  The scores are computed transposed (S^T = K Q^T: keys
// are the rows), so P^T and dS^T are already the A operands of
// dV += P^T dO and dK += dS^T Q.  Q, dO and the row statistics of the
// next (query tile, head) load while this one computes.
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                         int H, int KH, int causal, int prefix_len,
                         float scale) {
  extern __shared__ __align__(128) __nv_bfloat16 sm[];
  __nv_bfloat16* ks = sm;              // [64][S]
  __nv_bfloat16* vs = sm + kTile;      // [64][S]
  __nv_bfloat16* qs = sm + 2 * kTile;  // [2][64][S]
  __nv_bfloat16* ds = sm + 4 * kTile;  // [2][64][S], dO
  float* stats = reinterpret_cast<float*>(sm + 6 * kTile);  // [2][2][64]

  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  const int G = H / KH;
  const int k0 = blockIdx.y * kB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const int key_a = k0 + warp * 16 + g;  // keys of rows g, g + 8

  const __nv_bfloat16* k_head =
      k + (static_cast<size_t>(b) * Sk * KH + kh) * D;
  const __nv_bfloat16* v_head =
      v + (static_cast<size_t>(b) * Sk * KH + kh) * D;

  const int qt0 = causal && k0 >= prefix_len ? blockIdx.y : 0;
  const int n_qt = (Sq + kB - 1) / kB;
  const int n_it = (n_qt - qt0) * G;  // (query tile, head) pairs

  // stage `st` of iteration `it`: the Q and dO tiles and the rows'
  // log2-scaled log-sum-exp and delta
  auto prefetch = [&](int it, int st) {
    const int q0 = (qt0 + it / G) * kB;
    const int h = kh * G + it % G;
    const size_t head = (static_cast<size_t>(b) * Sq * H + h) * D;
    load_tile(qs + st * kTile, q + head, H * D, q0, Sq);
    load_tile(ds + st * kTile, dout + head, H * D, q0, Sq);
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq;
    float* st_s = stats + st * 2 * kB;
    for (int r = threadIdx.x; r < kB; r += kTcThreads) {
      const bool ok = q0 + r < Sq;
      st_s[r] = ok ? lse[row + q0 + r] * kLog2e : 0.f;
      st_s[kB + r] = ok ? delta[row + q0 + r] : 0.f;
    }
  };

  load_tile(ks, k_head, KH * D, k0, Sk);
  load_tile(vs, v_head, KH * D, k0, Sk);
  if (n_it > 0) prefetch(0, 0);
  cp_async_commit();

  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage st is in; every warp is done with it - 1
    if (it == 0) {
      load_a(kf, ks, warp, lane);
      load_a(vf, vs, warp, lane);
    }
    if (it + 1 < n_it) prefetch(it + 1, st ^ 1);
    cp_async_commit();
    const __nv_bfloat16* qt = qs + st * kTile;
    const __nv_bfloat16* dot = ds + st * kTile;
    const float* lse_s = stats + st * 2 * kB;
    const float* delta_s = lse_s + kB;
    const int q0 = (qt0 + it / G) * kB;

    float p[NT][4], dp[NT][4];
    product_nt(p, kf, qt, lane);   // S^T = K Q^T
    product_nt(dp, vf, dot, lane);  // dP^T = V dO^T
    const bool need_mask =
        q0 + kB > Sq ||
        (causal && k0 + kB - 1 > q0 && k0 + kB > prefix_len);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t4 + (e & 1);  // query in the tile
        float x = exp2f(p[n][e] * scale_log2 - lse_s[col]);
        if (need_mask) {
          const int qpos = q0 + col;
          const int key = key_a + 8 * (e >> 1);
          const bool ok = qpos < Sq &&
                          (!causal || key <= qpos || key < prefix_len);
          x = ok ? x : 0.f;
        }
        p[n][e] = x;                              // P^T
        dp[n][e] = x * (dp[n][e] - delta_s[col]);  // dS^T
      }
    product_nn(dv_acc, p, dot, lane);  // dV += P^T dO
    product_nn(dk_acc, dp, qt, lane);  // dK += dS^T Q
  }

  const size_t out = (static_cast<size_t>(b) * Sk * KH + kh) * D;
  store_rows(dk + out, KH * D, k0 + warp * 16, Sk, dk_acc, scale, lane);
  store_rows(dv + out, KH * D, k0 + warp * 16, Sk, dv_acc, 1.f, lane);
}

// dQ: one block per (b, head, 64-query tile); warp w owns queries
// q0 + 16 w ...  Q and dO stay in registers as A fragments; K and V come
// through a two-stage ring, as in the forward kernel.
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                       int KH, int causal, int prefix_len, float scale) {
  extern __shared__ __align__(128) __nv_bfloat16 sm[];
  __nv_bfloat16* qs = sm;              // [64][S]
  __nv_bfloat16* ds = sm + kTile;      // [64][S], dO
  __nv_bfloat16* ks = sm + 2 * kTile;  // [2][64][S]
  __nv_bfloat16* vs = sm + 4 * kTile;  // [2][64][S]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;  // longest tiles first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const int row_a = q0 + warp * 16 + g;  // queries of rows g, g + 8

  const size_t head = (static_cast<size_t>(b) * Sq * H + h) * D;
  const __nv_bfloat16* k_head =
      k + (static_cast<size_t>(b) * Sk * KH + kh) * D;
  const __nv_bfloat16* v_head =
      v + (static_cast<size_t>(b) * Sk * KH + kh) * D;
  float lse2[2], dl[2];
  const size_t stats = (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < Sq ? lse[stats + row] * kLog2e : 0.f;
    dl[r] = row < Sq ? delta[stats + row] : 0.f;
  }

  const int n_keys = causal ? min(Sk, max(q0 + kB, prefix_len)) : Sk;
  const int n_kt = (n_keys + kB - 1) / kB;

  load_tile(qs, q + head, H * D, q0, Sq);
  load_tile(ds, dout + head, H * D, q0, Sq);
  load_tile(ks, k_head, KH * D, 0, Sk);
  load_tile(vs, v_head, KH * D, 0, Sk);
  cp_async_commit();

  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t == 0) {
      load_a(qf, qs, warp, lane);
      load_a(dof, ds, warp, lane);
    }
    if (t + 1 < n_kt) {
      const int nxt = (t + 1) & 1;
      load_tile(ks + nxt * kTile, k_head, KH * D, (t + 1) * kB, Sk);
      load_tile(vs + nxt * kTile, v_head, KH * D, (t + 1) * kB, Sk);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = ks + (t & 1) * kTile;
    const __nv_bfloat16* vt = vs + (t & 1) * kTile;
    const int k0 = t * kB;

    float p[NT][4], dp[NT][4];
    product_nt(p, qf, kt, lane);   // S = Q K^T
    product_nt(dp, dof, vt, lane);  // dP = dO V^T
    const bool need_mask =
        k0 + kB > Sk ||
        (causal && k0 + kB - 1 > q0 && k0 + kB > prefix_len);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = exp2f(p[n][e] * scale_log2 - lse2[r]);
        if (need_mask) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          const int row = row_a + 8 * r;
          const bool ok = key < Sk &&
                          (!causal || key <= row || key < prefix_len);
          x = ok ? x : 0.f;
        }
        dp[n][e] = x * (dp[n][e] - dl[r]);  // dS
      }
    product_nn(acc, dp, kt, lane);  // dQ += dS K
  }

  store_rows(dq + head, H * D, q0 + warp * 16, Sq, acc, scale, lane);
}

}  // namespace tc

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
           int causal, int prefix_len, float scale, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);

  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                              kThreads, 0, stream>>>(
      static_cast<const T*>(o), tdo, delta, rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 kv_grid(B * KH, (Sk + kB - 1) / kB);
  const dim3 q_grid(B * H, (Sq + kB - 1) / kB);
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D == tc::D) {
    err = kern::allow_smem<tc::flash_bwd_dkdv_tc_kernel>(tc::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = kern::allow_smem<tc::flash_bwd_dq_tc_kernel>(tc::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::flash_bwd_dkdv_tc_kernel<<<kv_grid, tc::kTcThreads, tc::kSmemBytes,
                                   stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Sk, H, KH, causal, prefix_len, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::flash_bwd_dq_tc_kernel<<<q_grid, tc::kTcThreads, tc::kSmemBytes,
                                 stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KH,
        causal, prefix_len, scale);
    return static_cast<int>(cudaGetLastError());
  } else {
    constexpr int dkdv_smem = sizeof(float) * dkdv_smem_floats<D>();
    constexpr int dq_smem = sizeof(float) * dq_smem_floats<D>();
    err = kern::allow_smem<flash_bwd_dkdv_kernel<T, D>>(dkdv_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = kern::allow_smem<flash_bwd_dq_kernel<T, D>>(dq_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv_kernel<T, D><<<kv_grid, kThreads, dkdv_smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Sk, H, KH, causal, prefix_len, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_kernel<T, D><<<q_grid, kThreads, dq_smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KH,
        causal, prefix_len, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* delta,
           void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
           int KH, int causal, int prefix_len, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                            Sk, H, KH, causal, prefix_len, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, Sq, Sk, H, KH, causal, prefix_len,
                                    scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o/dout/dq: (B, Sq, H, D);
// k/v/dk/dv: (B, Sk, KH, D); lse (from flash_attention_launch) and the
// scratch delta: (B, H, Sq) float32.  All contiguous; causal requires
// Sq == Sk (checked by the wrapper).  D: 64 or 128.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KH, int D, int causal,
    int prefix_len, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 64:
      return launch<64>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                        Sk, H, KH, causal, prefix_len, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                         Sk, H, KH, causal, prefix_len, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

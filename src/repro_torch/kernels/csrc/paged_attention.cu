// Paged multi-query attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention`, body `_paged_attn_kernel`).  One kernel serves every
// attention call of the paged decoder: decode (T=1), speculative verify
// (T=gamma+1) and prefill / chunk appends (T = bucketed prompt or chunk).
//
// What it computes: for sequence b and KV head h, the T*G query rows of that
// head's group (row = t*G + g) attend to the sequence's pages through its
// block table; query t sees page positions <= lengths[b] - T + t.  Scores are
// (q * D^-0.5) . k in fp32, masked by select with the finite -1e30, and an
// online softmax keeps the running max, sum and accumulator in fp32.  The
// output is acc / max(l, 1e-30), cast to q's type.
//
// What bounds it on the H100: bytes.  At decode and verify shapes each
// (b, h) pair reads ceil(len/bs) pages of K and V once and does ~4*T*G*D
// flops per key position, far below the ~295 flop/byte the card needs
// before its tensor cores are the limit.  The design therefore:
//   * walks each block table only up to page ceil(lengths[b]/bs) (the Pallas
//     grid walks all pages_per_seq pages, masked);
//   * stages one page of K and V (bs x D, converted to fp32) in shared
//     memory per step, read once by all query rows of the (b, h) tile;
//   * keeps queries and accumulators in registers, one query row per warp
//     and D/32 elements per lane, so a load of a K or V row is coalesced.
// Grid: (B, KH, ceil(T*G / 16)); the query-tile axis keeps a 256-token
// prefill (T*G = 1792 rows at G = 7) within registers, and rows past T*G on
// the ragged last tile are masked.  No mma/wgmma, TMA or split-KV yet.
//
// Launches on the given stream, does not synchronise and allocates nothing;
// returns cudaGetLastError().  Rows whose query sees no position (lengths[b]
// < T) produce 0; the paged decoder never builds such rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D, int BS>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int n_queries, int H, int KH, int maxb, float scale) {
  constexpr int E = D / 32;  // elements of one D-vector held by each lane
  __shared__ float ks[BS * D];
  __shared__ float vs[BS * D];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / KH;
  const int rows = n_queries * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = lengths[b];

  float qv[kRowsPerWarp][E];
  float acc[kRowsPerWarp][E];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  int limit[kRowsPerWarp];
  bool live[kRowsPerWarp];
  size_t row_off[kRowsPerWarp];

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = blockIdx.z * kRows + r * kWarps + warp;
    live[r] = row < rows;
    const int t = live[r] ? row / G : 0;
    const int g = live[r] ? row % G : 0;
    limit[r] = length - n_queries + t;
    row_off[r] = ((static_cast<size_t>(b) * n_queries + t) * H + h * G + g) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qv[r][e] = live[r] ? to_f32(q[row_off[r] + lane + 32 * e]) * scale : 0.f;
      acc[r][e] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const int n_pages = min((length + BS - 1) / BS, maxb);
  for (int p = 0; p < n_pages; ++p) {
    const size_t blk = static_cast<size_t>(tables[static_cast<size_t>(b) * maxb + p]);
    __syncthreads();  // every warp is done with the previous page
    for (int i = threadIdx.x; i < BS * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i % D;
      const size_t off = ((blk * BS + j) * KH + h) * D + d;
      ks[i] = to_f32(k_pages[off]);
      vs[i] = to_f32(v_pages[off]);
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (!live[r]) continue;  // uniform across the warp
      float s[BS];
      float smax = kNegInf;
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qv[r][e] * ks[j * D + lane + 32 * e];
        const float sj = warp_sum(part);
        s[j] = (p * BS + j <= limit[r]) ? sj : kNegInf;
        smax = fmaxf(smax, s[j]);
      }
      const float m_new = fmaxf(m[r], smax);
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        const float pj = expf(s[j] - m_new);
        psum += pj;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] += pj * vs[j * D + lane + 32 * e];
      }
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!live[r]) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) store(out + row_off[r] + lane + 32 * e, acc[r][e] * inv);
  }
}

template <typename T, int D, int BS>
void launch(const void* q, const void* k, const void* v, const void* tables,
            const void* lengths, void* out, int B, int n_queries, int H,
            int KH, int maxb, float scale, cudaStream_t stream) {
  const int rows = n_queries * (H / KH);
  const dim3 grid(B, KH, (rows + kRows - 1) / kRows);
  paged_attention_kernel<T, D, BS><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), n_queries, H,
      KH, maxb, scale);
}

template <typename T>
bool dispatch(int D, int bs, const void* q, const void* k, const void* v,
              const void* tables, const void* lengths, void* out, int B,
              int n_queries, int H, int KH, int maxb, float scale,
              cudaStream_t s) {
#define PA_CASE(DD, BB)                                                     \
  if (D == DD && bs == BB) {                                                \
    launch<T, DD, BB>(q, k, v, tables, lengths, out, B, n_queries, H, KH,   \
                      maxb, scale, s);                                      \
    return true;                                                            \
  }
  PA_CASE(32, 4) PA_CASE(32, 8) PA_CASE(32, 16)
  PA_CASE(64, 4) PA_CASE(64, 8) PA_CASE(64, 16)
  PA_CASE(128, 4) PA_CASE(128, 8) PA_CASE(128, 16)
#undef PA_CASE
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out: (B, T, H, D); k/v: one layer's
// pages (NB+1, bs, KH, D); tables: (B, maxb) int32; lengths: (B,) int32.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* tables,
                                      const void* lengths, void* out, int B,
                                      int n_queries, int H, int KH, int D,
                                      int bs, int maxb, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch<float>(D, bs, q, k, v, tables, lengths, out, B, n_queries,
                         H, KH, maxb, scale, s);
  else if (dtype == 1)
    ok = dispatch<__nv_bfloat16>(D, bs, q, k, v, tables, lengths, out, B,
                                 n_queries, H, KH, maxb, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

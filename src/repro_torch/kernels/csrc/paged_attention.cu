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
// before its tensor cores are the limit.  So the design is about keeping
// enough loads in flight on enough SMs:
//   * split-KV (flash-decoding): grid (row tiles * splits, KH, B).  Each
//     block takes `split_tiles` 32-position tiles of one sequence; the host
//     picks the number of splits from the table width and the SM count
//     (kernels/paged_attention.py, `split_plan`), never from the lengths,
//     which stay on the device.  With one split the block writes the
//     normalised output: one launch.  With more, each block writes its
//     running max, sum and unnormalised fp32 accumulator into scratch and
//     `paged_combine_kernel` merges them; a block whose positions lie past
//     lengths[b] writes neutral partials (max -1e30, sum 0);
//   * multi-page tiles: a tile of 32 key positions is gathered from 32 / bs
//     pages through the block table by 16-byte `cp.async` into a
//     three-stage shared-memory ring, in the pool's dtype, so the loads of
//     the next two tiles overlap the arithmetic of this one.  Positions
//     past the block's range are zero-filled: nothing past lengths[b] or the
//     table is read.  The queries arrive the same way, with the first tile,
//     and the table entries are read without waiting for lengths[b], so a
//     short call is a few memory round trips deep;
//   * one key per lane: lane j scores position j of the tile against each of
//     its warp's query rows (16 rows per block, interleaved over 8 warps, so
//     the 7 rows of a decode step take 7 warps; queries read from shared
//     memory as broadcasts; 8 independent partial sums per dot product),
//     then one warp max per row and tile; the row sums stay per lane until
//     the end.  The probabilities go through a per-row shared buffer to the
//     P V product, where each lane owns D / 32 output columns.
// Masking is by select: a position the row may not see scores the finite
// -1e30, as in the reference, and positions past the walk contribute
// nothing.  When lengths[b] >= T every row sees position 0, so positions
// past lengths[b] cannot change the result and the walk stops there.  When
// lengths[b] < T, rows t < T - lengths[b] see no position; as in the
// reference, they give the mean of V over the whole table (every position
// at the same -1e30 score), so for that sequence the walk covers the table.
// No tensor cores or TMA yet: verify and chunk appends (T*G >= 16 rows) are
// where they would pay.
//
// head_dim 256 (paligemma's target, gemma-7b): each lane owns 8 output
// columns; the ring takes 111,872 B of shared memory in bf16 (two blocks
// per SM) and 218,368 B in fp32 (one).  With one KV head (MQA, G = 8) a
// decode step fills 8 of the block's 16 rows and verify at gamma = 3 two
// row tiles.
//
// Launches on the given stream, does not synchronise and allocates nothing
// (the wrapper allocates the split scratch); returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // key positions per tile
constexpr int kStages = 3;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N consecutive elements from shared memory as floats, in one vector load
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "vector width");
  if constexpr (N == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "vector width");
  if constexpr (N == 1) {
    x[0] = __bfloat162float(*p);
  } else {
    // N / 2 bf16 pairs: 4, 8 or 16 bytes
    __nv_bfloat162 h[N / 2];
    if constexpr (N == 8)
      *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
    else if constexpr (N == 4)
      *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
    else
      *reinterpret_cast<uint32_t*>(h) = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

using kern::cp_async16;
using kern::cp_async_commit;
using kern::cp_async_wait;

// shared memory: the block's queries, a ring of K and V tiles (rows padded
// by 16 bytes: lane j's 16-byte reads of row j are free of bank conflicts),
// all in the pool's dtype, and the probabilities in fp32
template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);          // elements per chunk
  static constexpr int kChunks = D / kVec;             // chunks per row
  static constexpr int kStride = D + kVec;             // padded row
  static constexpr int kKV = kTile * kStride;          // one K or V tile
  static constexpr int kBytes = sizeof(T) * (kRows * kStride
                                             + 2 * kStages * kKV)
                                + sizeof(float) * kRows * kTile;
};

template <typename T, int D, int BS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int n_queries, int H,
                       int KH, int maxb, int n_splits, int split_tiles,
                       float scale) {
  using L = Layout<T, D>;
  constexpr int E = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);                 // [kRows][stride]
  T* ks = qs + kRows * L::kStride;                        // [kStages][kKV]
  T* vs = ks + kStages * L::kKV;                          // [kStages][kKV]
  float* ps = reinterpret_cast<float*>(vs + kStages * L::kKV);  // [kRows][32]

  const int split = blockIdx.x % n_splits;
  const int row_tile = blockIdx.x / n_splits;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int rows = n_queries * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int table_pos = maxb * BS;
  const int p_begin = split * split_tiles * kTile;
  const int* table = tables + static_cast<size_t>(b) * maxb;

  // the queries of the block's rows (row -> head h * G + row % G of step
  // row / G), zero past the last row; local row warp + kWarps * i is the
  // warp's i-th row
  for (int i = threadIdx.x; i < kRows * L::kChunks; i += kThreads) {
    const int r = i / L::kChunks;
    const int c = i % L::kChunks;
    const int row = row_tile * kRows + r;
    const bool ok = row < rows;
    const int t = ok ? row / G : 0;
    const int g = ok ? row % G : 0;
    cp_async16(qs + r * L::kStride + c * L::kVec,
               q + ((static_cast<size_t>(b) * n_queries + t) * H + h * G + g)
                       * D + c * L::kVec,
               ok);
  }

  // gathers tile `tile` of the split through the block table; positions at
  // or past p_end are zero-filled (nothing read).  The table entries do not
  // wait for lengths[b]: only positions past the table are skipped there.
  const int length = lengths[b];
  const int reach = length < n_queries ? table_pos : min(length, table_pos);
  const int p_end = min(p_begin + split_tiles * kTile, reach);
  const int n_tiles = p_end > p_begin ? (p_end - p_begin + kTile - 1) / kTile
                                      : 0;
  auto fetch = [&](int tile) {
    if (tile < split_tiles) {  // not n_tiles: the lookups need no length
      T* kd = ks + (tile % kStages) * L::kKV;
      T* vd = vs + (tile % kStages) * L::kKV;
#pragma unroll
      for (int it = 0; it < (kTile * L::kChunks + kThreads - 1) / kThreads;
           ++it) {
        const int i = threadIdx.x + it * kThreads;
        if (i < kTile * L::kChunks) {
          const int r = i / L::kChunks;
          const int c = i % L::kChunks;
          const int pos = p_begin + tile * kTile + r;
          const size_t blk =
              pos < table_pos ? static_cast<size_t>(__ldg(table + pos / BS))
                              : 0;
          const bool ok = pos < p_end;
          const size_t off =
              ((blk * BS + pos % BS) * KH + h) * D + c * L::kVec;
          cp_async16(kd + r * L::kStride + c * L::kVec, k_pages + off, ok);
          cp_async16(vd + r * L::kStride + c * L::kVec, v_pages + off, ok);
        }
      }
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);  // the first with Q

  int row[kRowsPerWarp], limit[kRowsPerWarp];
  bool live[kRowsPerWarp];
  float acc[kRowsPerWarp][E];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    row[i] = row_tile * kRows + warp + kWarps * i;
    live[i] = row[i] < rows;
    limit[i] = length - n_queries + row[i] / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile is in; every warp is done with tile - 1
    fetch(tile + kStages - 1);
    const T* kt = ks + (tile % kStages) * L::kKV;
    const T* vt = vs + (tile % kStages) * L::kKV;
    const int pos = p_begin + tile * kTile + lane;

    // scores of position `pos` against the warp's rows, in 8 independent
    // partial sums per row
    float part[kRowsPerWarp][8];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) part[i][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 8; ++c) {
      float kx[8];
      load_vec<8>(kt + lane * L::kStride + 8 * c, kx);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (!live[i]) continue;  // uniform across the warp
        float qx[8];
        load_vec<8>(qs + (warp + kWarps * i) * L::kStride + 8 * c, qx);
#pragma unroll
        for (int e = 0; e < 8; ++e) part[i][e] += qx[e] * kx[e];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (!live[i]) continue;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s += part[i][e];
      s *= scale;
      const bool walked = pos < p_end;
      const float x = walked && pos <= limit[i] ? s : kNegInf;
      const float mx = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - mx);
      const float p = walked ? expf(x - mx) : 0.f;
      m[i] = mx;
      l[i] = l[i] * corr + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
      ps[(warp + kWarps * i) * kTile + lane] = p;
    }
    __syncwarp();

    // acc += P V: lane owns columns lane * E .. lane * E + E - 1
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float vx[4][E];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        load_vec<E>(vt + (j + jj) * L::kStride + lane * E, vx[jj]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (!live[i]) continue;
        float pj[4];
        load_vec<4>(ps + (warp + kWarps * i) * kTile + j, pj);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i][e] += pj[jj] * vx[jj][e];
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) continue;
    const float lsum = warp_sum(l[i]);
    if (n_splits == 1) {
      const int t = row[i] / G;
      const int g = row[i] % G;
      T* o = out + ((static_cast<size_t>(b) * n_queries + t) * H + h * G + g)
                       * D + lane * E;
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
      for (int e = 0; e < E; ++e) store(o + e, acc[i][e] * inv);
    } else {
      const size_t idx =
          ((static_cast<size_t>(b) * KH + h) * rows + row[i]) * n_splits +
          split;
#pragma unroll
      for (int e = 0; e < E; ++e) part_acc[idx * D + lane * E + e] = acc[i][e];
      if (lane == 0) {
        part_ml[2 * idx] = m[i];
        part_ml[2 * idx + 1] = lsum;
      }
    }
  }
}

// one warp per output row (b, t, head): merge the n_splits partials
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     int n_out, int n_queries, int H, int KH, int n_splits) {
  constexpr int E = D / 32;
  const int o = blockIdx.x * kWarps + threadIdx.x / 32;
  if (o >= n_out) return;
  const int lane = threadIdx.x % 32;
  const int head = o % H;
  const int t = (o / H) % n_queries;
  const int b = o / (H * n_queries);
  const int G = H / KH;
  const int h = head / G;
  const size_t idx0 =
      ((static_cast<size_t>(b) * KH + h) * (n_queries * G) + t * G +
       head % G) * n_splits;
  float mx = kNegInf;
  for (int s = lane; s < n_splits; s += 32)
    mx = fmaxf(mx, part_ml[2 * (idx0 + s)]);
  mx = warp_max(mx);
  float acc[E], lsum = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(part_ml[2 * (idx0 + s)] - mx);
    lsum += w * part_ml[2 * (idx0 + s) + 1];
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] += w * part_acc[(idx0 + s) * D + lane * E + e];
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e)
    store(out + static_cast<size_t>(o) * D + lane * E + e, acc[e] * inv);
}

template <typename T, int D, int BS>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* lengths, void* out, void* part_acc, void* part_ml,
           int B, int n_queries, int H, int KH, int maxb, int n_splits,
           int split_tiles, float scale, cudaStream_t stream) {
  constexpr int smem = Layout<T, D>::kBytes;
  cudaError_t err = kern::allow_smem<paged_attention_kernel<T, D, BS>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = n_queries * (H / KH);
  const dim3 grid(((rows + kRows - 1) / kRows) * n_splits, KH, B);
  paged_attention_kernel<T, D, BS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), n_queries,
      H, KH, maxb, n_splits, split_tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const int n_out = B * n_queries * H;
  paged_combine_kernel<T, D><<<(n_out + kWarps - 1) / kWarps, kThreads, 0,
                               stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<T*>(out), n_out, n_queries, H, KH, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, int bs, const void* q, const void* k, const void* v,
             const void* tables, const void* lengths, void* out,
             void* part_acc, void* part_ml, int B, int n_queries, int H,
             int KH, int maxb, int n_splits, int split_tiles, float scale,
             cudaStream_t s) {
#define PA_CASE(DD, BB)                                                      \
  if (D == DD && bs == BB)                                                   \
    return launch<T, DD, BB>(q, k, v, tables, lengths, out, part_acc,        \
                             part_ml, B, n_queries, H, KH, maxb, n_splits,   \
                             split_tiles, scale, s);
  PA_CASE(32, 4) PA_CASE(32, 8) PA_CASE(32, 16)
  PA_CASE(64, 4) PA_CASE(64, 8) PA_CASE(64, 16)
  PA_CASE(128, 4) PA_CASE(128, 8) PA_CASE(128, 16)
  PA_CASE(256, 4) PA_CASE(256, 8) PA_CASE(256, 16)
#undef PA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out: (B, T, H, D); k/v: one layer's
// pages (NB+1, bs, KH, D); tables: (B, maxb) int32; lengths: (B,) int32.
// n_splits > 1 needs fp32 scratch part_acc (B, KH, T*G, n_splits, D) and
// part_ml (B, KH, T*G, n_splits, 2); with one split both may be null.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* tables,
                                      const void* lengths, void* out,
                                      void* part_acc, void* part_ml, int B,
                                      int n_queries, int H, int KH, int D,
                                      int bs, int maxb, int n_splits,
                                      int split_tiles, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_splits < 1 || split_tiles < 1 ||
      static_cast<long long>(n_splits) * split_tiles * kTile <
          static_cast<long long>(maxb) * bs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(D, bs, q, k, v, tables, lengths, out, part_acc,
                           part_ml, B, n_queries, H, KH, maxb, n_splits,
                           split_tiles, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, bs, q, k, v, tables, lengths, out,
                                   part_acc, part_ml, B, n_queries, H, KH,
                                   maxb, n_splits, split_tiles, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

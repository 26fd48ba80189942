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
// ~295 flop/byte ridge.  The design is the simple, correct first step:
//   * grid (B * H, ceil(Sq / 64)): one block of 256 threads per 64-row
//     query tile of one head; the KV loop runs inside the block (the Pallas
//     grid's sequential third axis), 64 keys per tile staged in shared
//     memory as fp32;
//   * register tiles on the CUDA cores: thread (ty, tx) of a 16 x 16 layout
//     computes the scores of rows ty + 16 i and keys tx + 16 j (i, j < 4),
//     so a row's 64 scores live in one half-warp and its max and sum are
//     four shuffles; the same thread owns the output columns tx + 16 k of
//     those rows, so the softmax rescale stays in registers;
//   * causal tiles past the diagonal (and past the prefix) are skipped.
// It uses no tensor cores: an fp32 FMA per multiply-add keeps fp32 inputs
// exact (TF32 would not) and is far below the card's bf16 peak.  wgmma
// tiles, TMA loads and split-Q/K scheduling are for a later version.
//
// Launches on the given stream, does not synchronise and allocates nothing;
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kThreads = 256;   // 16 x 16 thread layout
constexpr int kPStride = kBK + 16;  // half-warps write disjoint banks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int KH, int causal, int prefix_len,
                       float scale) {
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
      x = to_f32(q[((static_cast<size_t>(b) * Sq + row) * H + h) * D + d]) *
          scale;
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
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
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
    T* o = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(o + tx + 16 * c, acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KH, int causal, int prefix_len,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KH, causal,
      prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Sk, int H, int KH, int causal,
             int prefix_len, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KH, causal,
                           prefix_len, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KH, causal,
                           prefix_len, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KH, causal,
                            prefix_len, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out: (B, Sq, H, D); k/v: (B, Sk, KH,
// D); causal requires Sq == Sk (checked by the wrapper).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int H, int KH, int D,
                                      int causal, int prefix_len,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, out, B, Sq, Sk, H, KH, causal,
                           prefix_len, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, KH,
                                   causal, prefix_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

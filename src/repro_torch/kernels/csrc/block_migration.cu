// In-place KV block migration for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_migration.py
// (`_migrate_rows_pallas`, body `_migrate_kernel`; wrapper `migrate_blocks`):
// copy block src[i] -> dst[i] of every layer of a paged pool
// (L, NB+1, bs, KH, hd), in place.  One launch moves a whole copy set over
// several pools that share NB+1 (the target's and the draft's K and V
// pages): the copy-on-write forks before each step's writes and the elastic
// pool's contraction (paper §6.4 step 3).
//
// What bounds it on the H100: bytes, and nothing else — it is a pure copy of
// sum over pools of M * L segments (one block of one layer, bs*KH*hd
// elements: 8 KB for the paper-7b target in bf16, 2 KB for its draft).
// What the design does about that:
//   * one launch per copy set, with the block ids and the pools'
//     descriptors in the kernel's parameters (a __grid_constant__ struct of
//     up to 16.8 KB; CUDA 12.1+ allows 32,764 B), so a small plan needs no
//     id upload and no wait; a plan above the inline instances reads its
//     ids from a device buffer the wrapper uploads;
//   * persistent CTAs, two per SM, walk a flat index of batches: a batch is
//     as many whole segments of one pool as fit a 16 KB shared-memory stage
//     (or one stage-sized piece of a larger segment).  One thread per CTA
//     drives a ring of six stages with 1-D bulk asynchronous copies: the
//     load `cp.async.bulk.shared::cluster.global` completes on the stage's
//     mbarrier with its transaction bytes, the store
//     `cp.async.bulk.global.shared::cta.bulk_group` writes the stage back,
//     and `wait_group.read` frees a stage before it is loaded again.  Up to
//     five stages (80 KB) are in flight per CTA and no register holds data;
//   * a pool whose segment size or base address is not a multiple of 16 B
//     goes through the same launch by a plain word loop of all threads.
//
// An in-place copy is only equal to the reference's gather-then-scatter when
// no destination is also a source and no destination repeats; the Python
// wrapper checks both on the host before it launches, so CTAs need no
// ordering among themselves.
//
// Launches on the given stream, does not synchronise and allocates nothing;
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kStageBytes = 16384;
constexpr int kStages = 6;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kMaxTensors = 8;
constexpr int kCtasPerSm = 2;

// One pool of the copy set, as the kernel walks it.
struct Desc {
  char* base;
  long long layer_stride;  // bytes from one layer to the next
  unsigned seg_bytes;      // one block of one layer
  unsigned L;
  unsigned pieces;     // stage-sized pieces per segment (bulk pools)
  unsigned per_batch;  // items per batch: segments (or pieces) per stage
  unsigned items;      // M * L * pieces
  unsigned first;      // its first batch in the launch's work index
  unsigned word;       // 0: bulk copies; 4 or 2: word size of the plain loop
};

// N > 0: the 2M ids travel in the parameters (src then dst); N == 0: they
// are read from `ids` in device memory.
template <int N>
struct Params {
  Desc t[kMaxTensors];
  const int* ids;
  int n_tensors;
  int M;
  unsigned n_bulk;  // batches [0, n_bulk) take the bulk pipeline
  unsigned n_work;  // batches [n_bulk, n_work) take the word loop
  int inline_ids[N > 0 ? 2 * N : 2];
};

template <int N>
__device__ __forceinline__ long long block_id(const Params<N>& p, int j) {
  if constexpr (N > 0)
    return p.inline_ids[j];
  else
    return __ldg(p.ids + j);
}

// pools are ordered bulk first, each one's batches after the previous one's
template <int N>
__device__ __forceinline__ const Desc& pool_of(const Params<N>& p,
                                               unsigned w) {
  int t = 0;
  while (t + 1 < p.n_tensors && w >= p.t[t + 1].first) ++t;
  return p.t[t];
}

// byte offsets (from the pool's base) of bulk item `it` at its source and
// destination, and its size
template <int N>
__device__ __forceinline__ unsigned item_at(const Params<N>& p,
                                            const Desc& d, unsigned it,
                                            long long* from, long long* to) {
  const unsigned g = it / d.pieces, piece = it - g * d.pieces;
  const unsigned i = g / d.L, l = g - i * d.L;
  const unsigned off = piece * kStageBytes;
  const long long at = static_cast<long long>(l) * d.layer_stride + off;
  *from = at + block_id(p, i) * d.seg_bytes;
  *to = at + block_id(p, p.M + i) * d.seg_bytes;
  return min(d.seg_bytes - off, kStageBytes);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(1u)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// arm the stage's barrier with the batch's bytes, then start its loads
template <int N>
__device__ __forceinline__ void load_batch(const Params<N>& p, unsigned w,
                                           uint32_t stage, uint32_t bar) {
  const Desc& d = pool_of(p, w);
  const unsigned first = (w - d.first) * d.per_batch;
  const unsigned last = min(first + d.per_batch, d.items);
  long long from, to;
  const unsigned bytes0 = item_at(p, d, first, &from, &to);
  mbar_expect_tx(bar, d.pieces == 1 ? (last - first) * d.seg_bytes : bytes0);
  for (unsigned it = first; it < last; ++it) {
    const unsigned bytes = item_at(p, d, it, &from, &to);
    bulk_load(stage, d.base + from, bytes, bar);
    stage += bytes;
  }
}

template <int N>
__device__ __forceinline__ void store_batch(const Params<N>& p, unsigned w,
                                            uint32_t stage) {
  const Desc& d = pool_of(p, w);
  const unsigned first = (w - d.first) * d.per_batch;
  const unsigned last = min(first + d.per_batch, d.items);
  for (unsigned it = first; it < last; ++it) {
    long long from, to;
    const unsigned bytes = item_at(p, d, it, &from, &to);
    bulk_store(d.base + to, stage, bytes);
    stage += bytes;
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// one segment of a pool that the bulk copies cannot take, by all threads
template <int N, typename W>
__device__ __forceinline__ void copy_words(const Params<N>& p, const Desc& d,
                                           unsigned g) {
  const unsigned i = g / d.L, l = g - i * d.L;
  char* layer = d.base + static_cast<long long>(l) * d.layer_stride;
  const W* from = reinterpret_cast<const W*>(layer + block_id(p, i) *
                                                        d.seg_bytes);
  W* to = reinterpret_cast<W*>(layer + block_id(p, p.M + i) * d.seg_bytes);
  for (unsigned x = threadIdx.x; x < d.seg_bytes / sizeof(W); x += kThreads)
    to[x] = from[x];
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    migrate_kernel(const __grid_constant__ Params<N> p) {
  extern __shared__ __align__(128) unsigned char stages[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const unsigned G = gridDim.x;
  if (threadIdx.x == 0 && blockIdx.x < p.n_bulk) {
    const uint32_t s0 = kern::smem_u32(stages), b0 = kern::smem_u32(bars);
    for (int s = 0; s < kStages; ++s) mbar_init(b0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // this CTA's batches are blockIdx.x + j * G; batch j lives in stage
    // j % kStages, and that stage's barrier completes phase j / kStages
    const unsigned mine = (p.n_bulk - blockIdx.x + G - 1) / G;
    unsigned loaded = 0;
    for (; loaded < mine && loaded < kStages; ++loaded)
      load_batch(p, blockIdx.x + loaded * G, s0 + loaded * kStageBytes,
                 b0 + 8 * loaded);
    for (unsigned k = 0; k < mine; ++k) {
      const unsigned s = k % kStages;
      while (!mbar_try_wait(b0 + 8 * s, (k / kStages) & 1)) {
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      store_batch(p, blockIdx.x + k * G, s0 + s * kStageBytes);
      if (k >= 1 && loaded < mine) {
        // the store of batch k - 1 has read its stage: refill it
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        const unsigned s1 = loaded % kStages;
        load_batch(p, blockIdx.x + loaded * G, s0 + s1 * kStageBytes,
                   b0 + 8 * s1);
        ++loaded;
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  for (unsigned w = p.n_bulk + blockIdx.x; w < p.n_work; w += G) {
    const Desc& d = pool_of(p, w);
    if (d.word == 4)
      copy_words<N, uint32_t>(p, d, w - d.first);
    else
      copy_words<N, uint16_t>(p, d, w - d.first);
  }
}

int sm_count(int* n) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev]) {
    *n = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev] = *n;
  return err;
}

template <int N>
int launch(const Desc* descs, int n_tensors, const int* ids_host,
           const int* ids_dev, int M, unsigned n_bulk, unsigned n_work,
           cudaStream_t stream) {
  int sms = 0;
  int err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  Params<N> p;  // only the fields the kernel reads are filled
  memcpy(p.t, descs, n_tensors * sizeof(Desc));
  p.ids = ids_dev;
  p.n_tensors = n_tensors;
  p.M = M;
  p.n_bulk = n_bulk;
  p.n_work = n_work;
  if constexpr (N > 0) memcpy(p.inline_ids, ids_host, 2 * M * sizeof(int));
  const int smem = n_bulk ? kSmemBytes : 0;
  if (smem) {
    err = kern::allow_smem<migrate_kernel<N>>(smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned ctas = static_cast<unsigned>(kCtasPerSm * sms);
  const unsigned grid = n_work < ctas ? n_work : ctas;
  migrate_kernel<N><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pools: n_tensors rows of (base pointer, L, bytes per segment, bytes per
// layer) of contiguous (L, NB+1, ...) tensors; ids: 2M int32 (src then dst)
// on the host, which travel in the launch (M <= 2048), or, when ids_dev is
// not null, the same ids in device memory.
extern "C" int migrate_blocks_launch(const long long* pools, int n_tensors,
                                     const int* ids_host, const void* ids_dev,
                                     int M, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Desc descs[kMaxTensors];
  int n = 0;
  unsigned long long work = 0, n_bulk = 0;
  // bulk pools first, then the ones the word loop takes
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tensors; ++t) {
      const long long* row = pools + 4 * t;
      const uintptr_t base = static_cast<uintptr_t>(row[0]);
      const long long seg = row[2];
      const bool bulk = seg % 16 == 0 && base % 16 == 0 && row[3] % 16 == 0;
      if (bulk != (pass == 0)) continue;
      if (seg <= 0 || seg >= (1LL << 31) || row[1] < 1)
        return static_cast<int>(cudaErrorInvalidValue);
      Desc& d = descs[n++];
      d.base = reinterpret_cast<char*>(base);
      d.L = static_cast<unsigned>(row[1]);
      d.seg_bytes = static_cast<unsigned>(seg);
      d.layer_stride = row[3];
      d.pieces = bulk ? static_cast<unsigned>((seg + kStageBytes - 1) /
                                              kStageBytes)
                      : 1;
      d.per_batch = bulk && d.pieces == 1 ? kStageBytes / d.seg_bytes : 1;
      const unsigned long long items =
          static_cast<unsigned long long>(M) * d.L * d.pieces;
      if (items >= (1ULL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
      d.items = static_cast<unsigned>(items);
      d.first = static_cast<unsigned>(work);
      d.word = bulk ? 0 : (seg % 4 == 0 && base % 4 == 0 ? 4 : 2);
      work += (items + d.per_batch - 1) / d.per_batch;
      if (work >= (1ULL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (pass == 0) n_bulk = work;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* dev = static_cast<const int*>(ids_dev);
  if (dev) return launch<0>(descs, n, nullptr, dev, M, n_bulk, work, s);
  if (M <= 8) return launch<8>(descs, n, ids_host, nullptr, M, n_bulk, work, s);
  if (M <= 64) return launch<64>(descs, n, ids_host, nullptr, M, n_bulk, work, s);
  if (M <= 512) return launch<512>(descs, n, ids_host, nullptr, M, n_bulk, work, s);
  if (M <= 2048) return launch<2048>(descs, n, ids_host, nullptr, M, n_bulk, work, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// In-place KV block migration for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_migration.py
// (`_migrate_rows_pallas`, body `_migrate_kernel`; wrapper `migrate_blocks`):
// copy block src[i] -> dst[i] of every layer of a paged pool
// (L, NB+1, bs, KH, hd), in place.  The same launch serves the copy-on-write
// forks before each step's writes and the elastic pool's contraction moves.
//
// What bounds it on the H100: bytes, and nothing else — it is a pure copy of
// M * L segments of bs*KH*hd elements.  The design works on the pool as it
// lies, without the reshape to (NB, L*row) rows the TPU wrapper makes (in
// PyTorch that reshape would copy the whole pool): block b of layer l is one
// contiguous segment, so the grid is (entry, layer, chunk) and each thread
// moves one 16-byte vector per chunk where the segment and the pool pointer
// allow it, one element otherwise.  Neighbouring threads touch neighbouring
// addresses, so every load and store is coalesced.
//
// An in-place copy is only equal to the reference's gather-then-scatter when
// no destination is also a source and no destination repeats; the Python
// wrapper checks both on the host before it launches.
//
// Launches on the given stream, does not synchronise and allocates nothing;
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
migrate_kernel(W* __restrict__ pool, const int* __restrict__ src,
               const int* __restrict__ dst, long long seg_words,
               long long layer_words) {
  const long long c = static_cast<long long>(blockIdx.z) * kThreads + threadIdx.x;
  if (c >= seg_words) return;
  const long long base = static_cast<long long>(blockIdx.y) * layer_words + c;
  const long long from = base + static_cast<long long>(src[blockIdx.x]) * seg_words;
  const long long to = base + static_cast<long long>(dst[blockIdx.x]) * seg_words;
  pool[to] = pool[from];
}

template <typename W>
void launch(void* pool, const void* src, const void* dst, int M, int L,
            long long nb1, long long seg_bytes, cudaStream_t stream) {
  const long long seg_words = seg_bytes / static_cast<long long>(sizeof(W));
  const dim3 grid(M, L, static_cast<unsigned>((seg_words + kThreads - 1) / kThreads));
  migrate_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<W*>(pool), static_cast<const int*>(src),
      static_cast<const int*>(dst), seg_words, nb1 * seg_words);
}

}  // namespace

// pool: contiguous (L, nb1, seg_elems) of elem_size-byte elements; src/dst:
// (M,) int32 block ids on the device.
extern "C" int migrate_blocks_launch(void* pool, const void* src,
                                     const void* dst, int M, int L,
                                     long long nb1, long long seg_elems,
                                     int elem_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long seg_bytes = seg_elems * elem_size;
  const bool vec = seg_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  if (vec)
    launch<uint4>(pool, src, dst, M, L, nb1, seg_bytes, s);
  else if (elem_size == 4)
    launch<uint32_t>(pool, src, dst, M, L, nb1, seg_bytes, s);
  else if (elem_size == 2)
    launch<uint16_t>(pool, src, dst, M, L, nb1, seg_bytes, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

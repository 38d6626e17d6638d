// Hopper kernels of the embedding lookup: the row gather and the compact
// gather of unique stored rows.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes by torecsys_tpu_torch/ops/kernels/embedding.py, which also
// holds the plain PyTorch versions.  Each entry point launches on the stream
// it is given, allocates nothing (the Python wrapper allocates the output)
// and returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// trs_row_gather replaces torecsys_tpu/ops/pallas/embedding.py
// _gather_kernel / row_gather / _row_gather_impl.
//
//   out[i, :] = src[idx[i], :]          where 0 <= idx[i] < rows,
//   out[i, :] = src[rows + idx[i], :]   where -rows <= idx[i] < 0,
//   out[i, :] = NaN                     otherwise, and nothing is read,
//
// for any contiguous (rows, width) float32 src.  Given the (R, W) stored
// table it is the TPU kernel's contract; given the (Vp*P, E) logical view of
// the packed table it is packed_lookup itself: the stored-row fetch and the
// in-row slot select in one pass.  Ids wrap as the JAX lookup's jnp.take
// does: a negative id counts from the end, once, and an id outside
// [-rows, rows) gives NaN (its fill mode), with no device-to-host check.
//
// Bound on this card: bytes.  Per id it reads the id and width*4 bytes of
// the table and writes width*4 bytes; it does no arithmetic.  The TPU kernel
// moves whole 128-lane stored rows because a DMA there moves whole lane
// tiles; on Hopper the unit of a read is a 32-byte sector, so a 64-byte
// logical row (E = 16) costs two sectors and the kernel reads only the E
// floats of each id, an eighth of the stored row.
//
// Design: one thread per 16-byte vector of the output, so width/4 threads per
// id (4 at E = 16: one warp serves 8 ids; 32 at W = 128).  Neighbouring
// threads hold neighbouring vectors of the output, so the stores coalesce and
// each id's row is read in whole sectors.  The TPU kernel's DMA queue, which
// keeps many row fetches in flight, has its counterpart in the number of
// threads in flight (458,752 at the main path's 114,688 ids), not in a
// software pipeline.  The ids are read as they come, int64 (what the
// embedding module makes) or int32, with no conversion pass.  A width that
// is not a multiple of 4, or a pointer not 16-byte aligned, takes the same
// kernel with 4-byte vectors.
// ---------------------------------------------------------------------------
// trs_unique_stored_gather replaces torecsys_tpu/ops/pallas/embedding.py
// _unique_gather_kernel / unique_stored_gather.
//
//   out[i, :] = table[uids[i] / P, :]   where 0 <= uids[i] < Vp*P,
//
// for ascending unique logical ids uids padded with a sentinel >= Vp*P; the
// row of a sentinel (or of any id outside the table) is not written, as the
// JAX kernel leaves the rows past its valid prefix unspecified.
//
// Bound on this card: bytes.  It reads the valid ids and each distinct
// stored row once and writes one W-wide stored row per valid id; no
// arithmetic.  The TPU kernel bounds a dynamic grid by the valid count and
// keeps many row DMAs in flight with grouped semaphore waits.  The valid
// count lives on the device and is not read back, so here the grid is sized
// for the card, not for M: as many blocks as can be resident at once (the
// occupancy API), fewer for a short stream.  Each warp takes kIdsPerWarp
// consecutive ids at a time, striding over the stream by the whole grid's
// share: it issues the reads of those ids' stored rows (one 16-byte vector
// a lane, one warp per row at W = 128, whole 128-byte lines) before it
// writes any, so several rows are in flight per warp.  Validity is a
// prefix, so a warp that meets a sentinel stops: every later id of its
// stride is a sentinel too, and the tail costs each warp one read of ids.
// Consecutive unique ids share stored rows (23,484 ids in 13,899 rows at the
// bench batch); neighbouring warps of a block read them, and L2 serves the
// repeats.  A width that is not a multiple of 4, or a pointer not 16-byte
// aligned, takes the same kernel with 4-byte vectors.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void set_nan(float& v) { v = __int_as_float(0x7fc00000); }
__device__ __forceinline__ void set_nan(float4& v) {
  float n = __int_as_float(0x7fc00000);
  v = make_float4(n, n, n, n);
}

template <typename Vec, typename Index>
__global__ void row_gather_kernel(const Vec* __restrict__ src,
                                  const Index* __restrict__ idx,
                                  Vec* __restrict__ out, int64_t num,
                                  int64_t rows, int vecs_per_row) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num * vecs_per_row) return;
  int64_t i = t / vecs_per_row;
  int64_t j = t - i * vecs_per_row;
  int64_t r = (int64_t)idx[i];
  if (r < 0) r += rows;
  Vec v;
  if (r >= 0 && r < rows) {
    v = src[r * vecs_per_row + j];
  } else {
    set_nan(v);
  }
  out[t] = v;
}

template <typename Vec, typename Index>
void launch(const float* src, const void* idx, float* out, int64_t num,
            int64_t rows, int vecs_per_row, cudaStream_t st) {
  int64_t total = num * vecs_per_row;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  row_gather_kernel<Vec, Index><<<(unsigned)blocks, kThreads, 0, st>>>(
      reinterpret_cast<const Vec*>(src), static_cast<const Index*>(idx),
      reinterpret_cast<Vec*>(out), num, rows, vecs_per_row);
}

constexpr int kIdsPerWarp = 4;   // ids whose rows a warp reads before it writes them

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
unique_stored_gather_kernel(const Vec* __restrict__ table, const int* __restrict__ uids,
                            Vec* __restrict__ out, int64_t num, int64_t num_logical, int pack,
                            int vecs_per_row) {
  const unsigned kFull = 0xffffffffu;
  constexpr int kWarps = kThreads / 32;
  int lane = threadIdx.x & 31;
  int64_t stride = (int64_t)gridDim.x * kWarps * kIdsPerWarp;
  for (int64_t i0 = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kIdsPerWarp;
       i0 < num; i0 += stride) {
    int my_id = lane < kIdsPerWarp && i0 + lane < num ? uids[i0 + lane] : 0;
    int64_t row[kIdsPerWarp];
    bool ok[kIdsPerWarp];
    bool stop = false;  // the same for the whole warp
#pragma unroll
    for (int q = 0; q < kIdsPerWarp; ++q) {
      int64_t id = __shfl_sync(kFull, my_id, q);
      bool there = i0 + q < num;
      ok[q] = there && id >= 0 && id < num_logical;
      stop = stop || !there || id >= num_logical;
      row[q] = ok[q] ? id / pack : 0;
    }
    for (int j = lane; j < vecs_per_row; j += 32) {
      Vec v[kIdsPerWarp];
#pragma unroll
      for (int q = 0; q < kIdsPerWarp; ++q) {
        if (ok[q]) v[q] = table[row[q] * vecs_per_row + j];
      }
#pragma unroll
      for (int q = 0; q < kIdsPerWarp; ++q) {
        if (ok[q]) out[(i0 + q) * vecs_per_row + j] = v[q];
      }
    }
    if (stop) return;  // validity is a prefix: the rest of the stride is sentinel
  }
}

// Blocks of kThreads threads that the current card holds at once.
template <typename Vec>
int64_t resident_blocks() {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unique_stored_gather_kernel<Vec>,
                                                kThreads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <typename Vec>
void launch_unique(const float* table, const int* uids, float* out,
                   int64_t num, int64_t num_logical, int pack,
                   int vecs_per_row, cudaStream_t st) {
  constexpr int64_t kIdsPerBlock = (kThreads / 32) * kIdsPerWarp;
  int64_t blocks = (num + kIdsPerBlock - 1) / kIdsPerBlock;
  int64_t resident = resident_blocks<Vec>();
  if (blocks > resident) blocks = resident;
  unique_stored_gather_kernel<Vec><<<(unsigned)blocks, kThreads, 0, st>>>(
      reinterpret_cast<const Vec*>(table), uids, reinterpret_cast<Vec*>(out),
      num, num_logical, pack, vecs_per_row);
}

}  // namespace

extern "C" {

// src (rows, width) float32, idx (num,) of idx_bytes = 4 (int32) or 8 (int64),
// out (num, width) float32.
int trs_row_gather(const float* src, const void* idx, int idx_bytes,
                   float* out, int64_t num, int64_t rows, int width,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool vec4 = width % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (idx_bytes == 8) {
    if (vec4) launch<float4, int64_t>(src, idx, out, num, rows, width / 4, st);
    else launch<float, int64_t>(src, idx, out, num, rows, width, st);
  } else if (idx_bytes == 4) {
    if (vec4) launch<float4, int32_t>(src, idx, out, num, rows, width / 4, st);
    else launch<float, int32_t>(src, idx, out, num, rows, width, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// table (Vp, width) float32 with width = P*E, uids (num,) int32 logical ids,
// out (num, width) float32; num_logical = Vp*P.
int trs_unique_stored_gather(const float* table, const int* uids, float* out,
                             int64_t num, int64_t num_logical, int pack,
                             int width, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool vec4 = width % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) launch_unique<float4>(table, uids, out, num, num_logical, pack, width / 4, st);
  else launch_unique<float>(table, uids, out, num, num_logical, pack, width, st);
  return (int)cudaGetLastError();
}

}  // extern "C"

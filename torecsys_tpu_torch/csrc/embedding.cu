// Hopper kernel of the embedding lookup: the row gather.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes by torecsys_tpu_torch/ops/kernels/embedding.py, which also
// holds the plain PyTorch version.  The entry point launches on the stream it
// is given, allocates nothing (the Python wrapper allocates the output) and
// returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// trs_row_gather replaces torecsys_tpu/ops/pallas/embedding.py
// _gather_kernel / row_gather / _row_gather_impl.
//
//   out[i, :] = src[idx[i], :]   where 0 <= idx[i] < rows,
//   out[i, :] = NaN              otherwise, and nothing is read,
//
// for any contiguous (rows, width) float32 src.  Given the (R, W) stored
// table it is the TPU kernel's contract; given the (Vp*P, E) logical view of
// the packed table it is packed_lookup itself: the stored-row fetch and the
// in-row slot select in one pass.  An id outside the table gives NaN, as the
// JAX lookup's jnp.take fill mode does, with no device-to-host check.
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

}  // extern "C"

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
// for any contiguous (rows, width) float32 or bfloat16 src (the kernel is
// templated on the element type, which sets only the NaN's bits and the
// row's bytes: a row moves as raw 16-byte vectors where it can, so a bf16
// row at E = 16 is two vectors where a float32 one is four, as the Pallas
// gather moves the table's own dtype).  Given the (R, W) stored
// table it is the TPU kernel's contract; given the (Vp*P, E) logical view of
// the packed table it is packed_lookup itself: the stored-row fetch and the
// in-row slot select in one pass.  Ids wrap as the JAX lookup's jnp.take
// does: a negative id counts from the end, once, and an id outside
// [-rows, rows) gives NaN (its fill mode), with no device-to-host check.
//
// Bound on this card: bytes.  Per id it reads the id and one row of the
// table and writes one row; it does no arithmetic.  The TPU kernel
// moves whole 128-lane stored rows because a DMA there moves whole lane
// tiles; on Hopper the unit of a read is a 32-byte sector, so a 64-byte
// logical row (E = 16) costs two sectors and the kernel reads only the E
// floats of each id, an eighth of the stored row.
//
// Cold, each id costs two dependent DRAM round trips (its id, then its row),
// so a design with one thread per output vector and a grid sized by M spends
// its time waiting, and its second, partial wave of blocks waits again.
// Design: the grid is as many blocks as the card holds at once (occupancy
// API), fewer for a short stream, so there is one wave.  A warp takes a chunk
// of kChunk = 32 consecutive ids, each loaded by one lane (one coalesced read
// of the chunk's ids, without L1 allocation, no re-reads), and strides on by
// the whole grid's share.  Each lane keeps its id's wrapped row in a register
// and the warp shares them by shuffles.  The chunk's output is one
// contiguous run of 32 * width floats; lane l takes its vectors l, l + 32,
// ..., so the stores coalesce and each id's row is read in whole sectors (4
// lanes per 64-byte row at E = 16, 32 lanes per 512-byte row at W = 128).  A
// lane issues kInFlight = 4 row reads before it stores any, and loads the
// next chunk's ids before those stores, so the id round trip of the next
// chunk hides under the row reads of this one.  Row reads take the read-only
// path through L1, where the Zipf stream's repeated hot rows hit.  The chunk
// and the reads in flight were chosen by a cold sweep on the bench lookup
// (chip_smoke.py: a build with TRS_ROW_GATHER_SWEEP defined adds
// trs_row_gather_sweep, the same kernel at chunks 8-32 and 2-8 reads in
// flight).  The ids are read as they come, int64 (what the embedding module
// makes) or int32, with no conversion pass.  A row whose bytes are not a
// multiple of 16, or a pointer not 16-byte aligned, takes the same kernel
// with 4-byte vectors (2-byte ones for a bf16 row of odd width).
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
// trs_pooled_row_gather replaces no Pallas kernel: the multi-hot lookup's
// bag sums (inputs/embeddings.py MultiHotIndicesEmbedding), on one card and
// on a rank of a row-sharded table.
//
//   out[b, n, :] = sum over slots s in [starts[n], starts[n+1]) of
//                  table[ids[b, s] - base, :]   where lo <= ids[b, s] < hi,
//                  nothing                      otherwise,
//
// for a float32 (rows, E) table (the rank's rows, whose first row is the
// logical row base), (B, S) int32 or int64 ids and the static slot offsets
// starts (N + 1,) of the N bags of an example; out is (B, N, E) float32.
// Each bag is summed in slot order, from +0, so one launch gives the bits of
// any other, and of the plain version's slot-by-slot sum.
//
// Bound on this card: bytes.  It reads each id, each owned row of a bag
// once and writes one E-wide sum a bag: at the bench batch 3.5M ids, a
// quarter of their rows on each of four ranks (E = 128: 512 bytes a row),
// and 426k sums.  No (B*S, E) rows are ever written: the gather and the sum
// are one pass.
//
// Design: a warp owns a bag (a bag is at most a few hundred slots and a
// 512-byte row is one 16-byte vector a lane), and the grid, as many blocks
// as the card holds at once, strides over the B*N bags.  The warp loads up
// to 32 of the bag's ids at a time, one a lane, turns each into its local
// row (or -1 outside [lo, hi)), and shares them by shuffles; a lane issues
// kInFlight row reads before it adds any, so a long bag keeps several rows
// in flight a lane.  Offsets into the table and the output are 64-bit: a
// rank's shard of the bench table is 51M rows of 128 floats, 6.5e9 elements.
// A row whose bytes are not a multiple of 16, or a pointer not 16-byte
// aligned, takes the same kernel with 4-byte vectors.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The bits of a quiet NaN of the element type, repeated over 32 bits: what
// torch's masked_fill(nan) writes (0x7fc00000 for float32, 0x7fc0 for bf16).
template <typename Elem> struct NanWord;
template <> struct NanWord<float> { static constexpr uint32_t value = 0x7fc00000u; };
template <> struct NanWord<__nv_bfloat16> { static constexpr uint32_t value = 0x7fc07fc0u; };

// Raw vectors a row moves in: 16, 4 or 2 bytes.
__device__ __forceinline__ void set_word(uint4& v, uint32_t w) { v = make_uint4(w, w, w, w); }
__device__ __forceinline__ void set_word(uint32_t& v, uint32_t w) { v = w; }
__device__ __forceinline__ void set_word(uint16_t& v, uint32_t w) { v = (uint16_t)w; }
__device__ __forceinline__ uint4 load_row(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ uint32_t load_row(const uint32_t* p) { return __ldg(p); }
__device__ __forceinline__ uint16_t load_row(const uint16_t* p) { return __ldg(p); }

// An id, on the read-only path without L1 allocation (it is read once).
__device__ __forceinline__ int64_t load_id(const int64_t* p) {
  int64_t v;
  asm("ld.global.nc.L1::no_allocate.s64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int64_t load_id(const int32_t* p) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;     // ids a warp takes at a time, one a lane
constexpr int kInFlight = 4;   // row reads a lane issues before it stores any

template <typename Elem, typename Vec, typename Index, int Chunk, int InFlight>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const Vec* __restrict__ src, const Index* __restrict__ idx,
                  Vec* __restrict__ out, int64_t num, int64_t rows, int vecs_per_row,
                  int shift) {
  static_assert(Chunk <= 32, "a chunk's rows are shared by shuffles, one a lane");
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps * Chunk;
  int64_t base = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * Chunk;
  int64_t id = lane < Chunk && base + lane < num ? load_id(idx + base + lane) : 0;
  while (base < num) {
    const int64_t wrapped = id < 0 ? id + rows : id;
    const int64_t row = wrapped >= 0 && wrapped < rows ? wrapped : -1;  // -1: a NaN row
    const int64_t next = base + stride;
    const int64_t n = num - base < Chunk ? num - base : Chunk;
    const unsigned total = (unsigned)(n * vecs_per_row);
    Vec* dst = out + base * vecs_per_row;
    for (unsigned f0 = 0; f0 < total; f0 += 32 * InFlight) {
      Vec v[InFlight];
#pragma unroll
      for (int k = 0; k < InFlight; ++k) {
        unsigned f = f0 + k * 32 + lane;
        unsigned q = shift >= 0 ? f >> shift : f / (unsigned)vecs_per_row;
        int64_t r = __shfl_sync(0xffffffffu, row, q & 31);
        if (f < total) {
          if (r >= 0) {
            v[k] = load_row(src + r * vecs_per_row + (f - q * vecs_per_row));
          } else {
            set_word(v[k], NanWord<Elem>::value);
          }
        }
      }
      if (f0 == 0) id = lane < Chunk && next + lane < num ? load_id(idx + next + lane) : 0;
#pragma unroll
      for (int k = 0; k < InFlight; ++k) {
        unsigned f = f0 + k * 32 + lane;
        if (f < total) dst[f] = v[k];
      }
    }
    base = next;
  }
}

// Blocks of kThreads threads of `kernel` that the current card holds at once.
template <typename Kernel>
int64_t resident_blocks(Kernel kernel) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * per_sm > 0 ? (int64_t)sms * per_sm : 1;
}

template <typename Elem, typename Vec, typename Index, int Chunk = kChunk,
          int InFlight = kInFlight>
void launch_gather(const void* src, const void* idx, void* out, int64_t num,
                   int64_t rows, int vecs_per_row, cudaStream_t st) {
  auto kernel = row_gather_kernel<Elem, Vec, Index, Chunk, InFlight>;
  constexpr int64_t kIdsPerBlock = kWarps * Chunk;
  // The occupancy query costs the host microseconds a call: asked once per
  // card (a race between threads writes the same value).
  constexpr int kMaxCards = 64;
  static int64_t resident[kMaxCards] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int64_t fits = dev < kMaxCards ? resident[dev] : 0;
  if (fits == 0) {
    fits = resident_blocks(kernel);
    if (dev < kMaxCards) resident[dev] = fits;
  }
  int64_t blocks = (num + kIdsPerBlock - 1) / kIdsPerBlock;
  if (blocks > fits) blocks = fits;
  int shift = (vecs_per_row & (vecs_per_row - 1)) == 0 ? __builtin_ctz(vecs_per_row) : -1;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      reinterpret_cast<const Vec*>(src), static_cast<const Index*>(idx),
      reinterpret_cast<Vec*>(out), num, rows, vecs_per_row, shift);
}

constexpr int kIdsPerWarp = 4;   // ids whose rows a warp reads before it writes them

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
unique_stored_gather_kernel(const Vec* __restrict__ table, const int* __restrict__ uids,
                            Vec* __restrict__ out, int64_t num, int64_t num_logical, int pack,
                            int vecs_per_row) {
  const unsigned kFull = 0xffffffffu;
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

template <typename Vec>
void launch_unique(const float* table, const int* uids, float* out,
                   int64_t num, int64_t num_logical, int pack,
                   int vecs_per_row, cudaStream_t st) {
  constexpr int64_t kIdsPerBlock = (kThreads / 32) * kIdsPerWarp;
  int64_t blocks = (num + kIdsPerBlock - 1) / kIdsPerBlock;
  int64_t resident = resident_blocks(unique_stored_gather_kernel<Vec>);
  if (blocks > resident) blocks = resident;
  unique_stored_gather_kernel<Vec><<<(unsigned)blocks, kThreads, 0, st>>>(
      reinterpret_cast<const Vec*>(table), uids, reinterpret_cast<Vec*>(out),
      num, num_logical, pack, vecs_per_row);
}

template <typename Elem>
void launch_gather_elem(const void* src, const void* idx, int idx_bytes, void* out,
                        int64_t num, int64_t rows, int width, cudaStream_t st) {
  const int64_t row_bytes = (int64_t)width * sizeof(Elem);
  auto aligned = [&](int a) {
    return row_bytes % a == 0 && reinterpret_cast<uintptr_t>(src) % a == 0 &&
           reinterpret_cast<uintptr_t>(out) % a == 0;
  };
  bool i64 = idx_bytes == 8;
  if (aligned(16)) {
    (i64 ? launch_gather<Elem, uint4, int64_t> : launch_gather<Elem, uint4, int32_t>)(
        src, idx, out, num, rows, (int)(row_bytes / 16), st);
  } else if (aligned(4)) {
    (i64 ? launch_gather<Elem, uint32_t, int64_t> : launch_gather<Elem, uint32_t, int32_t>)(
        src, idx, out, num, rows, (int)(row_bytes / 4), st);
  } else {
    (i64 ? launch_gather<Elem, uint16_t, int64_t> : launch_gather<Elem, uint16_t, int32_t>)(
        src, idx, out, num, rows, (int)(row_bytes / 2), st);
  }
}

__device__ __forceinline__ void add_to(float4& acc, const float4& x) {
  acc.x = acc.x + x.x;
  acc.y = acc.y + x.y;
  acc.z = acc.z + x.z;
  acc.w = acc.w + x.w;
}
__device__ __forceinline__ void add_to(float& acc, const float& x) { acc = acc + x; }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& v) { v = 0.0f; }

template <typename Vec, typename Index>
__global__ void __launch_bounds__(kThreads)
pooled_row_gather_kernel(const Vec* __restrict__ table, const Index* __restrict__ ids,
                         const int* __restrict__ starts, Vec* __restrict__ out, int64_t bags,
                         int n_bags, int slots, int vecs_per_row, int64_t lo, int64_t hi,
                         int64_t base) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t bag = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); bag < bags;
       bag += stride) {
    const int64_t b = bag / n_bags;
    const int n = (int)(bag - b * n_bags);
    const int s0 = __ldg(starts + n);
    const int s1 = __ldg(starts + n + 1);
    const Index* bag_ids = ids + b * slots;
    Vec* dst = out + bag * vecs_per_row;
    for (int j0 = 0; j0 < vecs_per_row; j0 += 32) {
      const int j = j0 + lane;
      Vec acc;
      zero(acc);
      for (int c0 = s0; c0 < s1; c0 += 32) {
        const int cnt = s1 - c0 < 32 ? s1 - c0 : 32;
        int64_t row = -1;
        if (lane < cnt) {
          const int64_t id = load_id(bag_ids + c0 + lane);
          row = id >= lo && id < hi ? id - base : -1;
        }
        for (int k0 = 0; k0 < cnt; k0 += kInFlight) {
          Vec v[kInFlight];
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            const int64_t r = __shfl_sync(0xffffffffu, row, (k0 + q) & 31);
            zero(v[q]);
            if (k0 + q < cnt && r >= 0 && j < vecs_per_row) {
              v[q] = __ldg(table + r * vecs_per_row + j);
            }
          }
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            if (k0 + q < cnt) add_to(acc, v[q]);
          }
        }
      }
      if (j < vecs_per_row) dst[j] = acc;
    }
  }
}

template <typename Vec, typename Index>
void launch_pooled(const void* table, const void* ids, const int* starts, void* out,
                   int64_t bags, int n_bags, int slots, int vecs_per_row, int64_t lo,
                   int64_t hi, int64_t base, cudaStream_t st) {
  auto kernel = pooled_row_gather_kernel<Vec, Index>;
  constexpr int kMaxCards = 64;
  static int64_t resident[kMaxCards] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int64_t fits = dev < kMaxCards ? resident[dev] : 0;
  if (fits == 0) {
    fits = resident_blocks(kernel);
    if (dev < kMaxCards) resident[dev] = fits;
  }
  int64_t blocks = (bags + kWarps - 1) / kWarps;
  if (blocks > fits) blocks = fits;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      reinterpret_cast<const Vec*>(table), static_cast<const Index*>(ids), starts,
      reinterpret_cast<Vec*>(out), bags, n_bags, slots, vecs_per_row, lo, hi, base);
}

}  // namespace

extern "C" {

// table (rows, E) float32, ids (B, S) of idx_bytes = 4 or 8, starts (N + 1,)
// int32 ascending from 0 to S, out (B, N, E) float32; the rows [lo, hi) of
// the logical table are served, logical row base being table's row 0.
int trs_pooled_row_gather(const float* table, const void* ids, int idx_bytes, const int* starts,
                          float* out, int64_t batch, int n_bags, int slots, int e, int64_t lo,
                          int64_t hi, int64_t base, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((idx_bytes != 8 && idx_bytes != 4) || n_bags < 1 || e < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t bags = batch * n_bags;
  const bool i64 = idx_bytes == 8;
  const bool vec4 = e % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    (i64 ? launch_pooled<float4, int64_t> : launch_pooled<float4, int32_t>)(
        table, ids, starts, out, bags, n_bags, slots, e / 4, lo, hi, base, st);
  } else {
    (i64 ? launch_pooled<float, int64_t> : launch_pooled<float, int32_t>)(
        table, ids, starts, out, bags, n_bags, slots, e, lo, hi, base, st);
  }
  return (int)cudaGetLastError();
}


// src (rows, width) of elem_bytes = 4 (float32) or 2 (bfloat16), idx (num,)
// of idx_bytes = 4 (int32) or 8 (int64), out (num, width) of src's type;
// width < 2^23, so a chunk's output run fits 32-bit offsets.
int trs_row_gather(const void* src, const void* idx, int idx_bytes, void* out, int64_t num,
                   int64_t rows, int width, int elem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((idx_bytes != 8 && idx_bytes != 4) || (elem_bytes != 4 && elem_bytes != 2) ||
      width >= (1 << 23)) {
    return (int)cudaErrorInvalidValue;
  }
  if (elem_bytes == 4) {
    launch_gather_elem<float>(src, idx, idx_bytes, out, num, rows, width, st);
  } else {
    launch_gather_elem<__nv_bfloat16>(src, idx, idx_bytes, out, num, rows, width, st);
  }
  return (int)cudaGetLastError();
}

#ifdef TRS_ROW_GATHER_SWEEP
// The row gather at another chunk (8, 16 or 32 ids a warp) and reads in
// flight (2, 4 or 8 vectors a lane), for chip_smoke.py's sweep; float4 rows
// (width a multiple of 4, 16-byte aligned pointers) and int64 ids only.
int trs_row_gather_sweep(const float* src, const int64_t* idx, float* out, int64_t num,
                         int64_t rows, int width, int chunk, int in_flight, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width % 4 != 0 || reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || width >= (1 << 23)) {
    return (int)cudaErrorInvalidValue;
  }
#define TRS_GATHER_CASE(C, K)                                                   \
  if (chunk == C && in_flight == K) {                                           \
    launch_gather<float, uint4, int64_t, C, K>(src, idx, out, num, rows, width / 4, st); \
    return (int)cudaGetLastError();                                             \
  }
  TRS_GATHER_CASE(8, 2) TRS_GATHER_CASE(8, 4) TRS_GATHER_CASE(8, 8)
  TRS_GATHER_CASE(16, 2) TRS_GATHER_CASE(16, 4) TRS_GATHER_CASE(16, 8)
  TRS_GATHER_CASE(32, 2) TRS_GATHER_CASE(32, 4) TRS_GATHER_CASE(32, 8)
#undef TRS_GATHER_CASE
  return (int)cudaErrorInvalidValue;
}
#endif  // TRS_ROW_GATHER_SWEEP

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

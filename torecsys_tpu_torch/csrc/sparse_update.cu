// Hopper kernels of the sparse embedding update (touched rows only).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes by torecsys_tpu_torch/ops/kernels/sparse_update.py, which also
// holds the plain PyTorch version of each kernel.  Every entry point launches
// on the stream it is given, allocates nothing (the Python wrapper allocates
// outputs and scratch) and returns cudaGetLastError().
//
// The file is compiled with --fmad=false: no multiply-add is contracted, so
// each kernel rounds exactly as the chain of separate PyTorch operations in
// its plain version does.
//
// ---------------------------------------------------------------------------
// trs_widen_segment_sum replaces torecsys_tpu/ops/pallas/sparse_update.py
// _make_widen_segsum_kernel / sorted_widen_segment_sum.
//
//   out[s, lo*E + c] = sum of g[i, c] over positions i with seg[i] == s and
//   lo[i] == lo, for s < n_seg = seg[M-1] + 1; rows s >= n_seg are zero.
//
// Bound on this card: bytes.  The function reads the (M, E) narrow stream
// and two (M,) int streams and writes the (M, P*E) wide output, which is P
// times larger than its input; it does M*E additions, nothing against the
// card's rate.  The TPU kernel's sequential-grid carry and its one-hot matrix
// products exist because TPU grid steps run in order on one core; blocks on
// Hopper run in no order, so the design here needs neither:
//   1. seg_starts: one thread per position writes start[seg[i]] = i where a
//      segment begins, and start[n_seg] = M (a (M+1,) scratch the wrapper
//      allocates).  Segment ids are dense (0..n_seg-1), as the presort makes
//      them, so every start[s] for s <= n_seg is written.
//   2. widen_segsum: one thread per output element (s, c).  Neighbouring
//      threads hold neighbouring lanes of one output row, so the stores
//      coalesce; each thread walks its segment in position order and adds
//      g[i, c % E] where lo[i] == c / E.
// No atomics: each output element is summed by one thread in position order,
// so the result is deterministic and equals the in-order sum of the plain
// version bit for bit.
//
// ---------------------------------------------------------------------------
// trs_segment_sum_wide replaces torecsys_tpu/ops/pallas/sparse_update.py
// _make_segsum_kernel / sorted_segment_sum_wide, the pack == 1 case (E >= 128
// after packing) of the segment-sum.
//
//   out[s, c] = sum of wide[i, c] over positions i with seg[i] == s, for
//   s < n_seg = seg[M-1] + 1; rows s >= n_seg are zero.
//
// Bound on this card: bytes.  The function reads the (M, W) stream and the
// (M,) segment ids and writes the (M, W) output; M*W additions are nothing
// against the card's rate.  The TPU kernel's carry row between grid steps,
// its window DMA at a dynamic segment offset and its one-hot matrix products
// all exist because TPU grid steps run in order on one core; none is needed
// here:
//   1. seg_starts, as above;
//   2. segsum_wide: one warp per output row s.  Each lane owns W/32 columns
//      (one 16-byte vector per lane at W = 128) and sums the segment's rows
//      in position order, so a warp reads each row as whole 512-byte lines
//      and writes its output row once.
// No atomics: deterministic, and equal bit for bit to the in-order sum of the
// plain version.  One warp walks a segment alone, so a Zipf-long segment
// (thousands of positions at the bench batch) holds the kernel's tail, as it
// does for trs_widen_segment_sum.
//
// ---------------------------------------------------------------------------
// trs_fused_rowwise_update replaces torecsys_tpu/ops/pallas/sparse_update.py
// _make_kernel / _fused_update / fused_rowwise_update.
//
// In-place read-modify-write of the unique touched stored rows uids[i],
// i < n_valid, of table (R, W) and its optimizer slot: adam (slot (R, 2, W),
// m then v), adagrad (slot (R, W)) or sgd (no slot).  hyper is the device
// vector lr, b1, b2, eps, wd, 1/(1-b1^t), 1/(1-b2^t).
//
// Bound on this card: bytes.  Per touched row it reads the summed gradient,
// the table row and the slot row(s) and writes the table and slot rows back:
// 7*W floats for adam; about ten operations per element.  Rows are random
// but each is W*4 = 512 contiguous bytes (the packed layout), so one warp per
// row with 16-byte loads reads whole 128-byte lines.  uids are unique, so
// no two warps touch one row and no atomics are needed.  The valid count
// comes one of two ways, and neither is read back from the device:
//   - a host int (the presorted route: the presort's unique count), which
//     sizes the grid, so no thread is spent on the sentinel tail;
//   - a device int (the on-device route: seg[M-1] + 1 of the combine); the
//     grid then covers all n_rows = M uids and a warp at or past *n_valid
//     exits before it reads anything else.
// ---------------------------------------------------------------------------
// trs_fused_sorted_dedup_update replaces
// torecsys_tpu/ops/pallas/sparse_update.py _make_dedup_kernel /
// _fused_sorted_update / fused_sorted_dedup_update.
//
// In one pass over an ascending stream of logical ids (M,) and their narrow
// grads (M, E): group the ids by stored row u = floor(id / P), sum each
// group's grads widened into their in-row slots (id - u*P), and apply the
// row-wise rule to stored row u of the table and its slots, in place.  A
// group whose stored row lies outside [0, R) (a sentinel tail >= R*P, or
// any id outside the table) is skipped.
//
// Bound on this card: bytes.  It reads the ids and narrow grads once and
// reads and writes each touched stored row and its slots once; the float
// work is far below the card's rate.  Three pieces of the TPU kernel exist
// only because TPU grid steps run in order on one core: the carry row of a
// group that crosses a tile, the one-hot matrix-unit combine of a tile, and
// the DMA-semaphore read-modify-write of the finished rows.  None has a place
// here.  Each warp owns 32 consecutive positions; a lane whose position
// starts a group is a head (ballot).  For each head in turn the whole warp
//   1. finds the group's end, 32 ids per step (ballot of the first id whose
//      stored row differs);
//   2. sums the group in position order: each lane holds W/32 columns (one
//      16-byte vector at W = 128) and adds g[p, c % E] where the slot of
//      position p is c / E;
//   3. applies the rule to that stored row and its slots and writes them
//      back once.
// Stored rows are unique per group, so there are no atomics; the walk is in
// position order, so the result is deterministic and equals the in-order
// sum of the plain version bit for bit where the sums are exact.  One warp
// walks a Zipf-long group alone (thousands of positions at the bench batch),
// which holds the kernel's tail, as it does for trs_widen_segment_sum.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

enum Rule { kAdam = 0, kAdagrad = 1, kSgd = 2 };

__global__ void seg_starts_kernel(const int* __restrict__ seg,
                                  int* __restrict__ start, int m) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int s = seg[i];
  if (i == 0 || s != seg[i - 1]) start[s] = i;
  if (i == m - 1) start[s + 1] = m;
}

__global__ void widen_segsum_kernel(const float* __restrict__ g,
                                    const int* __restrict__ lo,
                                    const int* __restrict__ seg,
                                    const int* __restrict__ start,
                                    float* __restrict__ out, int m, int e,
                                    int w) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)m * w) return;
  int s = (int)(t / w);
  int c = (int)(t - (int64_t)s * w);
  float acc = 0.0f;
  if (s < seg[m - 1] + 1) {
    int slot = c / e;
    int col = c - slot * e;
    int end = start[s + 1];
    for (int i = start[s]; i < end; ++i) {
      if (lo[i] == slot) acc += g[(int64_t)i * e + col];
    }
  }
  out[t] = acc;
}

__device__ __forceinline__ void zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void add_to(float& acc, const float& x) { acc = acc + x; }
__device__ __forceinline__ void add_to(float4& acc, const float4& x) {
  acc.x = acc.x + x.x;
  acc.y = acc.y + x.y;
  acc.z = acc.z + x.z;
  acc.w = acc.w + x.w;
}

template <typename Vec>
__global__ void segsum_wide_kernel(const Vec* __restrict__ wide,
                                   const int* __restrict__ seg,
                                   const int* __restrict__ start,
                                   Vec* __restrict__ out, int m,
                                   int vecs_per_row) {
  int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (s >= m) return;
  int begin = 0;
  int end = 0;
  if (s < seg[m - 1] + 1) {
    begin = start[s];
    end = start[s + 1];
  }
  for (int j = lane; j < vecs_per_row; j += 32) {
    Vec acc;
    zero(acc);
    for (int i = begin; i < end; ++i) {
      add_to(acc, wide[(int64_t)i * vecs_per_row + j]);
    }
    out[(int64_t)s * vecs_per_row + j] = acc;
  }
}

struct Hyper {
  float lr, b1, b2, eps, wd, bc1, bc2;
};

template <int RULE>
__device__ __forceinline__ void update_one(float& r, float* m, float* v,
                                           float g, const Hyper& h) {
  if (RULE == kAdam) {
    float m_new = h.b1 * (*m) + (1.0f - h.b1) * g;
    float v_new = h.b2 * (*v) + (1.0f - h.b2) * g * g;
    float upd = h.lr * ((m_new * h.bc1) / (sqrtf(v_new * h.bc2) + h.eps));
    upd = upd + h.lr * h.wd * r;
    *m = m_new;
    *v = v_new;
    r = r - upd;
  } else if (RULE == kAdagrad) {
    float v_new = (*v) + g * g;
    *v = v_new;
    r = r - h.lr * g * rsqrtf(v_new + h.eps);
  } else {
    r = r - h.lr * g;
  }
}

template <int RULE>
__device__ __forceinline__ void update4(float4& r, float4& m, float4& v,
                                        const float4& g, const Hyper& h) {
  update_one<RULE>(r.x, &m.x, &v.x, g.x, h);
  update_one<RULE>(r.y, &m.y, &v.y, g.y, h);
  update_one<RULE>(r.z, &m.z, &v.z, g.z, h);
  update_one<RULE>(r.w, &m.w, &v.w, g.w, h);
}

template <int RULE>
__global__ void rowwise_update_kernel(const int* __restrict__ uids,
                                      const float* __restrict__ gsum,
                                      float* __restrict__ table,
                                      float* __restrict__ slot,
                                      const float* __restrict__ hyper,
                                      int n_rows,
                                      const int* __restrict__ n_valid,
                                      int rows, int w) {
  int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  if (n_valid != nullptr && row >= *n_valid) return;
  int u = uids[row];
  if (u < 0 || u >= rows) return;  // sentinel: never a stored row
  Hyper h{hyper[0], hyper[1], hyper[2], hyper[3],
          hyper[4], hyper[5], hyper[6]};
  int w4 = w >> 2;
  const float4* g4 = reinterpret_cast<const float4*>(gsum + (int64_t)row * w);
  float4* t4 = reinterpret_cast<float4*>(table + (int64_t)u * w);
  float4* m4 = nullptr;
  float4* v4 = nullptr;
  if (RULE == kAdam) {
    m4 = reinterpret_cast<float4*>(slot + (int64_t)u * 2 * w);
    v4 = m4 + w4;
  } else if (RULE == kAdagrad) {
    v4 = reinterpret_cast<float4*>(slot + (int64_t)u * w);
  }
  for (int j = lane; j < w4; j += 32) {
    float4 g = g4[j];
    float4 r = t4[j];
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v = m;
    if (RULE == kAdam) m = m4[j];
    if (RULE != kSgd) v = v4[j];
    update4<RULE>(r, m, v, g, h);
    t4[j] = r;
    if (RULE == kAdam) m4[j] = m;
    if (RULE != kSgd) v4[j] = v;
  }
}

template <int RULE>
__device__ __forceinline__ void update_vec(float& r, float& m, float& v,
                                           const float& g, const Hyper& h) {
  update_one<RULE>(r, &m, &v, g, h);
}

template <int RULE>
__device__ __forceinline__ void update_vec(float4& r, float4& m, float4& v,
                                           const float4& g, const Hyper& h) {
  update4<RULE>(r, m, v, g, h);
}

// floor(a / b) for b > 0 (C++ division truncates toward zero).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// ids (M,) ascending logical ids; g (M, E) as Vec, e_vecs = E / lanes of
// Vec; table (R, W) and slot as Vec, vecs_per_row = W / lanes of Vec.
template <int RULE, typename Vec>
__global__ void sorted_dedup_update_kernel(const int* __restrict__ ids,
                                           const Vec* __restrict__ g,
                                           Vec* __restrict__ table,
                                           Vec* __restrict__ slot,
                                           const float* __restrict__ hyper,
                                           int m, int e_vecs, int pack,
                                           int rows, int vecs_per_row) {
  const unsigned kFull = 0xffffffffu;
  int base = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 32;
  int lane = threadIdx.x & 31;
  if (base >= m) return;  // the whole warp leaves together
  int p = base + lane;
  int hi = 0;
  bool head = false;
  if (p < m) {
    hi = floor_div(ids[p], pack);
    head = p == 0 || floor_div(ids[p - 1], pack) != hi;
  }
  unsigned heads = __ballot_sync(kFull, head);
  if (heads == 0) return;
  Hyper h{hyper[0], hyper[1], hyper[2], hyper[3],
          hyper[4], hyper[5], hyper[6]};
  while (heads != 0) {
    int k = __ffs(heads) - 1;
    heads &= heads - 1;
    int u = __shfl_sync(kFull, hi, k);
    if (u < 0 || u >= rows) continue;  // sentinel or outside the table
    int begin = base + k;
    int end = -1;
    for (int q0 = begin + 1; end < 0; q0 += 32) {
      int q = q0 + lane;
      bool stop = q >= m || floor_div(ids[q], pack) != u;
      unsigned b = __ballot_sync(kFull, stop);
      if (b != 0) end = q0 + __ffs(b) - 1;
    }
    int first_id = u * pack;
    Vec* t = table + (int64_t)u * vecs_per_row;
    Vec* mp = nullptr;
    Vec* vp = nullptr;
    if (RULE == kAdam) {
      mp = slot + (int64_t)u * 2 * vecs_per_row;
      vp = mp + vecs_per_row;
    } else if (RULE == kAdagrad) {
      vp = slot + (int64_t)u * vecs_per_row;
    }
    for (int j = lane; j < vecs_per_row; j += 32) {
      int in_row = j / e_vecs;  // the in-row slot this vector belongs to
      int col = j - in_row * e_vecs;
      Vec acc;
      zero(acc);
      for (int i = begin; i < end; ++i) {
        if (ids[i] - first_id == in_row) add_to(acc, g[(int64_t)i * e_vecs + col]);
      }
      Vec r = t[j];
      Vec mv;
      Vec vv;
      zero(mv);
      zero(vv);
      if (RULE == kAdam) mv = mp[j];
      if (RULE != kSgd) vv = vp[j];
      update_vec<RULE>(r, mv, vv, acc, h);
      t[j] = r;
      if (RULE == kAdam) mp[j] = mv;
      if (RULE != kSgd) vp[j] = vv;
    }
  }
}

template <int RULE, typename Vec>
void launch_dedup(const int* ids, const float* g, float* table, float* slot,
                  const float* hyper, int m, int e, int pack, int rows,
                  cudaStream_t st) {
  constexpr int kLanes = sizeof(Vec) / sizeof(float);
  int warps = (m + 31) / 32;
  int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sorted_dedup_update_kernel<RULE, Vec><<<blocks, kThreads, 0, st>>>(
      ids, reinterpret_cast<const Vec*>(g), reinterpret_cast<Vec*>(table),
      reinterpret_cast<Vec*>(slot), hyper, m, e / kLanes, pack, rows,
      e * pack / kLanes);
}

template <int RULE>
void launch_dedup_rule(const int* ids, const float* g, float* table,
                       float* slot, const float* hyper, int m, int e, int pack,
                       int rows, cudaStream_t st) {
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  bool vec4 = e % 4 == 0 && aligned(g) && aligned(table) &&
              (slot == nullptr || aligned(slot));
  if (vec4) {
    launch_dedup<RULE, float4>(ids, g, table, slot, hyper, m, e, pack, rows, st);
  } else {
    launch_dedup<RULE, float>(ids, g, table, slot, hyper, m, e, pack, rows, st);
  }
}

}  // namespace

extern "C" {

// g (M, E), lo (M,), seg (M,) nondecreasing dense segment ids, start (M+1,)
// scratch, out (M, P*E).
int trs_widen_segment_sum(const float* g, const int* lo, const int* seg,
                          int* start, float* out, int m, int e, int pack,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int w = e * pack;
  seg_starts_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      seg, start, m);
  int64_t total = (int64_t)m * w;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  widen_segsum_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      g, lo, seg, start, out, m, e, w);
  return (int)cudaGetLastError();
}

// wide (M, W), seg (M,) nondecreasing dense segment ids, start (M+1,)
// scratch, out (M, W).
int trs_segment_sum_wide(const float* wide, const int* seg, int* start,
                         float* out, int m, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  seg_starts_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      seg, start, m);
  int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bool vec4 = w % 4 == 0 && reinterpret_cast<uintptr_t>(wide) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    segsum_wide_kernel<float4><<<blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(wide), seg, start,
        reinterpret_cast<float4*>(out), m, w / 4);
  } else {
    segsum_wide_kernel<float><<<blocks, kThreads, 0, st>>>(
        wide, seg, start, out, m, w);
  }
  return (int)cudaGetLastError();
}

// uids (>= n_rows,), gsum (>= n_rows, W), table (R, W), slot per rule (or
// null for sgd), hyper (7,) on the device; W % 4 == 0.  n_rows sizes the
// grid; n_valid, a device int or null, bounds the valid uids further.
int trs_fused_rowwise_update(const int* uids, const float* gsum, float* table,
                             float* slot, const float* hyper, int rule,
                             int n_rows, const int* n_valid, int rows, int w,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (rule == kAdam) {
    rowwise_update_kernel<kAdam><<<blocks, kThreads, 0, st>>>(
        uids, gsum, table, slot, hyper, n_rows, n_valid, rows, w);
  } else if (rule == kAdagrad) {
    rowwise_update_kernel<kAdagrad><<<blocks, kThreads, 0, st>>>(
        uids, gsum, table, slot, hyper, n_rows, n_valid, rows, w);
  } else if (rule == kSgd) {
    rowwise_update_kernel<kSgd><<<blocks, kThreads, 0, st>>>(
        uids, gsum, table, slot, hyper, n_rows, n_valid, rows, w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ids (M,) ascending logical ids, g (M, E), table (R, E*pack), slot per rule
// (or null for sgd), hyper (7,) on the device; R*pack < 2^31.
int trs_fused_sorted_dedup_update(const int* ids, const float* g, float* table,
                                  float* slot, const float* hyper, int rule,
                                  int m, int e, int pack, int rows,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rule == kAdam) {
    launch_dedup_rule<kAdam>(ids, g, table, slot, hyper, m, e, pack, rows, st);
  } else if (rule == kAdagrad) {
    launch_dedup_rule<kAdagrad>(ids, g, table, slot, hyper, m, e, pack, rows, st);
  } else if (rule == kSgd) {
    launch_dedup_rule<kSgd>(ids, g, table, slot, hyper, m, e, pack, rows, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

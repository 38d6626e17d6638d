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
// The two segment sums.
//
// trs_widen_segment_sum replaces torecsys_tpu/ops/pallas/sparse_update.py
// _make_widen_segsum_kernel / sorted_widen_segment_sum:
//
//   out[s, lo*E + c] = sum of g[i, c] over positions i with seg[i] == s and
//   lo[i] == lo, for s < n_seg = seg[M-1] + 1; rows s >= n_seg are zero.
//
// trs_segment_sum_wide replaces _make_segsum_kernel / sorted_segment_sum_wide,
// the pack == 1 case (E >= 128 after packing): the same sum with P = 1,
// E = W and no slot test.
//
// Bound on this card: bytes.  Each reads its (M, E) or (M, W) stream and the
// (M,) int streams once and writes the (M, P*E) output once; rows n_seg..M-1
// of the output are zeros, 77-88% of its bytes at the bench batch, so that
// write is most of the bound.  The additions are nothing against the card's
// rate.
//
// The TPU kernels carry a partial row from one grid step to the next because
// TPU grid steps run in order on one core.  Blocks on Hopper run in no order,
// and the segments are Zipf-skewed (thousands of positions in one stored row
// at the bench batch), so a design that hands a segment to one worker waits
// on the longest segment.  Here the work is cut by position, never by
// segment, in two launches:
//   1. segsum_tile_kernel.  A warp owns kSegTile consecutive positions (a
//      warp tile), a block kSegWarps warp tiles (a block tile).  Lane j holds
//      the output's vectors j, j+32, ... (one 16-byte vector at W = 128).
//      The warp loads kBatch rows ahead, adds them in position order (the
//      widening sum only where lo[i] is the lane's slot: four lanes read one
//      64-byte narrow row at E = 16) and writes a row out where seg changes.
//      A segment cut by a warp-tile edge leaves its partials in shared
//      memory, and the block adds them in tile order: a segment that begins
//      and ends in the block tile goes to out; the partial of the block
//      tile's first segment, where that began in an earlier block tile, to
//      cont[b]; that of its last segment, where that began in this block tile
//      and runs past its end, to head[b].  A segment that neither begins nor
//      ends in block tile b leaves cont[b] only.  The block also writes the
//      zero rows r >= n_seg among its own positions' rows, with coalesced
//      16-byte stores; no segment row lies there, so nothing races.
//   2. segsum_fixup_kernel.  One block per block tile b.  Where b holds a head
//      partial, the block finds the last block tile its segment s reaches
//      (blockDim tile starts a step) and writes out[s] = head[b] + cont[b+1]
//      + ..., each warp summing every kFixWarps-th partial and the sums
//      added in warp order.
// No atomics, no cooperative launch, nothing read back to the host: every
// output row has one writer.  Each element is summed in an order that the
// tiling alone fixes (position order in a warp tile, tile order above), so
// every run gives the same bits, and no worker walks more than one warp tile
// of positions or a 1/kFixWarps share of a segment's partials, so the time no
// longer follows the longest segment.  The rounding differs from an in-order
// sum only where a segment crosses a warp-tile edge; any order keeps a
// segment of L positions within (L - 1) * 2^-24 * sum|g| of the exact sum, and
// where every partial sum is exact (values on a coarse grid) the result is
// the plain version's bit for bit.
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
// which holds the kernel's tail; the segment sums' position tiles and fix-up
// pass (above) are the scheme that removes it.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

enum Rule { kAdam = 0, kAdagrad = 1, kSgd = 2 };

__device__ __forceinline__ void zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void add_to(float& acc, const float& x) { acc = acc + x; }
__device__ __forceinline__ void add_to(float4& acc, const float4& x) {
  acc.x = acc.x + x.x;
  acc.y = acc.y + x.y;
  acc.z = acc.z + x.z;
  acc.w = acc.w + x.w;
}

// The segment sums' tiling (SEGSUM_TILE and SEGSUM_WARPS in the Python
// wrapper, which sizes the scratch from them and checks them on load).
constexpr int kSegTile = 32;   // positions per warp tile: one per lane
constexpr int kSegWarps = 8;   // warp tiles per block tile
constexpr int kSegBlockTile = kSegTile * kSegWarps;
constexpr int kBatch = 8;      // rows a warp loads before it adds them
constexpr int kFixWarps = 16;  // warps of a fix-up block
static_assert(kSegTile == 32, "a lane holds one position's seg and lo");
static_assert(kSegTile % kBatch == 0, "whole batches per warp tile");

// src (M, src_vecs) as Vec; lo (M,) or null when !WIDEN; seg (M,) dense and
// nondecreasing; out (M, vecs_per_row); cont and head (n_block_tiles,
// vecs_per_row).  Where WIDEN, the output vector j is column j % src_vecs of
// in-row slot j / src_vecs.
template <bool WIDEN, typename Vec>
__global__ void __launch_bounds__(kSegWarps * 32)
segsum_tile_kernel(const Vec* __restrict__ src, const int* __restrict__ lo,
                   const int* __restrict__ seg, Vec* __restrict__ out,
                   Vec* __restrict__ cont, Vec* __restrict__ head, int m,
                   int src_vecs, int vecs_per_row) {
  __shared__ Vec cont_w[kSegWarps][32];
  __shared__ Vec head_w[kSegWarps][32];
  __shared__ int last_w[kSegWarps];
  __shared__ bool past_w[kSegWarps];
  const unsigned kFull = 0xffffffffu;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int b = blockIdx.x;
  int p0 = (b * kSegWarps + warp) * kSegTile;
  int n = max(0, min(kSegTile, m - p0));  // this warp tile's positions
  int n_seg = seg[m - 1] + 1;
  int my_seg = lane < n ? seg[p0 + lane] : 0;
  int my_lo = 0;
  if constexpr (WIDEN) my_lo = lane < n ? lo[p0 + lane] : 0;
  int first = __shfl_sync(kFull, my_seg, 0);
  int last = __shfl_sync(kFull, my_seg, max(n, 1) - 1);
  // before: the first segment began in an earlier tile; past: the last one
  // runs past this tile's end.
  bool before = n > 0 && p0 > 0 && seg[p0 - 1] == first;
  bool past = n > 0 && p0 + n < m && seg[p0 + n] == last;
  bool has_head = past && !(before && first == last);
  if (lane == 0) {
    last_w[warp] = last;
    past_w[warp] = past;
  }

  Vec zero_vec;
  zero(zero_vec);
  for (int r = max(p0, n_seg); r < p0 + n; ++r) {
    for (int j = lane; j < vecs_per_row; j += 32) out[(int64_t)r * vecs_per_row + j] = zero_vec;
  }

  for (int j0 = 0; j0 < vecs_per_row; j0 += 32) {
    int j = j0 + lane;
    bool col = j < vecs_per_row;
    int slot = WIDEN ? j / src_vecs : 0;
    int src_j = WIDEN ? j - slot * src_vecs : j;
    auto flush = [&](int s, const Vec& a) {
      if (!col) return;
      if (s == first && before) {
        cont_w[warp][lane] = a;
      } else if (s == last && past) {
        head_w[warp][lane] = a;
      } else {
        out[(int64_t)s * vecs_per_row + j] = a;
      }
    };
    Vec acc;
    zero(acc);
    int cur = first;
    for (int k0 = 0; k0 < n; k0 += kBatch) {
      Vec v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        int k = k0 + q;
        int l = __shfl_sync(kFull, my_lo, k);
        zero(v[q]);
        if (col && k < n && (!WIDEN || l == slot)) {
          v[q] = src[(int64_t)(p0 + k) * src_vecs + src_j];
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        int k = k0 + q;
        int s = __shfl_sync(kFull, my_seg, k);
        if (k < n) {
          if (s != cur) {
            flush(cur, acc);
            zero(acc);
            cur = s;
          }
          add_to(acc, v[q]);
        }
      }
    }
    if (n > 0) flush(cur, acc);
    __syncthreads();

    if (col) {
      if (has_head) {  // a segment that begins in this warp tile and runs on
        Vec a = head_w[warp][lane];
        int t = warp + 1;
        for (; t < kSegWarps; ++t) {
          add_to(a, cont_w[t][lane]);
          if (!(past_w[t] && last_w[t] == last)) break;
        }
        if (t < kSegWarps) {
          out[(int64_t)last * vecs_per_row + j] = a;
        } else {
          head[(int64_t)b * vecs_per_row + j] = a;
        }
      }
      if (warp == 0 && before) {  // the block tile's first segment
        Vec a = cont_w[0][lane];
        for (int t = 0; t + 1 < kSegWarps && past_w[t] && last_w[t] == first;) {
          ++t;
          add_to(a, cont_w[t][lane]);
        }
        cont[(int64_t)b * vecs_per_row + j] = a;
      }
    }
    __syncthreads();
  }
}

// One block per block tile b: finishes the segment whose head partial b
// holds, from the cont partials of the block tiles it reaches.
template <typename Vec>
__global__ void __launch_bounds__(kFixWarps * 32)
segsum_fixup_kernel(const int* __restrict__ seg, const Vec* __restrict__ cont,
                    const Vec* __restrict__ head, Vec* __restrict__ out, int m,
                    int vecs_per_row) {
  __shared__ Vec part[kFixWarps][32];
  int b = blockIdx.x;
  int q0 = b * kSegBlockTile;
  int q1 = min(q0 + kSegBlockTile, m) - 1;
  int s = seg[q1];
  bool pending = q1 + 1 < m && seg[q1 + 1] == s && (q0 == 0 || seg[q0 - 1] != s);
  if (!pending) return;  // the same for the whole block
  // Block tile k holds a partial of s iff its first position is in s; those
  // k are b+1..u, a run, because seg is sorted.
  int n_tiles = (m + kSegBlockTile - 1) / kSegBlockTile;
  int u = b;
  for (int base = b + 1;; base += blockDim.x) {
    int k = base + threadIdx.x;
    int hit = k < n_tiles && seg[(int64_t)k * kSegBlockTile] == s;
    int count = __syncthreads_count(hit);
    u = base + count - 1;
    if (count < (int)blockDim.x) break;
  }
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < vecs_per_row; j0 += 32) {
    int j = j0 + lane;
    bool col = j < vecs_per_row;
    Vec a;
    zero(a);
    if (col) {
#pragma unroll 4
      for (int k = b + 1 + warp; k <= u; k += kFixWarps) {
        add_to(a, cont[(int64_t)k * vecs_per_row + j]);
      }
    }
    part[warp][lane] = a;
    __syncthreads();
    if (warp == 0 && col) {
      Vec r = head[(int64_t)b * vecs_per_row + j];
      for (int t = 0; t < kFixWarps; ++t) add_to(r, part[t][lane]);
      out[(int64_t)s * vecs_per_row + j] = r;
    }
    __syncthreads();
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// src (M, src_width) floats; out (M, w); scratch (2 * n_block_tiles, w):
// cont, then head.  Two launches on st.
template <bool WIDEN, typename Vec>
void launch_segsum(const float* src, const int* lo, const int* seg, float* scratch,
                   float* out, int m, int src_width, int w, cudaStream_t st) {
  constexpr int kLanes = sizeof(Vec) / sizeof(float);
  int blocks = (m + kSegBlockTile - 1) / kSegBlockTile;
  Vec* cont = reinterpret_cast<Vec*>(scratch);
  Vec* head = reinterpret_cast<Vec*>(scratch + (int64_t)blocks * w);
  segsum_tile_kernel<WIDEN, Vec><<<blocks, kSegWarps * 32, 0, st>>>(
      reinterpret_cast<const Vec*>(src), lo, seg, reinterpret_cast<Vec*>(out), cont, head, m,
      src_width / kLanes, w / kLanes);
  segsum_fixup_kernel<Vec><<<blocks, kFixWarps * 32, 0, st>>>(
      seg, cont, head, reinterpret_cast<Vec*>(out), m, w / kLanes);
}

template <bool WIDEN>
void launch_segsum_vec(const float* src, const int* lo, const int* seg, float* scratch,
                       float* out, int m, int src_width, int w, cudaStream_t st) {
  if (src_width % 4 == 0 && w % 4 == 0 && aligned16(src) && aligned16(out) &&
      aligned16(scratch)) {
    launch_segsum<WIDEN, float4>(src, lo, seg, scratch, out, m, src_width, w, st);
  } else {
    launch_segsum<WIDEN, float>(src, lo, seg, scratch, out, m, src_width, w, st);
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
  bool vec4 = e % 4 == 0 && aligned16(g) && aligned16(table) &&
              (slot == nullptr || aligned16(slot));
  if (vec4) {
    launch_dedup<RULE, float4>(ids, g, table, slot, hyper, m, e, pack, rows, st);
  } else {
    launch_dedup<RULE, float>(ids, g, table, slot, hyper, m, e, pack, rows, st);
  }
}

}  // namespace

extern "C" {

// The segment sums' tiling, which the wrapper checks against its own.
int trs_segsum_tile(void) { return kSegTile; }
int trs_segsum_warps(void) { return kSegWarps; }

// g (M, E), lo (M,), seg (M,) nondecreasing dense segment ids, scratch
// (2 * ceil(M / (kSegTile * kSegWarps)), P*E), out (M, P*E); M >= 1.
int trs_widen_segment_sum(const float* g, const int* lo, const int* seg,
                          float* scratch, float* out, int m, int e, int pack,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_segsum_vec<true>(g, lo, seg, scratch, out, m, e, e * pack, st);
  return (int)cudaGetLastError();
}

// wide (M, W), seg (M,) nondecreasing dense segment ids, scratch
// (2 * ceil(M / (kSegTile * kSegWarps)), W), out (M, W); M >= 1.
int trs_segment_sum_wide(const float* wide, const int* seg, float* scratch,
                         float* out, int m, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_segsum_vec<false>(wide, nullptr, seg, scratch, out, m, w, w, st);
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

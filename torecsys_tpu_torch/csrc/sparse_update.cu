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
// The position tiles: one scheme for three kernels.
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
// trs_fused_sorted_dedup_update replaces _make_dedup_kernel /
// _fused_sorted_update / fused_sorted_dedup_update: over an ascending stream
// of logical ids (M,) and their narrow grads (M, E), group the ids by stored
// row u = floor(id / P), sum each group's grads widened into their in-row
// slots (id - u*P), and apply the row-wise rule (adam, adagrad or sgd) to
// stored row u of the table and its slots, in place.  A group whose u lies
// outside [0, R) (a sentinel tail >= R*P, or any id outside the table) is
// summed but never written.
//
// Bound on this card: bytes.  The segment sums read their (M, E) or (M, W)
// stream and the (M,) int streams once and write the (M, P*E) output once;
// rows n_seg..M-1 of the output are zeros, 77-88% of its bytes at the bench
// batch, so that write is most of their bound.  The fused dedup reads the
// ids and narrow grads once and reads and writes each touched stored row and
// its slots once (7*W floats a row for adam); it writes no (M, W) sum.  The
// float work is nothing against the card's rate.
//
// The TPU kernels carry a partial row from one grid step to the next because
// TPU grid steps run in order on one core; the fused one also combines a
// tile's groups with a one-hot product on the matrix unit and updates the
// finished rows through DMA semaphores.  Blocks on Hopper run in no order,
// and the groups are Zipf-skewed (thousands of positions in one stored row
// at the bench batch), so a design that hands a group to one worker waits
// on the longest group.  Here the work is cut by position, never by group,
// in two launches.  Where a position's group key and in-row slot come from
// is a policy (Keys: seg[i] and lo[i], or floor(ids[i] / P) and the
// remainder), and so is what becomes of a finished sum (Sink: write out[s],
// or apply the rule to stored row u):
//   1. tile_kernel.  A warp owns kSegTile consecutive positions (a warp
//      tile), a block kSegWarps warp tiles (a block tile).  Lane j holds the
//      row's vectors j, j+32, ... (one 16-byte vector at W = 128).  The warp
//      loads kBatch rows ahead and adds them in position order (the widening
//      sum only where the slot of position i is the lane's: four lanes read
//      one 64-byte narrow row at E = 16); where the key changes, the group
//      before is finished.  A group cut by a warp-tile edge leaves its
//      partials in shared memory, and the block adds them in tile order: a
//      group that begins and ends in the block tile is finished there; the
//      partial of the block tile's first group, where that began in an
//      earlier block tile, goes to cont[b]; that of its last group, where
//      that began in this block tile and runs past its end, to head[b].  A
//      group that neither begins nor ends in block tile b leaves cont[b]
//      only.  The segment sums' sink also writes the zero rows r >= n_seg
//      among the block's own positions' rows, with coalesced 16-byte stores;
//      no segment row lies there, so nothing races.
//   2. fixup_kernel.  One block per block tile b.  Where b holds a head
//      partial, the block finds the last block tile its group reaches
//      (blockDim tile starts a step), sums head[b] + cont[b+1] + ..., each
//      warp every kFixWarps-th partial and the sums added in warp order, and
//      finishes the group once.
// No atomics, no cooperative launch, nothing read back to the host.  A group
// is finished by exactly one pass: pass 1 where it lies inside a block tile,
// pass 2 where it crosses one, so no row is read by one launch and written by
// the other, and every output or stored row has one writer.  Each element is
// summed in an order that the tiling alone fixes (position order in a warp
// tile, tile order above), so every run gives the same bits, and no worker
// walks more than one warp tile of positions or a 1/kFixWarps share of a
// group's partials, so the time does not follow the longest group.
//
// The three kernels sum every element of a stream in the same order, so the
// fused dedup's sums are those of widen_segment_sum (segment_sum_wide at
// P = 1, where the slot test always passes) on the same stream, and its
// update is fused_rowwise_update's update_one: its table and slots equal
// the default combine's (a segment sum, then fused_rowwise_update) bit for
// bit.  Against an in-order sum the rounding differs only where a group
// crosses a warp-tile edge; any order keeps a group of L positions within
// (L - 1) * 2^-24 * sum|g| of the exact sum, and where every partial sum is
// exact (values on a coarse grid) the result is the plain version's bit for
// bit.
//
// The update sink does not apply the rule where a group finishes: a warp
// tile of short groups (the tail of a Zipf stream, a distinct-rows stream)
// finishes up to 32 groups one after another, and each update is a
// dependent read of the row (1.5 KB at W = 128 for adam) before its write.
// It stages the finished sums of a batch in shared memory and, after the
// batch, issues the reads of kDrain staged rows together before it updates
// and writes them, so a warp tile waits on a few round trips, not 32.
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
__device__ __forceinline__ void update_vec(float& r, float& m, float& v,
                                           const float& g, const Hyper& h) {
  update_one<RULE>(r, &m, &v, g, h);
}

template <int RULE>
__device__ __forceinline__ void update_vec(float4& r, float4& m, float4& v,
                                           const float4& g, const Hyper& h) {
  update4<RULE>(r, m, v, g, h);
}

__device__ __forceinline__ Hyper load_hyper(const float* hyper) {
  return Hyper{__ldg(hyper), __ldg(hyper + 1), __ldg(hyper + 2), __ldg(hyper + 3),
               __ldg(hyper + 4), __ldg(hyper + 5), __ldg(hyper + 6)};
}

// floor(a / b) for b > 0 (C++ division truncates toward zero).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// ---- the position tiles ----------------------------------------------------

// The tiling (SEGSUM_TILE and SEGSUM_WARPS in the Python wrapper, which sizes
// the scratch from them and checks them on load).
constexpr int kSegTile = 32;   // positions per warp tile: one per lane
constexpr int kSegWarps = 8;   // warp tiles per block tile
constexpr int kSegBlockTile = kSegTile * kSegWarps;
constexpr int kBatch = 8;      // rows a warp loads before it adds them
constexpr int kFixWarps = 16;  // warps of a fix-up block
constexpr int kDrain = 4;      // staged rows whose reads the update sink issues together
static_assert(kSegTile == 32, "a lane holds one position's key and slot");
static_assert(kSegTile % kBatch == 0, "whole batches per warp tile");

// Keys of the segment sums: the dense segment id seg[p] and, where WIDEN,
// the in-row slot lo[p].
template <bool WIDEN>
struct SegKeys {
  static constexpr bool kWiden = WIDEN;
  const int* seg;
  const int* lo;
  __device__ __forceinline__ int key(int p) const { return __ldg(seg + p); }
  __device__ __forceinline__ void at(int p, int& k, int& slot) const {
    k = __ldg(seg + p);
    slot = WIDEN ? __ldg(lo + p) : 0;
  }
};

// Keys of the fused dedup: the stored row floor(id / P) of a logical id and
// its in-row slot id - u*P.
struct IdKeys {
  static constexpr bool kWiden = true;
  const int* ids;
  int pack;
  __device__ __forceinline__ int key(int p) const { return floor_div(__ldg(ids + p), pack); }
  __device__ __forceinline__ void at(int p, int& k, int& slot) const {
    int id = __ldg(ids + p);
    k = floor_div(id, pack);
    slot = id - k * pack;
  }
};

// Sink of the segment sums: out[s] is segment s's sum; rows from n_seg =
// seg[M-1] + 1 on are zero.  Nothing is staged.
template <typename Vec>
struct SumSink {
  struct Stage {};
  Vec* out;
  const int* seg;
  int m;
  int vecs_per_row;
  int n_seg;

  __device__ __forceinline__ void init() { n_seg = __ldg(seg + m - 1) + 1; }
  __device__ __forceinline__ void zero_tail(int p0, int n, int lane) const {
    Vec zero_vec;
    zero(zero_vec);
    for (int r = max(p0, n_seg); r < p0 + n; ++r) {
      for (int j = lane; j < vecs_per_row; j += 32) out[(int64_t)r * vecs_per_row + j] = zero_vec;
    }
  }
  __device__ __forceinline__ void write(int s, int j, const Vec& a) const {
    out[(int64_t)s * vecs_per_row + j] = a;
  }
  __device__ __forceinline__ void put(Stage&, int, int, int s, int j, bool col, const Vec& a) {
    if (col) write(s, j, a);
  }
  __device__ __forceinline__ void drain(Stage&, int, int, int, bool) {}
};

// Sink of the fused dedup: applies the rule to stored row u of table (R, W)
// and its slots (adam (R, 2, W), adagrad (R, W), sgd none), in place, and
// skips a row outside [0, R).  The tile pass stages a batch's finished sums
// (put) and updates them together (drain); the fix-up updates its one row
// at once (write).
template <int RULE, typename Vec>
struct UpdateSink {
  struct Stage {
    int u[kSegWarps][kBatch];
    Vec g[kSegWarps][kBatch][32];
  };
  Vec* table;
  Vec* slot;
  const float* hyper;
  int rows;
  int vecs_per_row;
  Hyper h;
  int n_staged;

  __device__ __forceinline__ void init() {
    h = load_hyper(hyper);
    n_staged = 0;
  }
  __device__ __forceinline__ void zero_tail(int, int, int) const {}
  __device__ __forceinline__ bool in_table(int u) const { return u >= 0 && u < rows; }
  __device__ __forceinline__ void load(int u, int j, Vec& r, Vec& m, Vec& v) const {
    int64_t row = (int64_t)u * vecs_per_row;
    r = table[row + j];
    if (RULE == kAdam) {
      m = slot[2 * row + j];
      v = slot[2 * row + vecs_per_row + j];
    } else if (RULE == kAdagrad) {
      v = slot[row + j];
    }
  }
  __device__ __forceinline__ void store(int u, int j, const Vec& r, const Vec& m,
                                        const Vec& v) const {
    int64_t row = (int64_t)u * vecs_per_row;
    table[row + j] = r;
    if (RULE == kAdam) {
      slot[2 * row + j] = m;
      slot[2 * row + vecs_per_row + j] = v;
    } else if (RULE == kAdagrad) {
      slot[row + j] = v;
    }
  }
  __device__ __forceinline__ void write(int u, int j, const Vec& g) const {
    if (!in_table(u)) return;
    Vec r, m, v;
    zero(m);
    zero(v);
    load(u, j, r, m, v);
    update_vec<RULE>(r, m, v, g, h);
    store(u, j, r, m, v);
  }
  // Warp-uniform: every lane calls it for the same group.
  __device__ __forceinline__ void put(Stage& st, int warp, int lane, int u, int, bool,
                                      const Vec& g) {
    if (lane == 0) st.u[warp][n_staged] = u;
    st.g[warp][n_staged][lane] = g;
    ++n_staged;
  }
  __device__ __forceinline__ void drain(Stage& st, int warp, int lane, int j, bool col) {
    if (n_staged == 0) return;  // the same for the whole warp
    __syncwarp();
    for (int i0 = 0; i0 < n_staged; i0 += kDrain) {
      int u[kDrain];
      bool ok[kDrain];
      Vec r[kDrain], m[kDrain], v[kDrain];
#pragma unroll
      for (int q = 0; q < kDrain; ++q) {
        u[q] = i0 + q < n_staged ? st.u[warp][i0 + q] : -1;
        ok[q] = col && in_table(u[q]);
        zero(r[q]);
        zero(m[q]);
        zero(v[q]);
        if (ok[q]) load(u[q], j, r[q], m[q], v[q]);
      }
#pragma unroll
      for (int q = 0; q < kDrain; ++q) {
        if (ok[q]) {
          update_vec<RULE>(r[q], m[q], v[q], st.g[warp][i0 + q][lane], h);
          store(u[q], j, r[q], m[q], v[q]);
        }
      }
    }
    __syncwarp();  // the stage is free again for every lane
    n_staged = 0;
  }
};

// src (M, src_vecs) as Vec; cont and head (n_block_tiles, vecs_per_row).
// Where Keys::kWiden, row vector j is column j % src_vecs of in-row slot
// j / src_vecs.
template <typename Vec, typename Keys, typename Sink>
__global__ void __launch_bounds__(kSegWarps * 32)
tile_kernel(const Vec* __restrict__ src, Keys keys, Sink sink, Vec* __restrict__ cont,
            Vec* __restrict__ head, int m, int src_vecs, int vecs_per_row) {
  constexpr bool WIDEN = Keys::kWiden;
  __shared__ Vec cont_w[kSegWarps][32];
  __shared__ Vec head_w[kSegWarps][32];
  __shared__ int last_w[kSegWarps];
  __shared__ bool past_w[kSegWarps];
  __shared__ typename Sink::Stage stage;
  const unsigned kFull = 0xffffffffu;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int b = blockIdx.x;
  int p0 = (b * kSegWarps + warp) * kSegTile;
  int n = max(0, min(kSegTile, m - p0));  // this warp tile's positions
  sink.init();  // its reads overlap the keys'
  int my_seg = 0;
  int my_lo = 0;
  if (lane < n) keys.at(p0 + lane, my_seg, my_lo);
  int first = __shfl_sync(kFull, my_seg, 0);
  int last = __shfl_sync(kFull, my_seg, max(n, 1) - 1);
  // before: the first group began in an earlier tile; past: the last one
  // runs past this tile's end.
  bool before = n > 0 && p0 > 0 && keys.key(p0 - 1) == first;
  bool past = n > 0 && p0 + n < m && keys.key(p0 + n) == last;
  bool has_head = past && !(before && first == last);
  if (lane == 0) {
    last_w[warp] = last;
    past_w[warp] = past;
  }
  sink.zero_tail(p0, n, lane);

  for (int j0 = 0; j0 < vecs_per_row; j0 += 32) {
    int j = j0 + lane;
    bool col = j < vecs_per_row;
    int slot = WIDEN ? j / src_vecs : 0;
    int src_j = WIDEN ? j - slot * src_vecs : j;
    // Warp-uniform: s and the tile's flags are the same in every lane.
    auto flush = [&](int s, const Vec& a) {
      if (s == first && before) {
        if (col) cont_w[warp][lane] = a;
      } else if (s == last && past) {
        if (col) head_w[warp][lane] = a;
      } else {
        sink.put(stage, warp, lane, s, j, col, a);
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
      sink.drain(stage, warp, lane, j, col);
    }
    if (n > 0) flush(cur, acc);
    sink.drain(stage, warp, lane, j, col);
    __syncthreads();

    if (col) {
      if (has_head) {  // a group that begins in this warp tile and runs on
        Vec a = head_w[warp][lane];
        int t = warp + 1;
        for (; t < kSegWarps; ++t) {
          add_to(a, cont_w[t][lane]);
          if (!(past_w[t] && last_w[t] == last)) break;
        }
        if (t < kSegWarps) {
          sink.write(last, j, a);
        } else {
          head[(int64_t)b * vecs_per_row + j] = a;
        }
      }
      if (warp == 0 && before) {  // the block tile's first group
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

// One block per block tile b: finishes the group whose head partial b holds,
// from the cont partials of the block tiles it reaches.
template <typename Vec, typename Keys, typename Sink>
__global__ void __launch_bounds__(kFixWarps * 32)
fixup_kernel(Keys keys, const Vec* __restrict__ cont, const Vec* __restrict__ head, Sink sink,
             int m, int vecs_per_row) {
  __shared__ Vec part[kFixWarps][32];
  int b = blockIdx.x;
  int q0 = b * kSegBlockTile;
  int q1 = min(q0 + kSegBlockTile, m) - 1;
  int s = keys.key(q1);
  bool pending = q1 + 1 < m && keys.key(q1 + 1) == s && (q0 == 0 || keys.key(q0 - 1) != s);
  if (!pending) return;  // the same for the whole block
  // Block tile k holds a partial of s iff its first position is in s; those
  // k are b+1..u, a run, because the keys are sorted.
  int n_tiles = (m + kSegBlockTile - 1) / kSegBlockTile;
  int u = b;
  for (int base = b + 1;; base += blockDim.x) {
    int k = base + threadIdx.x;
    int hit = k < n_tiles && keys.key(k * kSegBlockTile) == s;
    int count = __syncthreads_count(hit);
    u = base + count - 1;
    if (count < (int)blockDim.x) break;
  }
  sink.init();
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
      sink.write(s, j, r);
    }
    __syncthreads();
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// src (M, src_width) floats; rows of width w; scratch (2 * n_block_tiles, w):
// cont, then head.  Two launches on st.
template <typename Vec, typename Keys, typename Sink>
void launch_tiles(const float* src, Keys keys, Sink sink, float* scratch, int m, int src_width,
                  int w, cudaStream_t st) {
  constexpr int kLanes = sizeof(Vec) / sizeof(float);
  int blocks = (m + kSegBlockTile - 1) / kSegBlockTile;
  Vec* cont = reinterpret_cast<Vec*>(scratch);
  Vec* head = reinterpret_cast<Vec*>(scratch + (int64_t)blocks * w);
  tile_kernel<Vec, Keys, Sink><<<blocks, kSegWarps * 32, 0, st>>>(
      reinterpret_cast<const Vec*>(src), keys, sink, cont, head, m, src_width / kLanes,
      w / kLanes);
  fixup_kernel<Vec, Keys, Sink><<<blocks, kFixWarps * 32, 0, st>>>(keys, cont, head, sink, m,
                                                                   w / kLanes);
}

template <bool WIDEN, typename Vec>
void launch_segsum(const float* src, const int* lo, const int* seg, float* scratch, float* out,
                   int m, int src_width, int w, cudaStream_t st) {
  constexpr int kLanes = sizeof(Vec) / sizeof(float);
  SumSink<Vec> sink{reinterpret_cast<Vec*>(out), seg, m, w / kLanes};
  launch_tiles<Vec>(src, SegKeys<WIDEN>{seg, lo}, sink, scratch, m, src_width, w, st);
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

template <int RULE, typename Vec>
void launch_dedup(const int* ids, const float* g, float* table, float* slot,
                  const float* hyper, float* scratch, int m, int e, int pack, int rows,
                  cudaStream_t st) {
  constexpr int kLanes = sizeof(Vec) / sizeof(float);
  int w = e * pack;
  UpdateSink<RULE, Vec> sink{reinterpret_cast<Vec*>(table), reinterpret_cast<Vec*>(slot),
                             hyper, rows, w / kLanes};
  launch_tiles<Vec>(g, IdKeys{ids, pack}, sink, scratch, m, e, w, st);
}

template <int RULE>
void launch_dedup_rule(const int* ids, const float* g, float* table, float* slot,
                       const float* hyper, float* scratch, int m, int e, int pack, int rows,
                       cudaStream_t st) {
  bool vec4 = e % 4 == 0 && aligned16(g) && aligned16(table) && aligned16(scratch) &&
              (slot == nullptr || aligned16(slot));
  if (vec4) {
    launch_dedup<RULE, float4>(ids, g, table, slot, hyper, scratch, m, e, pack, rows, st);
  } else {
    launch_dedup<RULE, float>(ids, g, table, slot, hyper, scratch, m, e, pack, rows, st);
  }
}

// ---- the row-wise update of unique rows ------------------------------------

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

}  // namespace

extern "C" {

// The tiling, which the wrapper checks against its own.
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
// (or null for sgd), hyper (7,) on the device, scratch
// (2 * ceil(M / (kSegTile * kSegWarps)), E*pack); M >= 1, R*pack < 2^31.
int trs_fused_sorted_dedup_update(const int* ids, const float* g, float* table,
                                  float* slot, const float* hyper, float* scratch,
                                  int rule, int m, int e, int pack, int rows,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rule == kAdam) {
    launch_dedup_rule<kAdam>(ids, g, table, slot, hyper, scratch, m, e, pack, rows, st);
  } else if (rule == kAdagrad) {
    launch_dedup_rule<kAdagrad>(ids, g, table, slot, hyper, scratch, m, e, pack, rows, st);
  } else if (rule == kSgd) {
    launch_dedup_rule<kSgd>(ids, g, table, slot, hyper, scratch, m, e, pack, rows, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// no two warps touch one row and no atomics are needed.  The grid is sized
// on the host from n_valid (the presort's unique count), so no thread is
// spent on the sentinel tail and nothing is read back from the device.
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
                                      int n_valid, int rows, int w) {
  int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (row >= n_valid) return;
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

// uids (>= n_valid,), gsum (>= n_valid, W), table (R, W), slot per rule (or
// null for sgd), hyper (7,) on the device; W % 4 == 0.
int trs_fused_rowwise_update(const int* uids, const float* gsum, float* table,
                             float* slot, const float* hyper, int rule,
                             int n_valid, int rows, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int blocks = (n_valid + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (rule == kAdam) {
    rowwise_update_kernel<kAdam><<<blocks, kThreads, 0, st>>>(
        uids, gsum, table, slot, hyper, n_valid, rows, w);
  } else if (rule == kAdagrad) {
    rowwise_update_kernel<kAdagrad><<<blocks, kThreads, 0, st>>>(
        uids, gsum, table, slot, hyper, n_valid, rows, w);
  } else if (rule == kSgd) {
    rowwise_update_kernel<kSgd><<<blocks, kThreads, 0, st>>>(
        uids, gsum, table, slot, hyper, n_valid, rows, w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// The dense optimizer's Adam and AdamW update: every element of every
// parameter of a group in one pass.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes by torecsys_tpu_torch/ops/kernels/adam.py, which also holds the
// plain version (torch's capturable single-tensor Adam, one operation at a
// time) and packs the argument table.  The entry point launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
//
// It replaces no TPU kernel: the JAX package's optax Adam is a chain of
// elementwise operations that XLA fuses into one pass on its own.  It is added
// because the port's dense optimizer, torch.optim.Adam(foreach=False,
// capturable=True), runs about 16 kernels a parameter (the step count, the
// moments, the bias corrections, the denominator, the update), each a pass
// over the tensor or a one-element launch: about 200 launches a step for a
// DeepFM tower, a third of its step on the card.
//
// Bound on this card: bytes.  Each element reads p, g, m and v and writes p,
// m and v once, 28 bytes; the float work (one square root and two divisions
// an element) is nothing against the card's rate.  Design: one grid-stride
// loop over the concatenation of the group's tensors in units of 4 elements,
// a 16-byte vector of each of p, g, m and v where the four tensors' bases are
// 16-byte aligned and the unit is whole, 4-byte scalars otherwise.  A thread
// finds its unit's tensor by a binary search over the units' prefix offsets
// and moves on from there.  The table of pointers, sizes and prefix offsets
// travels by value as the kernel's parameters (under 4 KB), so a CUDA graph
// captures it with the launch: no table is copied to the card.  The wrapper
// splits a group of more than kMaxTensors tensors into several launches.
//
// The step count: torch keeps it as a float32 tensor on the card, one a
// parameter.  multi_tensor_adam_count_kernel adds 1 to each before the update
// launch reads it, so no block of the update can read a count another block
// has already advanced: two launches a step.
//
// Arithmetic: float32, in the order of torch's capturable single-tensor step
// (the plain version), which is optax's update with eps after the
// bias-corrected square root:
//   p <- p * (1 - lr * wd)                          (AdamW, decoupled)
//   g <- g + wd * p                                 (Adam with L2)
//   m <- m + (1 - b1) * (g - m)                     (torch's lerp)
//   v <- b2 * v + (1 - b2) * g * g
//   p <- p + m / (sqrt(v) / (sqrt(1 - b2^t) * -s) + eps / -s),
//        s = lr / (1 - b1^t)
// with the bias corrections taken in float32 from the float32 count t.  The
// file is compiled with --fmad=false; the multiply-adds that ATen's kernels
// take (lerp, addcmul, add with alpha) are written as fmaf.  A parameter
// without a gradient comes with a null g and is updated on zeros, as optax
// updates every leaf.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTensors = 64;  // tensors a launch (kernel parameters under 4 KB)
constexpr int kThreads = 256;
constexpr int kUnit = 4;         // elements a unit: one 16-byte vector of float32

struct AdamTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];  // null: no gradient, taken as zeros
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  float* step[kMaxTensors];     // each parameter's float32 count
  long long numel[kMaxTensors];
  long long start[kMaxTensors + 1];  // first unit of each tensor; start[n]: all units
  unsigned char vec[kMaxTensors];    // 1: whole units move as 16-byte vectors
  int n;
  float lr, b1, b2, eps;
  float w1;     // 1 - b1, the lerp weight
  float c2;     // 1 - b2
  float decay;  // AdamW's 1 - lr * wd; 1 without decoupled decay
  float wd;     // Adam's L2 coefficient; 0 for AdamW
};
static_assert(sizeof(AdamTable) <= 4096, "the argument table must fit the 4 KB of parameters");

struct Coeffs {
  float scale;     // sqrt(1 - b2^t) * -lr / (1 - b1^t)
  float eps_term;  // eps / (-lr / (1 - b1^t))
};

__device__ __forceinline__ Coeffs coeffs(const AdamTable& a, int t) {
  const float count = *a.step[t];
  const float bc1 = 1.0f - powf(a.b1, count);
  const float bc2 = 1.0f - powf(a.b2, count);
  const float neg = -((1.0f / bc1) * a.lr);
  return {sqrtf(bc2) * neg, (1.0f / neg) * a.eps};
}

__device__ __forceinline__ void update(const AdamTable& a, Coeffs c, float& p, float g, float& m,
                                       float& v) {
  if (a.decay != 1.0f) p = p * a.decay;
  if (a.wd != 0.0f) g = fmaf(a.wd, p, g);
  const float d = g - m;
  m = a.w1 < 0.5f ? fmaf(a.w1, d, m) : fmaf(-d, 1.0f - a.w1, g);
  v = fmaf(a.c2, g * g, v * a.b2);
  const float denom = sqrtf(v) / c.scale + c.eps_term;
  p = p + m / denom;
}

// The tensor of unit u: the last t with start[t] <= u (tensors of no units
// share their start with the next one and are never found).
__device__ __forceinline__ int tensor_of(const AdamTable& a, long long u) {
  int lo = 0, hi = a.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.start[mid] <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void multi_tensor_adam_count_kernel(const AdamTable a) {
  const int t = static_cast<int>(threadIdx.x);
  if (t < a.n) *a.step[t] += 1.0f;
}

__global__ void __launch_bounds__(kThreads) multi_tensor_adam_kernel(const AdamTable a) {
  const long long total = a.start[a.n];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= total) return;
  int t = tensor_of(a, u);
  Coeffs c = coeffs(a, t);
  for (; u < total; u += stride) {
    if (u >= a.start[t + 1]) {
      t = tensor_of(a, u);
      c = coeffs(a, t);
    }
    const long long i = (u - a.start[t]) * kUnit;
    const long long left = a.numel[t] - i;
    float* p = a.p[t] + i;
    const float* g = a.g[t] == nullptr ? nullptr : a.g[t] + i;
    float* m = a.m[t] + i;
    float* v = a.v[t] + i;
    if (a.vec[t] && left >= kUnit) {
      float4 p4 = *reinterpret_cast<const float4*>(p);
      const float4 g4 = g == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                                     : *reinterpret_cast<const float4*>(g);
      float4 m4 = *reinterpret_cast<const float4*>(m);
      float4 v4 = *reinterpret_cast<const float4*>(v);
      update(a, c, p4.x, g4.x, m4.x, v4.x);
      update(a, c, p4.y, g4.y, m4.y, v4.y);
      update(a, c, p4.z, g4.z, m4.z, v4.z);
      update(a, c, p4.w, g4.w, m4.w, v4.w);
      *reinterpret_cast<float4*>(p) = p4;
      *reinterpret_cast<float4*>(m) = m4;
      *reinterpret_cast<float4*>(v) = v4;
    } else {
      const int k_end = left < kUnit ? static_cast<int>(left) : kUnit;
      for (int k = 0; k < k_end; ++k) {
        float pk = p[k], mk = m[k], vk = v[k];
        update(a, c, pk, g == nullptr ? 0.0f : g[k], mk, vk);
        p[k] = pk;
        m[k] = mk;
        v[k] = vk;
      }
    }
  }
}

}  // namespace

extern "C" {

int trs_adam_max_tensors() { return kMaxTensors; }

int trs_adam_table_bytes() { return static_cast<int>(sizeof(AdamTable)); }

int trs_adam_threads() { return kThreads; }

// table: one launch's AdamTable in host memory, copied into the launches'
// parameters; blocks: the update's grid (the wrapper's plan).
int trs_multi_tensor_adam(const void* table, int blocks, void* stream) {
  const AdamTable& a = *static_cast<const AdamTable*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  multi_tensor_adam_count_kernel<<<1, kMaxTensors, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  multi_tensor_adam_kernel<<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

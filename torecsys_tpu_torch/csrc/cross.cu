// DCN-v2's low-rank cross: one layer's combine, and its backward, each in
// one pass over the (B, D) features.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes by torecsys_tpu_torch/ops/kernels/cross.py, which also holds
// the plain versions (the same operations, one PyTorch op at a time) and the
// autograd Function's arguments.  Each entry point launches on the stream it
// is given, allocates nothing (the wrapper allocates outputs and scratch)
// and returns cudaGetLastError().
//
// It replaces no TPU kernel: the JAX package has no low-rank cross, and XLA
// would fuse the combine's elementwise chain by itself.  It is added because
// the port's layer (layers/ctr/cross.py, LowRankCrossNetworkLayer) ran the
// combine x' = x0 * (U V x + b) + x as ATen's separate passes: under a bf16
// compute dtype the bias add, the upcast of p, x0 * p and + x forward; x0's
// and p's products, p's downcast, the bias' sum, the upcast of the next
// layer's input gradient and the add of the two gradients of x' backward;
// each a full pass over (B, D) in float32 or bf16.  At DLRM-DCNv2's width
// (D = 3456, B = 16384, 3 layers) that is about 17 GB a step.
//
// Bound on this card: bytes.  Each element does a handful of float
// operations against 14-26 bytes moved.
//
// trs_low_rank_cross_forward, one layer:
//
//   p   = round_Y(y + b)        (no b: p = y, the product already biased)
//   x'  = round_T(round_T(x0 * round_T(p)) + x)
//   xb' = round_Y(x')           (where asked: the next layer's V input)
//
// T: x0's, x's and x''s dtype; Y: y's and b's, the layer's compute dtype
// (float32 or bf16 each).  The operations and roundings are ATen's for
// Dense's bias add in bf16 (layers/ctr/dense.py), p.to(T), x0 * p and + x:
// the result is the same bits.  The file is compiled with --fmad=false, so
// x0 * p + x stays a product rounded, then a sum rounded.  Writing x''s bf16
// copy in the same pass saves the cast the next layer's V GEMM would make.
// Reads x0, x (the same address as x0 in the first layer, where the second
// read hits L1), y and b; writes x' and xb'.
//
// trs_low_rank_cross_backward, one layer, from the gradients G of x', Gb of
// xb' (none where xb' was not made) and Gx0 of x0 as the later layers read
// it (none in the last layer):
//
//   Gt  = round_T(G + Gb)       (no Gb: Gt = G)
//   dx  = Gt                    (written only where Gb exists; else the
//                                wrapper hands G on; none where x is x0)
//   dx0 = round_T(Gt * round_T(p))    (+ Gt where x is x0, + Gx0 where
//                                      given, each sum rounded)
//   dy  = round_Y(round_T(Gt * x0))
//   db  = round_Y(sum over rows of dy)     (where b exists)
//
// with p recomputed from y and b, so no float32 p is kept for the backward.
// These are the roundings of autograd over the same ops: the add of x''s two
// gradients, mul's two products, the downcast of p's gradient, and the
// broadcast's sum, which ATen takes in float32 over the bf16 dy and rounds
// once.  The layers hand x0 on to each other (ops/interactions.py), so x0's
// gradient gathers in dx0 layer by layer, one read a layer, where autograd
// would add each layer's term in a pass of its own; its terms are summed in
// another order than autograd's, as is the bias' sum: each block sums its 64
// rows in a fixed order into a float32 partial (row block, column), and
// low_rank_cross_bias_grad_kernel sums the partials in a fixed order.  No
// atomics: a graph replay gives the eager step's bits.
//
// Design: a block of 16 x 16 threads covers 128 columns and 64 rows; each
// thread moves 8 consecutive columns of 4 rows, as 16-byte vectors (two for
// float32) where D is a multiple of 8 and every pointer 16-byte aligned,
// element by element otherwise.  Neighbouring threads read neighbouring
// 16-byte pieces of a row, so every load and store coalesces.  The grid is
// (row blocks, column blocks); at B = 16384, D = 3456 that is 256 x 27
// blocks, several waves, so the last partial wave costs little.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 8;            // consecutive columns a thread moves
constexpr int kColThreads = 16;    // threads across a block's columns
constexpr int kRowThreads = 16;    // threads down a block's rows
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kCols = kColThreads * kVec;  // 128 columns a block
constexpr int kRows = 64;                  // rows a block
constexpr int kRowsPerThread = kRows / kRowThreads;
// the bias gradient's second pass: 32 columns a block, 8 threads down the
// partials of each
constexpr int kSumCols = 32;
constexpr int kSumRows = 8;

using bf16 = __nv_bfloat16;

enum Kind { kFloat = 0, kBf16 = 1 };

struct Forward {
  const void* x0;
  const void* x;
  const void* y;
  const void* bias;  // null: y already holds the bias
  void* out;
  void* out_copy;    // null: no copy; else x' in Y
  long long rows, cols;
  int vec;           // 1: 16-byte vectors
};

struct Backward {
  const void* grad;
  const void* grad_copy;  // null: xb' had no gradient (or was not made)
  const void* grad_x0;    // null: the later layers read no x0
  const void* x0;
  const void* y;
  const void* bias;       // null: no bias gradient
  void* dx0;
  void* dx;               // null: not written
  void* dy;
  float* partials;        // (row blocks, cols) float32, where bias
  long long rows, cols;
  int vec;
  int x_is_x0;            // 1: dx0 also takes dx
};

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 consecutive elements from p as floats: one or two 16-byte vectors, or
// element by element (n valid, the rest 0).
__device__ __forceinline__ void load8(const float* p, bool vec, int n, float (&v)[kVec]) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = j < n ? p[j] : 0.0f;
}

__device__ __forceinline__ void load8(const bf16* p, bool vec, int n, float (&v)[kVec]) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = j < n ? __bfloat162float(p[j]) : 0.0f;
}

// Stores values already rounded to the destination's type (exact).
__device__ __forceinline__ void store8(float* p, bool vec, int n, const float (&v)[kVec]) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (j < n) p[j] = v[j];
}

__device__ __forceinline__ void store8(bf16* p, bool vec, int n, const float (&v)[kVec]) {
  if (vec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = u;
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (j < n) p[j] = __float2bfloat16_rn(v[j]);
}

// The block's first column of this thread, how many of its 8 lie inside the
// row (0: none), and the block's first row.
struct Tile {
  long long col, row0;
  int n;
};

__device__ __forceinline__ Tile tile(long long cols) {
  Tile t;
  t.col = static_cast<long long>(blockIdx.y) * kCols + threadIdx.x * kVec;
  const long long left = cols - t.col;
  t.n = left <= 0 ? 0 : (left < kVec ? static_cast<int>(left) : kVec);
  t.row0 = static_cast<long long>(blockIdx.x) * kRows + threadIdx.y;
  return t;
}

// p = round_T(round_Y(y + b)), or round_T(y) without a bias
template <typename T, typename Y>
__device__ __forceinline__ void projection(const float (&yv)[kVec], const float (&bv)[kVec],
                                           bool has_bias, float (&p)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    p[j] = round_to<T>(has_bias ? round_to<Y>(yv[j] + bv[j]) : yv[j]);
}

template <typename T, typename Y>
__global__ void __launch_bounds__(kThreads) low_rank_cross_forward_kernel(const Forward a) {
  const Tile t = tile(a.cols);
  if (t.n == 0) return;
  const bool vec = a.vec != 0;
  const bool has_bias = a.bias != nullptr;
  float bv[kVec] = {};
  if (has_bias) load8(static_cast<const Y*>(a.bias) + t.col, vec, t.n, bv);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long row = t.row0 + static_cast<long long>(k) * kRowThreads;
    if (row >= a.rows) break;
    const long long at = row * a.cols + t.col;
    float x0v[kVec], xv[kVec], yv[kVec], p[kVec], o[kVec];
    load8(static_cast<const T*>(a.x0) + at, vec, t.n, x0v);
    load8(static_cast<const T*>(a.x) + at, vec, t.n, xv);
    load8(static_cast<const Y*>(a.y) + at, vec, t.n, yv);
    projection<T, Y>(yv, bv, has_bias, p);
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = round_to<T>(round_to<T>(x0v[j] * p[j]) + xv[j]);
    store8(static_cast<T*>(a.out) + at, vec, t.n, o);
    if (a.out_copy != nullptr) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) o[j] = round_to<Y>(o[j]);
      store8(static_cast<Y*>(a.out_copy) + at, vec, t.n, o);
    }
  }
}

template <typename T, typename Y>
__global__ void __launch_bounds__(kThreads) low_rank_cross_backward_kernel(const Backward a) {
  __shared__ float sums[kRowThreads][kCols];
  const Tile t = tile(a.cols);
  const bool vec = a.vec != 0;
  const bool has_bias = a.bias != nullptr;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  if (t.n > 0) {
    float bv[kVec] = {};
    if (has_bias) load8(static_cast<const Y*>(a.bias) + t.col, vec, t.n, bv);
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const long long row = t.row0 + static_cast<long long>(k) * kRowThreads;
      if (row >= a.rows) break;
      const long long at = row * a.cols + t.col;
      float g[kVec], x0v[kVec], yv[kVec], p[kVec], d[kVec];
      load8(static_cast<const T*>(a.grad) + at, vec, t.n, g);
      if (a.grad_copy != nullptr) {
        float gb[kVec];
        load8(static_cast<const Y*>(a.grad_copy) + at, vec, t.n, gb);
#pragma unroll
        for (int j = 0; j < kVec; ++j) g[j] = round_to<T>(g[j] + gb[j]);
      }
      load8(static_cast<const T*>(a.x0) + at, vec, t.n, x0v);
      load8(static_cast<const Y*>(a.y) + at, vec, t.n, yv);
      projection<T, Y>(yv, bv, has_bias, p);
      if (a.dx != nullptr) store8(static_cast<T*>(a.dx) + at, vec, t.n, g);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        d[j] = round_to<T>(g[j] * p[j]);
        if (a.x_is_x0) d[j] = round_to<T>(d[j] + g[j]);
      }
      if (a.grad_x0 != nullptr) {
        float gx[kVec];
        load8(static_cast<const T*>(a.grad_x0) + at, vec, t.n, gx);
#pragma unroll
        for (int j = 0; j < kVec; ++j) d[j] = round_to<T>(d[j] + gx[j]);
      }
      store8(static_cast<T*>(a.dx0) + at, vec, t.n, d);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        d[j] = round_to<Y>(round_to<T>(g[j] * x0v[j]));
        acc[j] += d[j];
      }
      store8(static_cast<Y*>(a.dy) + at, vec, t.n, d);
    }
  }
  if (!has_bias) return;
  // the block's 64 rows: each thread's 4 summed above, then the 16 threads of
  // a column in order of threadIdx.y
#pragma unroll
  for (int j = 0; j < kVec; ++j) sums[threadIdx.y][threadIdx.x * kVec + j] = acc[j];
  __syncthreads();
  const int c = threadIdx.y * kColThreads + threadIdx.x;
  if (c >= kCols) return;
  const long long col = static_cast<long long>(blockIdx.y) * kCols + c;
  if (col >= a.cols) return;
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < kRowThreads; ++r) s += sums[r][c];
  a.partials[static_cast<long long>(blockIdx.x) * a.cols + col] = s;
}

// db[c] = round_Y(sum over row blocks r of partials[r, c]): 8 threads of a
// column each sum every 8th row block in order, then the 8 sums in order.
template <typename Y>
__global__ void __launch_bounds__(kSumCols * kSumRows)
    low_rank_cross_bias_grad_kernel(const float* partials, Y* db, long long blocks,
                                    long long cols) {
  __shared__ float sums[kSumRows][kSumCols];
  const long long col = static_cast<long long>(blockIdx.x) * kSumCols + threadIdx.x;
  float s = 0.0f;
  if (col < cols)
    for (long long r = threadIdx.y; r < blocks; r += kSumRows) s += partials[r * cols + col];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || col >= cols) return;
  float total = 0.0f;
#pragma unroll
  for (int r = 0; r < kSumRows; ++r) total += sums[r][threadIdx.x];
  if constexpr (sizeof(Y) == sizeof(float)) {
    db[col] = total;
  } else {
    db[col] = __float2bfloat16_rn(total);
  }
}

dim3 grid_of(long long rows, long long cols) {
  return dim3(static_cast<unsigned>((rows + kRows - 1) / kRows),
              static_cast<unsigned>((cols + kCols - 1) / kCols));
}

template <typename T, typename Y>
int forward(const Forward& a, cudaStream_t s) {
  low_rank_cross_forward_kernel<T, Y>
      <<<grid_of(a.rows, a.cols), dim3(kColThreads, kRowThreads), 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Y>
int backward(const Backward& a, void* db, cudaStream_t s) {
  const dim3 grid = grid_of(a.rows, a.cols);
  low_rank_cross_backward_kernel<T, Y><<<grid, dim3(kColThreads, kRowThreads), 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.bias == nullptr) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((a.cols + kSumCols - 1) / kSumCols);
  low_rank_cross_bias_grad_kernel<Y><<<blocks, dim3(kSumCols, kSumRows), 0, s>>>(
      a.partials, static_cast<Y*>(db), grid.x, a.cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int trs_cross_rows_per_block() { return kRows; }

int trs_cross_cols_per_block() { return kCols; }

// t_kind, y_kind: 0 float32, 1 bf16 (x0, x and x''s dtype; y's and b's).
int trs_low_rank_cross_forward(int t_kind, int y_kind, const void* x0, const void* x,
                               const void* y, const void* bias, void* out, void* out_copy,
                               long long rows, long long cols, int vec, void* stream) {
  const Forward a{x0, x, y, bias, out, out_copy, rows, cols, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_kind == kFloat && y_kind == kFloat) return forward<float, float>(a, s);
  if (t_kind == kFloat && y_kind == kBf16) return forward<float, bf16>(a, s);
  if (t_kind == kBf16 && y_kind == kFloat) return forward<bf16, float>(a, s);
  if (t_kind == kBf16 && y_kind == kBf16) return forward<bf16, bf16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// partials: (ceil(rows / 64), cols) float32 scratch, where bias; db: (cols,)
// in Y, where bias.
int trs_low_rank_cross_backward(int t_kind, int y_kind, const void* grad, const void* grad_copy,
                                const void* grad_x0, const void* x0, const void* y,
                                const void* bias, int x_is_x0,
                                void* dx0, void* dx, void* dy, float* partials, void* db,
                                long long rows, long long cols, int vec, void* stream) {
  const Backward a{grad, grad_copy, grad_x0, x0, y, bias, dx0, dx, dy, partials,
                   rows, cols, vec, x_is_x0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_kind == kFloat && y_kind == kFloat) return backward<float, float>(a, db, s);
  if (t_kind == kFloat && y_kind == kBf16) return backward<float, bf16>(a, db, s);
  if (t_kind == kBf16 && y_kind == kFloat) return backward<bf16, float>(a, db, s);
  if (t_kind == kBf16 && y_kind == kBf16) return backward<bf16, bf16>(a, db, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

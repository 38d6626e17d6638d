// xDeepFM's CIN compression, forward and backward, with the layer's outer
// product never written to device memory.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes by torecsys_tpu_torch/ops/kernels/cin.py, which also holds the
// plain version (the composition of PyTorch ops the port ran before, which
// the CPU takes) and the autograd Function's arguments.  Each entry point
// launches on the stream it is given, allocates nothing (the wrapper
// allocates the outputs and the scratch that trs_cin_scratch sizes: W^T,
// G^T, the weight gradient's partials) and returns cudaGetLastError().
//
// It replaces no TPU kernel: the JAX package leaves the CIN to one einsum,
// which XLA contracts without a Pallas kernel.  It is added because the
// port's composition formed the outer product
//
//   z[(h, n), (b, e)] = xk[b, h, e] * x0[b, n, e]
//
// in device memory and compressed it with one cuBLAS GEMM, out = W z, where
// W is the layer's (O, H, N) weight as an (O, K = H*N) matrix.  At xDeepFM's
// Criteo shapes (B = 4096, N = 26, E = 10, 200 maps a layer) z is 0.28-0.43
// GB a layer; autograd kept it for the weight gradient, wrote dz = W^T G as
// large again and reduced dz * x0 and dz * xk in strided elementwise passes:
// about ten passes over such buffers a layer, some 40% of the step.
//
// The three products, with c = (b, e) the C = B*E columns and G the
// gradient of out:
//
//   forward   out[b, o, e] = sum_k W[o, k] z[k, c]                (rows o)
//   input     dz[k, c] = sum_o W[o, k] G[o, c], then in the epilogue
//             dxk[b, h, e] = sum_n dz[(h, n), c] x0[b, n, e]
//             dx0[b, n, e] = sum_h dz[(h, n), c] xk[b, h, e]      (rows k)
//   weight    dW[o, k] = sum_c G[o, c] z[k, c]                    (rows o)
//
// Bound on this card: float32 FFMA.  Each is a GEMM of 2*O*K*C operations
// (42.6 GFLOP at the middle layer's O = 200, K = 2,600, C = 40,960), 0.64 ms
// at 67 TFLOP/s, against 13-40 MB of operands: hundreds of operations a
// byte.  The CIN runs in float32 with TF32 off, so every product is a float32
// fmaf on the CUDA cores; no tensor-core format keeps float32's bits.
//
// Design.  One SIMT GEMM core serves the three kernels (stage_product): a
// thread keeps an 8 x 8 tile of sums in registers, its rows and columns
// split in two halves of 4 so that the 16-byte shared loads of a warp fall
// on distinct banks; a block of TR x TC threads covers 8*TR rows and 8*TC
// columns and walks the reduction in stages of kDepth.  A stage's operands
// are copied from device memory into shared memory with cp.async stages
// ahead of their use (zero-filled past the edges, nothing held in
// registers), one __syncthreads a stage.  The W operand of the forward and
// the G operand of the weight kernel are the matrices' transposes, W^T (K,
// O) and G^T (C, O), which cin_transpose_kernel writes first (2 MB and 33
// MB at the cell's shapes), so that their stages arrive in 16-byte pieces
// instead of 4-byte gathers.  The outer product is formed in shared memory
// one stage ahead of its use, each of the first 8*TC threads its column:
// forward, from xk's rows of the stage (copied) and x0 (kept for the
// block's columns, its rows repeated past N so that a stage's steps read
// rows n0, n0 + 1, ... without a branch); weight, from x0's and xk's rows
// at the stage's columns (copied).  The input kernel's block owns a column
// tile and walks every h in groups, each group's rows being all (h, n) of
// its h's, the groups' stages one pipeline: after a group's product the dz
// tile goes to shared memory, where its epilogue reduces it against x0 into
// dxk (written) and against xk into dx0, whose sums stay in shared memory
// until the last group.  The weight kernel splits C over blocks so that
// every SM has work; each split writes a float32 partial of dW and
// cin_weight_grad_sum_kernel sums them in split order.
//
// The tiles follow the shapes and the card's SM count alone (the planning
// section says how).  Every sum runs in one fixed order and nothing is
// atomic: the same inputs give the same bits on every run, eager or in a
// CUDA graph.
//
// Edges are masked: any B, E, O, H, N whose tiles fit the card's shared
// memory (a group of the input kernel holds at least N rows of dz: N up to
// 225 in an H100's 227 KB).
// xk may be strided along b and h (the split-half CIN hands on the second
// half of a (B, O, E) map); along e it is packed, as x0, W, G and the
// outputs are.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdio>

namespace {

constexpr int kTile = 8;           // a thread's rows and columns of sums
constexpr int kHalf = kTile / 2;   // ... in two halves of 4
constexpr int kDepth = 16;         // reduction steps a stage
constexpr int kMinSide = 8;        // fewest threads along a block's rows or columns
constexpr int kMaxRows = 32;       // most threads along the rows of the O-row kernels
constexpr int kMaxSide = 64;
constexpr int kMaxThreads = 512;  // a block's most threads: 128 registers a thread
constexpr int kPieces = kDepth / 4;    // a thread's most 16-byte copies a stage (threads >= bm)
constexpr int kMaxSplits = 64;     // the weight kernel's most column splits
constexpr int kSumThreads = 256;

struct Dims {
  long long batch;    // B
  int fields;         // N
  int embed;          // E
  int maps;           // H
  int outs;           // O
  long long xk_sb;    // xk's strides along b and h, in elements (along e: 1)
  long long xk_sh;
};

__host__ __device__ inline long long cols_of(const Dims& d) {
  return d.batch * d.embed;
}
__host__ __device__ inline long long depth_of(const Dims& d) {
  return static_cast<long long>(d.maps) * d.fields;
}

// A launch's tiling: TR x TC threads; group: h a row group (input kernel) or
// a column tile (weight kernel); splits: the weight kernel's column splits,
// span: columns a split (a multiple of kDepth).
struct Plan {
  int tr, tc, group, splits;
  long long span;
  int smem;
  dim3 grid;
};

// x / d and x % d for 0 <= x < 2^31 without a division: a multiply-high
// by a multiplier made on the host (CUTLASS's FastDivmod).
struct FastDiv {
  int d;
  unsigned mult, shift;
};
__host__ inline FastDiv fast_div(int d) {
  FastDiv f{d, 0, 0};
  if (d != 1) {
    unsigned p = 0;
    while ((1u << p) < static_cast<unsigned>(d)) ++p;
    f.mult = static_cast<unsigned>(((1ull << (31 + p)) + d - 1) / d);
    f.shift = p - 1;
  }
  return f;
}
__device__ __forceinline__ int quotient(int x, const FastDiv& f) {
  return f.d == 1 ? x : static_cast<int>(__umulhi(static_cast<unsigned>(x), f.mult) >> f.shift);
}

struct ForwardArgs {
  const float* x0;
  const float* xk;
  const float* wt;    // W^T: (K, op), op = O rounded up to 4
  float* out;
  Dims d;
  int tr, tc, slots;  // slots: xk's rows a stage reads at most
  int op;
  FastDiv vectors_div, nf_div;  // by bm / 4 and by N
};

struct InputArgs {
  const float* grad;
  const float* x0;
  const float* xk;
  const float* w;
  float* dx0;
  float* dxk;
  Dims d;
  int tr, tc, group;
  FastDiv bn_div;  // by bn
};

struct WeightArgs {
  const float* gt;    // G^T: (C, op), op = O rounded up to 4
  const float* x0;
  const float* xk;
  float* out;   // dW, or the splits' partials (split, O, K)
  Dims d;
  int tr, tc, group;
  long long span;
  int op;
  FastDiv vectors_div;  // by bm / 4
};

// Row (or column) of a thread's i-th sum: its 4 rows in each half of the
// block's 2*half rows.
__device__ __forceinline__ int tile_at(int t, int half, int i) {
  return (i < kHalf ? 0 : half) + t * kHalf + (i & (kHalf - 1));
}

// One stage: acc[i][j] += sum over kk of as[kk][row i] * bs[kk][col j], the
// operands in shared memory as [kDepth][lda] and [kDepth][ldb].
__device__ __forceinline__ void stage_product(const float* __restrict__ as,
                                              const float* __restrict__ bs, int lda, int ldb,
                                              int tr, int tc, float (&acc)[kTile][kTile]) {
  const int ar = tr * kHalf, bc = tc * kHalf, ah = lda / 2, bh = ldb / 2;
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * lda + ar);
    const float4 a1 = *reinterpret_cast<const float4*>(as + kk * lda + ah + ar);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * ldb + bc);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * ldb + bh + bc);
    const float a[kTile] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[kTile] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTile][kTile]) {
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.0f;
}

// ---- the copies: cp.async of 4 or 16 bytes into a shared address; bytes
// below the size are zero-filled, and nothing is read where bytes is 0 ------

__device__ __forceinline__ unsigned shared_at(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy4(unsigned dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void copy16(unsigned dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// (b, e) of the column kDepth on: e + kDepth wraps at most kDepth / E + 1
// times.
__device__ __forceinline__ void step_column(long long& b, int& e, int ne) {
  e += kDepth;
  while (e >= ne) {
    e -= ne;
    ++b;
  }
}

// The next of three buffers, and of four.
__device__ __forceinline__ int next3(int i) { return i == 2 ? 0 : i + 1; }
__device__ __forceinline__ int next4(int i) { return (i + 1) & 3; }

// Each column c0 + cc of a block's tile: its element offset b * stride + e
// in a (B, ., E) tensor whose b stride is `stride`, or -1 past the last
// column.
__device__ __forceinline__ long long column_at(long long c, long long cols, int ne,
                                               long long stride) {
  if (c >= cols) return -1;
  const long long b = c / ne;
  return b * stride + (c - b * ne);
}

// (B, N, E) x0 at the block's bn columns into x0s[rows][bn], row r holding
// x0's row r % N (zero past the last column).
__device__ __forceinline__ void stage_x0(float* x0s, int rows, const float* x0, long long c0,
                                         long long cols, int nf, int ne, int bn, int t,
                                         int threads) {
  for (int i = t; i < rows * bn; i += threads) {
    const int r = i / bn, cc = i - (i / bn) * bn;
    const long long at = column_at(c0 + cc, cols, ne, static_cast<long long>(nf) * ne);
    x0s[i] = at >= 0 ? x0[at + static_cast<long long>(r % nf) * ne] : 0.0f;
  }
}

// ---- transposes: out[b][c][r] = in[b][r][c] for each of `batch` (rows x
// cols) matrices, out's rows `ld` >= rows floats apart (whole 16-byte
// pieces), so that a kernel copies them in 16-byte pieces: W^T for the
// forward, G^T (C, O) for the weight kernel ----------------------------------

constexpr int kTransposeSide = 32;

__global__ void __launch_bounds__(kTransposeSide * 8)
    cin_transpose_kernel(const float* in, float* out, long long batch, int rows, int cols,
                         int ld) {
  __shared__ float tile[kTransposeSide][kTransposeSide + 1];
  const int c0 = blockIdx.x * kTransposeSide, r0 = blockIdx.y * kTransposeSide;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const float* const src = in + b * rows * cols;
    float* const dst = out + b * cols * ld;
    for (int i = threadIdx.y; i < kTransposeSide; i += 8) {
      const int r = r0 + i, c = c0 + threadIdx.x;
      tile[i][threadIdx.x] = r < rows && c < cols ? src[static_cast<long long>(r) * cols + c] : 0.0f;
    }
    __syncthreads();
    for (int i = threadIdx.y; i < kTransposeSide; i += 8) {
      const int c = c0 + i, r = r0 + threadIdx.x;
      if (c < cols && r < ld) dst[static_cast<long long>(c) * ld + r] = tile[threadIdx.x][i];
    }
    __syncthreads();
  }
}

// ---- forward: rows o, columns c, reduction k = (h, n) ----------------------
//
// Shared: as[4][kDepth][bm] (W^T's rows of a stage, 16-byte copies) and
// xs[3][slots][bn] (the xk rows h a stage's steps k = (h, n) read, thread t <
// bn copying its column), copied three stages ahead; bs[2][kDepth][bn] (z's
// rows of a stage), formed one stage ahead, thread t < bn its column t;
// x0s[N + kDepth][bn] (x0 at the block's columns, row r holding x0's row r %
// N, so that a stage's steps read rows n0, n0 + 1, ... without wrapping).
__global__ void __launch_bounds__(kMaxThreads) cin_forward_kernel(const ForwardArgs a) {
  extern __shared__ float4 shared4[];
  float* const shared = reinterpret_cast<float*>(shared4);
  const int bm = a.tr * kTile, bn = a.tc * kTile;
  const int nf = a.d.fields, ne = a.d.embed, nh = a.d.maps, no = a.d.outs;
  const int threads = a.tr * a.tc, op = a.op, vectors = bm / 4;
  const long long cols = cols_of(a.d);
  const int depth = static_cast<int>(depth_of(a.d));
  const int slots = a.slots;
  float* const as = shared;
  float* const bs = as + 4 * kDepth * bm;
  float* const xs = bs + 2 * kDepth * bn;
  float* const x0s = xs + 3 * slots * bn;
  const int t = threadIdx.x, tr = t / a.tc, tc = t - (t / a.tc) * a.tc;
  const long long c0 = static_cast<long long>(blockIdx.x) * bn;
  const int o0 = blockIdx.y * bm;

  stage_x0(x0s, nf + kDepth, a.x0, c0, cols, nf, ne, bn, t, threads);
  // thread t < bn: column c0 + t's offset in xk
  const long long xk_col = t < bn ? column_at(c0 + t, cols, ne, a.d.xk_sb) : -1;
  const unsigned xs_at = shared_at(xs + t);
  __syncthreads();

  const int stages = (depth + kDepth - 1) / kDepth;
  int copy_h = 0, copy_n = 0;  // the first (h, n) of the stage to copy
  auto fetch = [&](int s, int buf4, int buf3) {
    const int k0 = s * kDepth;
    // W^T's 16-byte pieces (kk, v)
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int item = t + i * threads;
      if (item < kDepth * vectors) {
        const int kk = quotient(item, a.vectors_div), v = item - kk * vectors;
        const int o = o0 + 4 * v, k = k0 + kk;
        const int bytes = k < depth ? 4 * max(0, min(4, no - o)) : 0;
        copy16(shared_at(as + (buf4 * kDepth + kk) * bm + 4 * v),
               a.wt + (bytes ? static_cast<long long>(k) * op + o : 0), bytes);
      }
    }
    // xk's rows h = copy_h, copy_h + 1, ... at this thread's column
    if (t < bn) {
      for (int j = 0; j < slots; ++j) {
        const bool in = xk_col >= 0 && copy_h + j < nh;
        copy4(xs_at + 4u * (buf3 * slots + j) * bn,
              a.xk + (in ? xk_col + (copy_h + j) * a.d.xk_sh : 0), in ? 4 : 0);
      }
    }
    commit();
    copy_n += kDepth;
    const int wraps = quotient(copy_n, a.nf_div);
    copy_n -= wraps * nf;
    copy_h += wraps;
  };
  // z's column t at the stage's steps: xk's row h (the stage's slot j, the
  // times n0 + kk wraps past N) times x0's row n
  int form_n = 0;  // n of the first step of the stage to form
  auto form = [&](int s, int buf3) {
    if (t < bn) {
      const float* const xr = xs + buf3 * slots * bn + t;
      const float* const yr = x0s + form_n * bn + t;
      float* const dst = bs + (s & 1) * kDepth * bn + t;
      float z[kDepth];
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk)
        z[kk] = xr[quotient(form_n + kk, a.nf_div) * bn] * yr[kk * bn];
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) dst[kk * bn] = z[kk];
    }
    form_n += kDepth - quotient(form_n + kDepth, a.nf_div) * nf;
  };

  float acc[kTile][kTile];
  zero(acc);
  for (int s = 0; s < 3; ++s) {
    if (s < stages) fetch(s, s, s);
    else commit();
  }
  wait_copies<2>();
  __syncthreads();
  form(0, 0);
  for (int s = 0, cur4 = 0, next = 1; s < stages; ++s, cur4 = next4(cur4), next = next3(next)) {
    // stage s + 1's copies landed (this thread's); the barrier shows them,
    // and z of stage s, to all
    wait_copies<1>();
    __syncthreads();
    if (s + 3 < stages) fetch(s + 3, next4(next4(next4(cur4))), next3(next3(next)));
    else commit();
    if (s + 1 < stages) form(s + 1, next);
    stage_product(as + cur4 * kDepth * bm, bs + (s & 1) * kDepth * bn, bm, bn, tr, tc, acc);
  }

#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const long long c = c0 + tile_at(tc, bn / 2, j);
    if (c >= cols) continue;
    const long long b = c / ne;
    float* const dst = a.out + b * no * ne + (c - b * ne);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int o = o0 + tile_at(tr, bm / 2, i);
      if (o < no) dst[static_cast<long long>(o) * ne] = acc[i][j];
    }
  }
}

// ---- backward, input side: rows k = (h, n) a group, columns c, reduction o --
//
// Shared: as[3][kDepth][bm] (W's rows of a stage at the group's k: thread t
// < bm copies k = h0 * N + t), bs[3][kDepth][bn] (G's rows at the block's
// columns: thread t < bn copies column c0 + t), both two stages ahead, the
// stages of all the groups one pipeline; zs[bm][bn] (the group's dz),
// x0s[N][bn], dx0s[N][bn] (dx0's sums), xks[group][bn].
__global__ void __launch_bounds__(kMaxThreads) cin_backward_input_kernel(const InputArgs a) {
  extern __shared__ float4 shared4[];
  float* const shared = reinterpret_cast<float*>(shared4);
  const int bm = a.tr * kTile, bn = a.tc * kTile;
  const int nf = a.d.fields, ne = a.d.embed, nh = a.d.maps, no = a.d.outs;
  const int threads = a.tr * a.tc;
  const long long cols = cols_of(a.d);
  const int depth = static_cast<int>(depth_of(a.d));
  float* const as = shared;
  float* const bs = as + 3 * kDepth * bm;
  float* const zs = bs + 3 * kDepth * bn;
  float* const x0s = zs + bm * bn;
  float* const dx0s = x0s + nf * bn;
  float* const xks = dx0s + nf * bn;
  long long* const dofs = reinterpret_cast<long long*>(xks + a.group * bn);
  const int t = threadIdx.x, tr = t / a.tc, tc = t - (t / a.tc) * a.tc;
  const long long c0 = static_cast<long long>(blockIdx.x) * bn;

  stage_x0(x0s, nf, a.x0, c0, cols, nf, ne, bn, t, threads);
  for (int i = t; i < nf * bn; i += threads) dx0s[i] = 0.0f;
  // the columns' offsets in dxk, or -1 past the last
  for (int cc = t; cc < bn; cc += threads)
    dofs[cc] = column_at(c0 + cc, cols, ne, static_cast<long long>(nh) * ne);
  // thread t < bn: column c0 + t's G and xk
  long long g_col = -1, xk_col = -1;
  if (t < bn) {
    g_col = column_at(c0 + t, cols, ne, static_cast<long long>(no) * ne);
    xk_col = column_at(c0 + t, cols, ne, a.d.xk_sb);
  }
  const unsigned as_at = shared_at(as + t), bs_at = shared_at(bs + t);
  __syncthreads();

  // the pipeline's stages: every group's stages of o in turn
  const int stages = (no + kDepth - 1) / kDepth;
  const int groups = (nh + a.group - 1) / a.group;
  const int total = groups * stages;
  int copy_h0 = 0, copy_s = 0;  // the group and stage to copy next
  auto fetch = [&](int buf3) {
    const int o0 = copy_s * kDepth;
    if (t < bm) {
      const int bytes = t < min(a.group, nh - copy_h0) * nf ? 4 : 0;
      const float* src = a.w + (bytes ? static_cast<long long>(o0) * depth + copy_h0 * nf + t : 0);
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk, src += bytes ? depth : 0)
        copy4(as_at + 4u * (buf3 * kDepth + kk) * bm, src, o0 + kk < no ? bytes : 0);
    }
    if (t < bn) {
      const int bytes = g_col >= 0 ? 4 : 0;
      const float* src = a.grad + (bytes ? g_col + static_cast<long long>(o0) * ne : 0);
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk, src += bytes ? ne : 0)
        copy4(bs_at + 4u * (buf3 * kDepth + kk) * bn, src, o0 + kk < no ? bytes : 0);
    }
    commit();
    if (++copy_s == stages) {
      copy_s = 0;
      copy_h0 += a.group;
    }
  };

  float acc[kTile][kTile];
  zero(acc);
  fetch(0);
  if (total > 1) fetch(1);
  else commit();
  int h0 = 0, s = 0;
  for (int q = 0, cur = 0; q < total; ++q, cur = next3(cur)) {
    wait_copies<1>();
    __syncthreads();
    if (q + 2 < total) fetch(next3(next3(cur)));
    else commit();
    stage_product(as + cur * kDepth * bm, bs + cur * kDepth * bn, bm, bn, tr, tc, acc);
    if (++s < stages) continue;

    // the group's dz into shared memory, xk's rows of the group beside it
    const int hv = min(a.group, nh - h0);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      float* const row = zs + tile_at(tr, bm / 2, i) * bn;
      *reinterpret_cast<float4*>(row + tc * kHalf) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + bn / 2 + tc * kHalf) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    zero(acc);
    if (t < bn) {
      for (int hh = 0; hh < hv; ++hh)
        xks[hh * bn + t] = xk_col >= 0 ? a.xk[xk_col + (h0 + hh) * a.d.xk_sh] : 0.0f;
    }
    __syncthreads();
    // dxk[b, h, e] = sum over n of dz[(h, n), c] x0[b, n, e]: the even n's
    // and the odd n's each summed in order, then the two
    for (int i = t; i < hv * bn; i += threads) {
      const int hh = quotient(i, a.bn_div), cc = i - hh * bn;
      if (dofs[cc] < 0) continue;
      const float* const zc = zs + hh * nf * bn + cc;
      float even = 0.0f, odd = 0.0f;
      int n = 0;
      for (; n + 1 < nf; n += 2) {
        even = fmaf(zc[n * bn], x0s[n * bn + cc], even);
        odd = fmaf(zc[(n + 1) * bn], x0s[(n + 1) * bn + cc], odd);
      }
      if (n < nf) even = fmaf(zc[n * bn], x0s[n * bn + cc], even);
      a.dxk[dofs[cc] + static_cast<long long>(h0 + hh) * ne] = even + odd;
    }
    // dx0's sums += sum over the group's h of dz[(h, n), c] xk[b, h, e], h
    // in order (each sum is kept by the same thread in every group)
    for (int i = t; i < nf * bn; i += threads) {
      const int n = quotient(i, a.bn_div), cc = i - n * bn;
      float sum = dx0s[i];
      for (int hh = 0; hh < hv; ++hh)
        sum = fmaf(zs[(hh * nf + n) * bn + cc], xks[hh * bn + cc], sum);
      dx0s[i] = sum;
    }
    s = 0;
    h0 += a.group;
  }
  __syncthreads();

  for (int i = t; i < nf * bn; i += threads) {
    const int n = quotient(i, a.bn_div), cc = i - n * bn;
    const long long c = c0 + cc;
    if (c >= cols) continue;
    const long long b = c / ne;
    a.dx0[(b * nf + n) * ne + (c - b * ne)] = dx0s[i];
  }
}

// ---- backward, weight side: rows o, columns k = (h, n) a tile, reduction c --
//
// Shared: as[4][kDepth][bm] (G^T's rows at a stage's 8 columns c, 16-byte
// copies), bs[2][kDepth][bn] (z at them for the tile's k), rs[3][N +
// group][kDepth] (x0's and xk's rows at them).  G^T and the rows are copied
// three stages ahead, z formed one stage ahead, thread t < bn its column t.
// Thread t of each whole eight copies the rows' column t % 8 of every stage,
// whose (b, e) it follows from stage to stage, at the rows t / 8, t / 8 +
// threads / 8, ...
__global__ void __launch_bounds__(kMaxThreads) cin_backward_weight_kernel(const WeightArgs a) {
  extern __shared__ float4 shared4[];
  float* const shared = reinterpret_cast<float*>(shared4);
  const int bm = a.tr * kTile, bn = a.tc * kTile, vectors = bm / 4;
  const int nf = a.d.fields, ne = a.d.embed, nh = a.d.maps, no = a.d.outs;
  const int threads = a.tr * a.tc, rows = nf + a.group, lanes = threads / kDepth;
  const long long cols = cols_of(a.d);
  const int depth = static_cast<int>(depth_of(a.d));
  float* const as = shared;
  float* const bs = as + 4 * kDepth * bm;
  float* const rs = bs + 2 * kDepth * bn;
  const int t = threadIdx.x, tr = t / a.tc, tc = t - (t / a.tc) * a.tc;
  const int h0 = blockIdx.x * a.group;
  const int kv = min(a.group, nh - h0) * nf;  // the tile's columns that exist
  const long long c_begin = static_cast<long long>(blockIdx.y) * a.span;
  const long long c_end = min(cols, c_begin + a.span);
  const int o0 = blockIdx.z * bm;

  // this thread's column t % 8 of the copying stage: its (b, e); the
  // threads past the last whole eight copy no rows
  const int ck = t & (kDepth - 1), r0 = t < lanes * kDepth ? t / kDepth : rows;
  long long cb = c_begin / ne;
  int ce = static_cast<int>(c_begin - cb * ne) + ck;
  while (ce >= ne) {
    ce -= ne;
    ++cb;
  }
  const unsigned rs_at = shared_at(rs + r0 * kDepth + ck);
  // thread t < bn forms z's column t = (h, n): its rows of rs
  const bool z_col = t < kv;
  const int zh = z_col ? t / nf : 0, zn = z_col ? t - (t / nf) * nf : 0;

  const int stages =
      c_end > c_begin ? static_cast<int>((c_end - c_begin + kDepth - 1) / kDepth) : 0;
  auto fetch = [&](int s, int buf4, int buf3) {
    const long long c = c_begin + static_cast<long long>(s) * kDepth;
    // G^T's 16-byte pieces (kk, v)
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int item = t + i * threads;
      if (item < kDepth * vectors) {
        const int kk = quotient(item, a.vectors_div), v = item - kk * vectors;
        const int o = o0 + 4 * v;
        const int bytes = c + kk < c_end ? 4 * max(0, min(4, no - o)) : 0;
        copy16(shared_at(as + (buf4 * kDepth + kk) * bm + 4 * v),
               a.gt + (bytes ? (c + kk) * a.op + o : 0), bytes);
      }
    }
    const bool col_in = c + ck < c_end;
    for (int r = r0; r < rows; r += lanes) {
      const unsigned dst = rs_at + 4u * (buf3 * rows + r - r0) * kDepth;
      if (r < nf) {
        copy4(dst, a.x0 + (col_in ? cb * nf * ne + ce + r * ne : 0), col_in ? 4 : 0);
      } else {
        const int h = h0 + r - nf;
        const bool in = col_in && h < nh;
        copy4(dst, a.xk + (in ? cb * a.d.xk_sb + ce + h * a.d.xk_sh : 0), in ? 4 : 0);
      }
    }
    commit();
    step_column(cb, ce, ne);
  };
  // z[k, c] = xk[h, c] x0[n, c] at the stage's columns, k = (h, n)
  auto form = [&](int s, int buf3) {
    if (t < bn) {
      const float4* const xr =
          reinterpret_cast<const float4*>(rs + (buf3 * rows + nf + zh) * kDepth);
      const float4* const yr = reinterpret_cast<const float4*>(rs + (buf3 * rows + zn) * kDepth);
      float z[kDepth];
#pragma unroll
      for (int q = 0; q < kDepth / 4; ++q) {
        const float4 x = xr[q], y = yr[q];
        z[4 * q] = x.x * y.x;
        z[4 * q + 1] = x.y * y.y;
        z[4 * q + 2] = x.z * y.z;
        z[4 * q + 3] = x.w * y.w;
      }
      float* const dst = bs + (s & 1) * kDepth * bn + t;
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) dst[kk * bn] = z_col ? z[kk] : 0.0f;
    }
  };

  float acc[kTile][kTile];
  zero(acc);
  for (int s = 0; s < 3; ++s) {
    if (s < stages) fetch(s, s, s);
    else commit();
  }
  wait_copies<2>();
  __syncthreads();
  if (stages > 0) form(0, 0);
  for (int s = 0, cur4 = 0, next = 1; s < stages; ++s, cur4 = next4(cur4), next = next3(next)) {
    // stage s + 1's copies landed (this thread's); the barrier shows them,
    // and z of stage s, to all
    wait_copies<1>();
    __syncthreads();
    if (s + 3 < stages) fetch(s + 3, next4(next4(next4(cur4))), next3(next3(next)));
    else commit();
    if (s + 1 < stages) form(s + 1, next);
    stage_product(as + cur4 * kDepth * bm, bs + (s & 1) * kDepth * bn, bm, bn, tr, tc, acc);
  }

  float* const dst = a.out + static_cast<long long>(blockIdx.y) * no * depth +
                     static_cast<long long>(h0) * nf;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int o = o0 + tile_at(tr, bm / 2, i);
    if (o >= no) continue;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int k = tile_at(tc, bn / 2, j);
      if (k < kv) dst[static_cast<long long>(o) * depth + k] = acc[i][j];
    }
  }
}

// dW[i] = sum over splits s, in order, of partials[s][i]
__global__ void __launch_bounds__(kSumThreads)
    cin_weight_grad_sum_kernel(const float* partials, float* dw, long long n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= n) return;
  float sum = partials[i];
  for (int s = 1; s < splits; ++s) sum += partials[static_cast<long long>(s) * n + i];
  dw[i] = sum;
}

// ---- planning ----------------------------------------------------------------
//
// A launch's tiling follows the shapes and two numbers of the card, its SMs
// and the shared memory a block may opt into, computed anew at each call (a
// few thousand integer steps at most).  Every block here holds most of an SM's
// registers (up to 512 threads at up to 128 registers), so an SM runs one
// at a time and a grid takes ceil(blocks / SMs) rounds.  The forward and the
// weight kernel take all O rows in one block where they fit and as many
// threads' columns as 512 threads allow, fewer only where shared memory is
// short; the weight kernel's tile of k is as many h's as those columns hold.
// The weight kernel's column splits, and the input kernel's row group and
// column tile, are then those whose rounds times a block's multiply-adds,
// padding included, are fewest: the last round of blocks fills the card.

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// W^T's row length: O rounded up to whole 16-byte pieces
int padded_outs(int outs) { return (outs + 3) / 4 * 4; }

// xk's rows a forward stage of kDepth k = (h, n) reads: one more than the
// times n wraps past N
int slots_of(const Dims& d) { return std::min(kDepth, 1 + (d.fields + kDepth - 2) / d.fields); }

enum Which { kForward, kInput, kWeight };

int smem_of(Which which, int tr, int tc, int group, const Dims& d) {
  const long long bm = tr * kTile, bn = tc * kTile;
  long long floats = 3LL * kDepth * bm + 2LL * kDepth * bn;
  // a column's 8-byte offsets count as two floats
  if (which == kForward) floats += kDepth * bm + (3LL * slots_of(d) + d.fields + kDepth) * bn;
  if (which == kInput) floats += kDepth * bn + bm * bn + (2LL * d.fields + group + 2) * bn;
  if (which == kWeight) floats += kDepth * bm + 3LL * kDepth * (d.fields + group);
  return floats * 4 > (1LL << 30) ? (1 << 30) : static_cast<int>(floats * 4);
}

struct Card {
  int sms, smem;
};

cudaError_t card_of(Card* card) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&card->sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&card->smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err;
}

// threads along the rows of the O-row kernels: all O rows where they fit
int out_rows(const Dims& d) {
  return static_cast<int>(
      std::min<long long>(kMaxRows, std::max<long long>(kMinSide, ceil_div(d.outs, kTile))));
}

bool plan_forward(const Card& card, const Dims& d, Plan* p) {
  const int tr = out_rows(d);
  for (int tc = kMaxThreads / tr; tc >= kMinSide; --tc) {
    const int smem = smem_of(kForward, tr, tc, 0, d);
    const long long col_tiles = ceil_div(cols_of(d), tc * kTile);
    if (smem > card.smem || col_tiles > 0x7fffffffLL) continue;
    *p = Plan{tr, tc, 0, 1, 0, smem,
              dim3(static_cast<unsigned>(col_tiles),
                   static_cast<unsigned>(ceil_div(d.outs, tr * kTile)), 1)};
    return true;
  }
  return false;
}

bool plan_weight(const Card& card, const Dims& d, Plan* p) {
  // a tile of k holds at least one h's N columns
  const int least = static_cast<int>(std::max<long long>(kMinSide, ceil_div(d.fields, kTile)));
  if (least > kMaxSide) return false;
  const int tr = std::min(out_rows(d), kMaxThreads / least);
  int tc = 0, group = 0, smem = 0;
  for (int width = kMaxThreads / tr;; --width) {
    if (width < least) return false;
    group = std::min(d.maps, width * kTile / d.fields);
    tc = static_cast<int>(std::max<long long>(kMinSide, ceil_div(group * d.fields, kTile)));
    smem = smem_of(kWeight, tr, tc, group, d);
    if (smem <= card.smem) break;
  }
  const long long cols = cols_of(d), tiles = ceil_div(d.maps, group);
  const long long row_tiles = ceil_div(d.outs, tr * kTile);
  long long best = -1;
  for (int splits = 1; splits <= kMaxSplits; ++splits) {
    const long long span = ceil_div(ceil_div(cols, splits), kDepth) * kDepth;
    if (splits > 1 && span * (splits - 1) >= cols) break;
    const long long cost = ceil_div(tiles * splits * row_tiles, card.sms) * span;
    if (best < 0 || cost < best) {
      best = cost;
      *p = Plan{tr, tc, group, splits, span, smem,
                dim3(static_cast<unsigned>(tiles), splits, static_cast<unsigned>(row_tiles))};
    }
  }
  return true;
}

// a group's rows are all (h, n) of its h's: at least N rows; blocks of 12
// warps or more where any fits
bool plan_input(const Card& card, const Dims& d, Plan* p) {
  constexpr int kBusy = 384;
  const long long cols = cols_of(d);
  double best = -1.0;
  for (int group = 1; group <= d.maps; ++group) {
    const int tr = static_cast<int>(std::max<long long>(
        kMinSide, ceil_div(static_cast<long long>(group) * d.fields, kTile)));
    if (tr > kMaxSide) break;
    const long long groups = ceil_div(d.maps, group);
    for (int tc = kMaxThreads / tr; tc >= kMinSide; --tc) {
      if (best >= 0 && tr * tc < kBusy) break;
      const int smem = smem_of(kInput, tr, tc, group, d);
      const long long col_tiles = ceil_div(cols, tc * kTile);
      if (smem > card.smem || col_tiles > 0x7fffffffLL) continue;
      const double cost =
          static_cast<double>(ceil_div(col_tiles, card.sms)) * groups * tr * tc;
      if (best < 0 || cost < best) {
        best = cost;
        *p = Plan{tr, tc, group, 1, 0, smem, dim3(static_cast<unsigned>(col_tiles), 1, 1)};
      }
    }
  }
  return best >= 0;
}

// The three plans at these shapes, or cudaErrorInvalidConfiguration where
// no tiling of one fits the card.
cudaError_t plans_of(const Dims& d, Plan* forward, Plan* input, Plan* weight) {
  Card card;
  const cudaError_t err = card_of(&card);
  if (err != cudaSuccess) return err;
  if (!plan_forward(card, d, forward) || !plan_input(card, d, input) ||
      !plan_weight(card, d, weight))
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// a kernel allowed the plan's dynamic shared memory
cudaError_t allow(const void* kernel, const Plan& p) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
}

Dims dims_of(long long batch, int fields, int embed, int maps, int outs, long long xk_sb,
             long long xk_sh) {
  return Dims{batch, fields, embed, maps, outs, xk_sb, xk_sh};
}

}  // namespace

extern "C" {

// Floats of scratch that trs_cin_forward (backward 0: W^T, H*N rows of O
// rounded up to 4) or trs_cin_backward (backward 1: G^T, B*E such rows, then
// the weight gradient's partials where its plan splits the columns) needs,
// or minus the CUDA error (cudaErrorInvalidConfiguration: no tiling fits the
// card).
long long trs_cin_scratch(int backward, long long batch, int fields, int embed, int maps,
                          int outs) {
  const Dims d = dims_of(batch, fields, embed, maps, outs, 0, 0);
  Plan pf, pi, pw;
  const cudaError_t err = plans_of(d, &pf, &pi, &pw);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long rows = backward ? cols_of(d) : depth_of(d);
  const long long partials = backward && pw.splits > 1 ? pw.splits * outs * depth_of(d) : 0;
  return rows * padded_outs(outs) + partials;
}

// The plans as text (threads along rows x columns, group, splits, blocks,
// dynamic shared bytes), for a reader of the kernels' times; 0 or the CUDA
// error.
int trs_cin_plans(long long batch, int fields, int embed, int maps, int outs, char* text,
                  int size) {
  Plan p[3];
  const cudaError_t err =
      plans_of(dims_of(batch, fields, embed, maps, outs, 0, 0), &p[0], &p[1], &p[2]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const char* names[] = {"forward", "input", "weight"};
  int at = 0;
  for (int i = 0; i < 3 && at < size; ++i)
    at += std::snprintf(text + at, size - at,
                        "%s%s %dx%d threads group %d splits %d blocks %u shared %d", i ? "; " : "",
                        names[i], p[i].tr, p[i].tc, p[i].group, p[i].splits,
                        p[i].grid.x * p[i].grid.y * p[i].grid.z, p[i].smem);
  return 0;
}

// out: (B, O, E); x0: (B, N, E); xk: (B, H, E) at strides (xk_sb, xk_sh, 1);
// w: (O, H, N); scratch: trs_cin_scratch(0, ...) floats, 16-byte aligned.
int trs_cin_forward(const float* x0, const float* xk, const float* w, float* scratch, float* out,
                    long long batch, int fields, int embed, int maps, int outs, long long xk_sb,
                    long long xk_sh, void* stream) {
  const Dims d = dims_of(batch, fields, embed, maps, outs, xk_sb, xk_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p, pi, pw;
  cudaError_t err = plans_of(d, &p, &pi, &pw);
  if (err == cudaSuccess) err = allow(reinterpret_cast<const void*>(cin_forward_kernel), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int depth = static_cast<int>(depth_of(d)), op = padded_outs(outs);
  const dim3 tiles(static_cast<unsigned>(ceil_div(depth, kTransposeSide)),
                   static_cast<unsigned>(ceil_div(op, kTransposeSide)), 1);
  cin_transpose_kernel<<<tiles, dim3(kTransposeSide, 8), 0, s>>>(w, scratch, 1, outs, depth, op);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const ForwardArgs a{x0,          xk, scratch, out, d, p.tr, p.tc, slots_of(d), op,
                      fast_div(p.tr * kTile / 4), fast_div(fields)};
  cin_forward_kernel<<<p.grid, p.tr * p.tc, p.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// grad: (B, O, E), the gradient of the forward's out; dx0: (B, N, E); dxk:
// (B, H, E) packed; dw: (O, H, N); scratch: trs_cin_scratch(1, ...) floats,
// 16-byte aligned.
int trs_cin_backward(const float* grad, const float* x0, const float* xk, const float* w,
                     float* dx0, float* dxk, float* dw, float* scratch, long long batch,
                     int fields, int embed, int maps, int outs, long long xk_sb, long long xk_sh,
                     void* stream) {
  const Dims d = dims_of(batch, fields, embed, maps, outs, xk_sb, xk_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan pf, pi, pw;
  cudaError_t err = plans_of(d, &pf, &pi, &pw);
  if (err == cudaSuccess) err = allow(reinterpret_cast<const void*>(cin_backward_input_kernel), pi);
  if (err == cudaSuccess)
    err = allow(reinterpret_cast<const void*>(cin_backward_weight_kernel), pw);
  if (err != cudaSuccess) return static_cast<int>(err);
  const InputArgs ia{grad, x0, xk, w, dx0, dxk, d, pi.tr, pi.tc, pi.group,
                     fast_div(pi.tc * kTile)};
  cin_backward_input_kernel<<<pi.grid, pi.tr * pi.tc, pi.smem, s>>>(ia);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int op = padded_outs(outs);
  float* const gt = scratch;
  float* const partials = scratch + cols_of(d) * op;
  const dim3 tiles(static_cast<unsigned>(ceil_div(embed, kTransposeSide)),
                   static_cast<unsigned>(ceil_div(op, kTransposeSide)),
                   static_cast<unsigned>(std::min<long long>(batch, 65535)));
  cin_transpose_kernel<<<tiles, dim3(kTransposeSide, 8), 0, s>>>(grad, gt, batch, outs, embed,
                                                                  op);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const WeightArgs wa{gt,       x0,    xk,    pw.splits > 1 ? partials : dw,
                      d,        pw.tr, pw.tc, pw.group,
                      pw.span,  op,    fast_div(pw.tr * kTile / 4)};
  cin_backward_weight_kernel<<<pw.grid, pw.tr * pw.tc, pw.smem, s>>>(wa);
  err = cudaGetLastError();
  if (err != cudaSuccess || pw.splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(outs) * depth_of(d);
  cin_weight_grad_sum_kernel<<<static_cast<unsigned>(ceil_div(n, kSumThreads)), kSumThreads, 0,
                               s>>>(partials, dw, n, pw.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

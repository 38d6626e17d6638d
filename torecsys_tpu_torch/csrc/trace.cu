// The stamp kernel of the port's tracer: the card's global timer written into
// one int64 slot.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes by torecsys_tpu_torch/ops/kernels/trace.py, which also holds the
// plain version (the host's time.perf_counter_ns, for a slot on the CPU).
// The entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError().
//
// It replaces no TPU kernel: the JAX package reads its steps' stages from
// XLA's profiler alone.  It is added because inside a replay of the K-step
// CUDA graph no host code runs, so the edges of the train step's stages can
// only be read on the card: torecsys_tpu_torch/utils/trace.py launches it at
// each mark of the step, and the graph captures the launches with the step.
//
// Bound on this card: the launch.  One thread reads %globaltimer (ns) and
// stores 8 bytes; it reads nothing.  In stream order it starts after the work
// enqueued before it has finished and before the work enqueued after it
// starts, so its value is the moment the stream reached it.  Design: the
// least work there is, one block of one thread.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

}  // namespace

extern "C" {

// slot: one int64 on the card, 8-byte aligned.
int trs_trace_stamp(void* slot, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slot));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

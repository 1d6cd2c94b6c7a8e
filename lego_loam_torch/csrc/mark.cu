// Span marks: the device time at the boundaries of the pipeline's frame
// steps, taken inside the steps (and so inside their CUDA graphs).
//
// Replaces no TPU kernel: the JAX package times its stages on the host.
// A graphed step is one host call that runs thousands of kernels, so a host
// span around it times the enqueue; a mark is a device operation in the
// step's stream order instead, and runs at every replay with no host read.
//
// Each boundary has a kernel of its own, so a device trace names it:
// lego_span_front_end, lego_span_odometry, lego_span_mapping and
// lego_span_step_end. Each is one thread that writes %globaltimer (ns, the
// card's global clock) into out[slot]. It does none of the pipeline's work
// and is bound by its launch alone (~1-2 us).

#include <cuda_runtime.h>

static __device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

extern "C" __global__ void lego_span_front_end(long long* out, int slot) { out[slot] = global_ns(); }
extern "C" __global__ void lego_span_odometry(long long* out, int slot) { out[slot] = global_ns(); }
extern "C" __global__ void lego_span_mapping(long long* out, int slot) { out[slot] = global_ns(); }
extern "C" __global__ void lego_span_step_end(long long* out, int slot) { out[slot] = global_ns(); }

// boundary: 0 front_end, 1 odometry, 2 mapping, 3 step_end
// (`utils/profiling.BOUNDARIES`).
extern "C" int span_mark_launch(int boundary, void* out, int slot, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* p = static_cast<long long*>(out);
  switch (boundary) {
    case 0: lego_span_front_end<<<1, 1, 0, st>>>(p, slot); break;
    case 1: lego_span_odometry<<<1, 1, 0, st>>>(p, slot); break;
    case 2: lego_span_mapping<<<1, 1, 0, st>>>(p, slot); break;
    case 3: lego_span_step_end<<<1, 1, 0, st>>>(p, slot); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Device stage stamps of runtime/trace.py: one thread reads the card's
// nanosecond clock (%globaltimer) and writes it into a ring of int64 stamps,
// (rows, cols), at row frame % rows and column col.
//
// It replaces no TPU kernel: the reference traces its jitted step with
// jax.profiler from outside, while a CUDA graph replay shows a profiler no
// stage boundaries, so the captured step stamps its own. Bound: the launch
// (~2-3 us of device time a stamp, one global store); the ring is drained by
// an asynchronous copy every rows / 2 frames, so nothing on the frame path
// waits for it.
//
// The frame is read on the device from the packed frame's float32 header
// index (frame_f) where it is given, so a graph replay stamps the frame it
// runs with nothing from the host; otherwise it is the host's frame value.
// With clear, the row is zeroed first (the step's first stamp), so a row
// holds only its own frame's stamps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void trace_stamp_kernel(long long* ring, const float* frame_f, long long frame,
                                   int rows, int cols, int col, int clear) {
  const long long t = global_ns();
  const long long f = frame_f != nullptr ? static_cast<long long>(*frame_f) : frame;
  const long long r = ((f % rows) + rows) % rows;
  long long* row = ring + r * cols;
  if (clear) {
    for (int c = 0; c < cols; ++c) row[c] = 0;
  }
  row[col] = t;
}

}  // namespace

// ring: int64 (rows, cols), contiguous; frame_f: a float32 frame index on
// the device or null (then frame is used). Returns a cudaError_t.
extern "C" int o3r_trace_stamp(void* ring, const void* frame_f, long long frame, int rows,
                               int cols, int col, int clear, void* stream) {
  if (rows < 1 || cols < 1 || col < 0 || col >= cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<const float*>(frame_f), frame, rows, cols,
      col, clear);
  return static_cast<int>(cudaGetLastError());
}

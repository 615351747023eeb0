// Speckle-filter run totals, for Hopper (sm_90a).
//
// Replaces: online_3d_reconstruction_tpu/stereo/sgm_pallas.py::_run_total_kernel
// (driven by _run_total_call -> speckle_filter_pallas). For every pixel it
// computes the sum of v over the pixel's maximal run along one axis: a
// segmented inclusive forward scan from the start flags, plus a segmented
// inclusive backward scan from the end flags (a run ends where the next
// pixel starts one, and at the last pixel), minus the pixel itself. The TPU
// kernel holds the whole frame in VMEM and runs unrolled Hillis-Steele
// sweeps over it; here each line is scanned on its own.
//
// What bounds it on the H100: per call it reads v and the start flags and
// writes the output, then reads the output back once, 4 x 4 bytes per pixel:
// 3.1 MB at 384x512, ~12.6 MB for the four calls of a frame: ~4 us at
// 3.35 TB/s. With one line per warp or per thread there are only 384-512
// independent chains, so like the SGM scan it is bound by latency.
//
// Design: along a row (axis 1) one warp walks the row in chunks of 32 with a
// segmented shuffle scan and carries the running sum from chunk to chunk;
// along a column (axis 0) one thread walks the column, so neighbouring
// threads read neighbouring addresses. The values are integers (pixel counts)
// below 2^24, so every f32 sum is exact and the result does not depend on
// the order of the additions: it is bit-equal to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) run_total_rows_kernel(
    const float* __restrict__ v, const float* __restrict__ start,
    float* __restrict__ out, int h, int w) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= h) return;  // uniform across the warp
  const float* vr = v + (long long)row * w;
  const float* sr = start + (long long)row * w;
  float* outr = out + (long long)row * w;

  // forward: inclusive sum since the latest start flag
  float carry = 0.f;
  for (int c0 = 0; c0 < w; c0 += 32) {
    const int i = c0 + lane;
    float s = i < w ? vr[i] : 0.f;
    int seg = i < w ? (sr[i] > 0.5f) : 1;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const float sv = __shfl_up_sync(kFullMask, s, k);
      const int sf = __shfl_up_sync(kFullMask, seg, k);
      if (lane >= k) {
        if (!seg) s += sv;
        seg |= sf;
      }
    }
    if (!seg) s += carry;
    carry = __shfl_sync(kFullMask, s, 31);
    if (i < w) outr[i] = s;
  }

  // backward: inclusive sum up to the run's end, then fwd + bwd - v
  carry = 0.f;
  for (int c0 = ((w - 1) / 32) * 32; c0 >= 0; c0 -= 32) {
    const int i = c0 + lane;
    const float vi = i < w ? vr[i] : 0.f;
    float s = vi;
    int seg = i < w ? (i == w - 1 || sr[i + 1] > 0.5f) : 1;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const float sv = __shfl_down_sync(kFullMask, s, k);
      const int sf = __shfl_down_sync(kFullMask, seg, k);
      if (lane + k < 32) {
        if (!seg) s += sv;
        seg |= sf;
      }
    }
    if (!seg) s += carry;
    carry = __shfl_sync(kFullMask, s, 0);
    if (i < w) outr[i] = outr[i] + s - vi;
  }
}

__global__ void __launch_bounds__(kThreads) run_total_cols_kernel(
    const float* __restrict__ v, const float* __restrict__ start,
    float* __restrict__ out, int h, int w) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= w) return;
  float acc = 0.f;
  for (int i = 0; i < h; ++i) {
    const long long p = (long long)i * w + col;
    const float vi = v[p];
    acc = start[p] > 0.5f ? vi : acc + vi;
    out[p] = acc;
  }
  acc = 0.f;
  for (int i = h - 1; i >= 0; --i) {
    const long long p = (long long)i * w + col;
    const float vi = v[p];
    const bool run_end = i == h - 1 || start[p + w] > 0.5f;
    acc = run_end ? vi : acc + vi;
    out[p] = out[p] + acc - vi;
  }
}

}  // namespace

// out (H, W) = run totals of v (H, W) along ``axis`` (0: columns, 1: rows)
// with runs split at start (H, W) flags > 0.5. All float32, contiguous.
// Returns a cudaError_t.
extern "C" int o3r_run_total(const void* v, const void* start, void* out,
                             int h, int w, int axis, void* stream) {
  const auto* vp = static_cast<const float*>(v);
  const auto* sp = static_cast<const float*>(start);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    const int blocks = (h * 32 + kThreads - 1) / kThreads;
    run_total_rows_kernel<<<blocks, kThreads, 0, s>>>(vp, sp, op, h, w);
  } else if (axis == 0) {
    const int blocks = (w + kThreads - 1) / kThreads;
    run_total_cols_kernel<<<blocks, kThreads, 0, s>>>(vp, sp, op, h, w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

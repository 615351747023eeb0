// SGM path aggregation along one scan direction, for Hopper (sm_90a).
//
// Replaces: online_3d_reconstruction_tpu/stereo/sgm_pallas.py::_multi_kernel
// (driven by _one_call -> scan_multi -> aggregate_fused). That kernel runs
// the recurrence
//     L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1, min_k L(p-r, k) + P2)
//               - min_k L(p-r, k)
// for the vertical direction and both diagonals at once, on the TPU's
// (S, D, L) layout with lane-shifted carries. Here each direction is one
// launch over a set of independent scan lines (rows, columns, or one of the
// two diagonal families); a line starts at an image edge with a zero carry,
// which is exactly what the zero-filled +-1 carry shift gives on the TPU.
//
// What bounds it on the H100: every direction reads the uint8 cost volume
// once and read-modify-writes the f32 total once, 5 bytes per cell. At
// 384x512xD64 that is 12.6 MB of cost and 50 MB of total per direction,
// ~0.5 GB per frame for 8 paths: ~0.15 ms at 3.35 TB/s. The real bound is
// latency: a line is a chain of dependent steps (384-512 of them), and a
// direction has only 384-895 lines, so a few warps per SM each wait on one
// global load per step.
//
// Design: one warp per scan line, disparities across the lanes
// (ceil(D/32) consecutive disparities per lane), min_k by a butterfly
// shuffle reduction, d-1 / d+1 across lane boundaries by one
// __shfl_up_sync / __shfl_down_sync each, with the 1e9 edge the TPU kernel
// uses at d = 0 and d = D-1. Within one launch every pixel lies on exactly
// one line, so the += into the total is race-free; the launches of a frame
// run in order on one stream. Integer costs and integer P1, P2 keep every
// value an integer below 2^24, so the f32 result is bit-equal to the plain
// version whatever the order of the launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fminf(v, __shfl_xor_sync(kFullMask, v, offset));
  }
  return v;
}

// First pixel of scan line ``line`` for direction (dy, dx). Diagonal lines
// start on the row the direction enters from (W lines) and then on the
// column it enters from (H - 1 more lines).
__device__ __forceinline__ void line_start(int line, int h, int w, int dy,
                                           int dx, int* y, int* x) {
  if (dy == 0) {
    *y = line;
    *x = dx > 0 ? 0 : w - 1;
  } else if (dx == 0 || line < w) {
    *y = dy > 0 ? 0 : h - 1;
    *x = line;
  } else {
    const int k = line - w + 1;
    *y = dy > 0 ? k : h - 1 - k;
    *x = dx > 0 ? 0 : w - 1;
  }
}

template <int VPT>
__global__ void __launch_bounds__(kThreads) sgm_path_kernel(
    const uint8_t* __restrict__ cost, float* __restrict__ total, int h, int w,
    int d, int dy, int dx, float p1, float p2, int n_lines) {
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (line >= n_lines) return;  // uniform across the warp
  int y, x;
  line_start(line, h, w, dy, dx, &y, &x);

  const int d0 = lane * VPT;
  float carry[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) carry[j] = (d0 + j < d) ? 0.f : kBig;

  const long long step = ((long long)dy * w + dx) * d;
  long long base = ((long long)y * w + x) * d;
  while (y >= 0 && y < h && x >= 0 && x < w) {
    float m = carry[0];
#pragma unroll
    for (int j = 1; j < VPT; ++j) m = fminf(m, carry[j]);
    m = warp_min(m);
    float lo = __shfl_up_sync(kFullMask, carry[VPT - 1], 1);
    float hi = __shfl_down_sync(kFullMask, carry[0], 1);
    if (lane == 0) lo = kBig;
    if (lane == 31) hi = kBig;

    float next[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float dm = (j == 0 ? lo : carry[j - 1]) + p1;
      const float dp = (j == VPT - 1 ? hi : carry[j + 1]) + p1;
      const float best = fminf(fminf(carry[j], m + p2), fminf(dm, dp));
      if (d0 + j < d) {
        const long long at = base + d0 + j;
        const float v = static_cast<float>(cost[at]) + best - m;
        total[at] += v;
        next[j] = v;
      } else {
        next[j] = kBig;  // padding lanes never win a min
      }
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) carry[j] = next[j];
    y += dy;
    x += dx;
    base += step;
  }
}

template <int VPT>
cudaError_t launch(const uint8_t* cost, float* total, int h, int w, int d,
                   int dy, int dx, float p1, float p2, cudaStream_t stream) {
  const int n_lines = dy == 0 ? h : (dx == 0 ? w : h + w - 1);
  const int blocks = (n_lines * 32 + kThreads - 1) / kThreads;
  sgm_path_kernel<VPT><<<blocks, kThreads, 0, stream>>>(
      cost, total, h, w, d, dy, dx, p1, p2, n_lines);
  return cudaGetLastError();
}

}  // namespace

// Adds direction (dy, dx)'s aggregation of cost (H, W, D) uint8 into
// total (H, W, D) float32. D is at most 256. Returns a cudaError_t.
extern "C" int o3r_sgm_path(const void* cost, void* total, int h, int w,
                            int d, int dy, int dx, float p1, float p2,
                            void* stream) {
  const auto* c = static_cast<const uint8_t*>(cost);
  auto* t = static_cast<float*>(total);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 31) / 32) {
    case 1: return launch<1>(c, t, h, w, d, dy, dx, p1, p2, s);
    case 2: return launch<2>(c, t, h, w, d, dy, dx, p1, p2, s);
    case 3: return launch<3>(c, t, h, w, d, dy, dx, p1, p2, s);
    case 4: return launch<4>(c, t, h, w, d, dy, dx, p1, p2, s);
    case 5: return launch<5>(c, t, h, w, d, dy, dx, p1, p2, s);
    case 6: return launch<6>(c, t, h, w, d, dy, dx, p1, p2, s);
    case 7: return launch<7>(c, t, h, w, d, dy, dx, p1, p2, s);
    case 8: return launch<8>(c, t, h, w, d, dy, dx, p1, p2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* o3r_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

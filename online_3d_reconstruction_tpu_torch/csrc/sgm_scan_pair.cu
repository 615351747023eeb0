// Single-direction SGM scan pair (forward + backward along axis 0 of an
// (S, L, D) volume), for Hopper (sm_90a).
//
// Replaces: online_3d_reconstruction_tpu/stereo/sgm_pallas.py::_fwd_kernel
// and ::_bwd_kernel (both driven by scan_pair). The forward kernel runs the
// SGM recurrence
//     L(s, d) = C(s, d) + min(L(s-1, d), L(s-1, d+-1) + P1, min_k L(s-1, k) + P2)
//               - min_k L(s-1, k)
// down every line l from s = 0 with a zero carry, and stores each step in the
// storage dtype (f32 or bf16) while the carry stays f32. The backward kernel
// runs the same recurrence from s = S-1 up, adds its f32 carry to the
// forward result it reads, and stores the sum, rounded to the storage dtype,
// over that same buffer (the TPU kernel aliases input 0 to output 0). The TPU
// pads S and L up to its BlockSpec tiles, which zero costs leave neutral;
// here nothing is padded: the grid covers exactly L lines and every lane
// past D is masked.
//
// What bounds it on the H100: each pass reads the cost once and writes the
// output once (the backward pass also reads the forward result), 8-12 bytes
// per f32 cell: ~38 MB at 384x512x64 for the pair, ~11 us at 3.35 TB/s. The
// real bound is latency, as for K1 (csrc/sgm_aggregate.cu): a line is a
// chain of S dependent steps (384 at the profiler's shape), each a min over
// D across the warp, and there are only L = 512 lines, so each SM holds a
// few warps that each wait on one global load per step.
//
// Design: one warp per line, disparities across the lanes (ceil(D/32)
// consecutive disparities per lane), min over D by a butterfly shuffle,
// d-1 / d+1 across lane boundaries by one __shfl_up_sync / __shfl_down_sync
// each with the TPU kernel's 1e9 edge; lanes past D hold 1e9 so they never
// win a min. Against the latency, each step's cost row is loaded one step
// ahead, so the load of step s+1 is in flight while step s computes. The
// arithmetic is the reference's _step in its order (cost + best - min_prev,
// all f32) and the two roundings to the storage dtype sit where the TPU
// kernel has them, so integer costs give the plain version's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fminf(v, __shfl_xor_sync(kFullMask, v, offset));
  }
  return v;
}

// This lane's VPT costs of one line at one step, as f32 (0 past D).
template <typename T, int VPT>
__device__ __forceinline__ void load_costs(const T* row, int d0, int d,
                                           float (&c)[VPT]) {
#pragma unroll
  for (int j = 0; j < VPT; ++j) c[j] = (d0 + j < d) ? to_f32(row[d0 + j]) : 0.f;
}

// One recurrence step of the whole line, carry updated in place.
template <int VPT>
__device__ __forceinline__ void sgm_step(float (&carry)[VPT],
                                         const float (&c)[VPT], float p1,
                                         float p2, int lane, int d0, int d) {
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
    next[j] = (d0 + j < d) ? c[j] + best - m : kBig;
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) carry[j] = next[j];
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads) scan_fwd_kernel(
    const T* __restrict__ cost, T* __restrict__ out, int s_len, int l_len,
    int d, float p1, float p2) {
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (line >= l_len) return;  // uniform across the warp
  const int d0 = lane * VPT;
  const long long step = (long long)l_len * d;
  long long base = (long long)line * d;

  float carry[VPT], c[VPT], c_next[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) carry[j] = (d0 + j < d) ? 0.f : kBig;
  load_costs<T, VPT>(cost + base, d0, d, c_next);
  for (int s = 0; s < s_len; ++s) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) c[j] = c_next[j];
    if (s + 1 < s_len) load_costs<T, VPT>(cost + base + step, d0, d, c_next);
    sgm_step<VPT>(carry, c, p1, p2, lane, d0, d);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (d0 + j < d) out[base + d0 + j] = from_f32<T>(carry[j]);
    }
    base += step;
  }
}

// ``acc`` and ``out`` may be one buffer: each element is read, then written,
// by the same thread.
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads) scan_bwd_kernel(
    const T* __restrict__ cost, const T* acc, T* out, int s_len, int l_len,
    int d, float p1, float p2) {
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (line >= l_len) return;  // uniform across the warp
  const int d0 = lane * VPT;
  const long long step = (long long)l_len * d;
  long long base = (long long)(s_len - 1) * step + (long long)line * d;

  float carry[VPT], c[VPT], c_next[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) carry[j] = (d0 + j < d) ? 0.f : kBig;
  load_costs<T, VPT>(cost + base, d0, d, c_next);
  for (int s = s_len - 1; s >= 0; --s) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) c[j] = c_next[j];
    if (s > 0) load_costs<T, VPT>(cost + base - step, d0, d, c_next);
    float fwd[VPT];
    load_costs<T, VPT>(acc + base, d0, d, fwd);
    sgm_step<VPT>(carry, c, p1, p2, lane, d0, d);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (d0 + j < d) out[base + d0 + j] = from_f32<T>(fwd[j] + carry[j]);
    }
    base -= step;
  }
}

template <typename T, int VPT>
cudaError_t launch(bool backward, const void* cost, void* out, int s, int l,
                   int d, float p1, float p2, cudaStream_t stream) {
  const int blocks = (l * 32 + kThreads - 1) / kThreads;
  const T* c = static_cast<const T*>(cost);
  T* o = static_cast<T*>(out);
  if (backward) {
    scan_bwd_kernel<T, VPT><<<blocks, kThreads, 0, stream>>>(c, o, o, s, l, d,
                                                             p1, p2);
  } else {
    scan_fwd_kernel<T, VPT><<<blocks, kThreads, 0, stream>>>(c, o, s, l, d,
                                                             p1, p2);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(bool backward, const void* cost, void* out, int s, int l, int d,
             float p1, float p2, cudaStream_t st) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(backward, cost, out, s, l, d, p1, p2, st);
    case 2: return launch<T, 2>(backward, cost, out, s, l, d, p1, p2, st);
    case 3: return launch<T, 3>(backward, cost, out, s, l, d, p1, p2, st);
    case 4: return launch<T, 4>(backward, cost, out, s, l, d, p1, p2, st);
    case 5: return launch<T, 5>(backward, cost, out, s, l, d, p1, p2, st);
    case 6: return launch<T, 6>(backward, cost, out, s, l, d, p1, p2, st);
    case 7: return launch<T, 7>(backward, cost, out, s, l, d, p1, p2, st);
    case 8: return launch<T, 8>(backward, cost, out, s, l, d, p1, p2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int scan(bool backward, const void* cost, void* out, int s, int l, int d,
         int dtype, float p1, float p2, void* stream) {
  if (s < 1 || l < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(backward, cost, out, s, l, d, p1, p2, st);
    case 1:
      return dispatch<__nv_bfloat16>(backward, cost, out, s, l, d, p1, p2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Forward scan of cost (S, L, D) into out (S, L, D), both of the storage
// dtype (0: float32, 1: bfloat16). D is at most 256. Returns a cudaError_t.
extern "C" int o3r_scan_fwd(const void* cost, void* out, int s, int l, int d,
                            int dtype, float p1, float p2, void* stream) {
  return scan(false, cost, out, s, l, d, dtype, p1, p2, stream);
}

// Backward scan of cost (S, L, D), added in place into the forward result
// ``acc_out`` (S, L, D) of the same storage dtype. Returns a cudaError_t.
extern "C" int o3r_scan_bwd(const void* cost, void* acc_out, int s, int l,
                            int d, int dtype, float p1, float p2,
                            void* stream) {
  return scan(true, cost, acc_out, s, l, d, dtype, p1, p2, stream);
}

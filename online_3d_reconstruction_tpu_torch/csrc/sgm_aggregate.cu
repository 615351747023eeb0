// SGM path aggregation over all scan directions at once, for Hopper (sm_90a).
//
// Replaces: online_3d_reconstruction_tpu/stereo/sgm_pallas.py::_multi_kernel
// (driven by _one_call -> scan_multi -> aggregate_fused). That kernel runs
// the recurrence
//     L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1, min_k L(p-r, k) + P2)
//               - min_k L(p-r, k)
// for the vertical direction and both diagonals at once, on the TPU's
// (S, D, L) layout with lane-shifted carries, and sums the directions into
// an accumulator. Here a direction is a set of independent scan lines (rows,
// columns, or one of the two diagonal families); a line starts at an image
// edge with a zero carry, which is exactly what the zero-filled +-1 carry
// shift gives on the TPU.
//
// What bounds it on the H100: bytes. The function must read the uint8 cost
// once and write the f32 total once, 5 bytes per cell: 62.9 MB at
// 384x512x64, 0.019 ms at 3.35 TB/s. The recurrence itself is a chain of
// dependent steps along each line (384-512 at that shape, measured ~0.19 us
// each: a shuffle min over the disparities, two neighbour shuffles, four
// fminf), so no design that walks whole lines gets under ~0.1 ms, and the sum
// over 8 directions has to be formed somewhere: here in the 50 MB L2, by
// reductions, whose bytes are what the kernel's time follows once the chains
// overlap.
//
// Design:
// - One launch for all directions. The host makes a table of every scan line
//   of the frame (start pixel, pixel step, length), longest first, uploaded
//   once per (H, W, paths); the 5,372 lines of an 8-path 384x512 frame are
//   all resident at once, so the chains of all directions overlap and the
//   kernel's time tends to the longest chain, not to the sum over directions.
// - Directions meet on the same cell of the total, so a step adds its values
//   with a reduction whose result is unused (RED, resolved in L2). The total
//   is never loaded. With integer costs and integer P1, P2 every path value
//   is an integer <= 255 + P2, so any order gives the plain version's bits.
// - Fewer bytes: where paths * (255 + P2) < 2^16 the sums fit 16 bits, and a
//   lane's four values go out as ONE 64-bit integer reduction into a packed
//   uint16 accumulator (no field can carry into its neighbour). That halves
//   the reduction traffic and makes the accumulator 25 MB at 384x512x64,
//   resident in L2; a second, streaming kernel widens it to the f32 total.
//   Otherwise the values go out as one float4 reduction into the f32 total.
// - Four disparities a lane: one 32-bit cost load and one 16-byte reduction
//   per lane and step. D = 64 takes 16 lanes, so a warp carries two lines and
//   the min over D is 4 shuffle rounds; D = 128 takes the whole warp.
// - The cost is off the dependent chain: a line's address at step s is
//   base + s * step, so each lane keeps the next kPrefetch steps' costs in
//   flight in a register queue and a step waits only for its shuffles.
// - For penalties that are not integers (or too large to pack) the caller
//   launches the float4 form once per direction, in order, over that
//   direction's lines: within one direction every pixel lies on exactly one
//   line, so each cell receives one reduction per launch, the launches are
//   ordered by the stream, and the f32 sum is formed in a fixed order: the
//   same bits from run to run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 64;
constexpr int kPrefetch = 8;  // steps of cost kept in flight per lane

// VPT uint8 costs of one lane: 4 in one 32-bit word, 8 in two.
template <int VPT>
struct CostWords;
template <>
struct CostWords<4> {
  uint32_t w[1];
};
template <>
struct CostWords<8> {
  uint32_t w[2];
};

template <int VPT>
__device__ __forceinline__ CostWords<VPT> load_cost(const uint8_t* p) {
  CostWords<VPT> c;
  if constexpr (VPT == 4) {
    c.w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    c.w[0] = u.x;
    c.w[1] = u.y;
  }
  return c;
}

template <int VPT>
__device__ __forceinline__ float cost_at(const CostWords<VPT>& c, int j) {
  return static_cast<float>((c.w[j >> 2] >> (8 * (j & 3))) & 0xffu);
}

// G lanes per line (a power of two, 2..32), VPT disparities per lane (4 or
// 8): a warp carries 32 / G lines. lines[i] = {first pixel, pixel step,
// length, direction}. PACKED: ``total`` is the uint16 accumulator (four
// cells per 64-bit word), else the f32 total.
template <int G, int VPT, bool PACKED>
__global__ void __launch_bounds__(kThreads) sgm_lines_kernel(
    const uint8_t* __restrict__ cost, void* __restrict__ total,
    const int4* __restrict__ lines, int n_lines, int d, float p1, float p2) {
  constexpr int kLinesPerWarp = 32 / G;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp * kLinesPerWarp >= n_lines) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // lane within the line's group
  const int line = warp * kLinesPerWarp + lane / G;
  const int4 ln = line < n_lines ? __ldg(lines + line) : make_int4(0, 0, 0, 0);
  const int len = ln.z;
  int max_len = len;  // the longest line of this warp: its loop count
#pragma unroll
  for (int o = 16; o >= G; o >>= 1) {
    max_len = max(max_len, __shfl_xor_sync(kFullMask, max_len, o));
  }

  const int d0 = gl * VPT;
  const bool in_d = d0 < d;  // D is a multiple of 8: a lane is all in or out
  float carry[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) carry[j] = in_d ? 0.f : kBig;

  const long long step = (long long)ln.y * d;
  long long cell = (long long)ln.x * d + d0;  // this lane's cell at step s

  CostWords<VPT> queue[kPrefetch];
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    queue[k] = CostWords<VPT>{};
    if (in_d && k < len) queue[k] = load_cost<VPT>(cost + cell + k * step);
  }

  for (int s0 = 0; s0 < max_len; s0 += kPrefetch) {
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int s = s0 + k;
      const CostWords<VPT> c = queue[k];
      if (in_d && s + kPrefetch < len) {
        queue[k] = load_cost<VPT>(cost + cell + kPrefetch * step);
      }

      float m = carry[0];
#pragma unroll
      for (int j = 1; j < VPT; ++j) m = fminf(m, carry[j]);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        m = fminf(m, __shfl_xor_sync(kFullMask, m, o));
      }
      float lo = __shfl_up_sync(kFullMask, carry[VPT - 1], 1, G);
      float hi = __shfl_down_sync(kFullMask, carry[0], 1, G);
      if (gl == 0) lo = kBig;
      if (gl == G - 1) hi = kBig;

      float next[VPT];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const float dm = (j == 0 ? lo : carry[j - 1]) + p1;
        const float dp = (j == VPT - 1 ? hi : carry[j + 1]) + p1;
        const float best = fminf(fminf(carry[j], m + p2), fminf(dm, dp));
        next[j] = in_d ? cost_at<VPT>(c, j) + best - m : kBig;
      }
#pragma unroll
      for (int j = 0; j < VPT; ++j) carry[j] = next[j];

      if (in_d && s < len) {
#pragma unroll
        for (int j = 0; j < VPT; j += 4) {
#ifdef O3R_K1_NO_UPDATE  // probe build: the chains without the update
          if (next[j] == -1.f) static_cast<float*>(total)[0] = 0.f;
#else
          // results unused: reductions, no round trip
          if constexpr (PACKED) {
            const unsigned long long packed =
                (unsigned long long)(unsigned)next[j] |
                (unsigned long long)(unsigned)next[j + 1] << 16 |
                (unsigned long long)(unsigned)next[j + 2] << 32 |
                (unsigned long long)(unsigned)next[j + 3] << 48;
            atomicAdd(static_cast<unsigned long long*>(total) + (cell + j) / 4, packed);
          } else {
            atomicAdd(reinterpret_cast<float4*>(static_cast<float*>(total) + cell + j),
                      make_float4(next[j], next[j + 1], next[j + 2], next[j + 3]));
          }
#endif
        }
      }
      cell += step;
    }
  }
}

template <int G, int VPT>
cudaError_t launch(const uint8_t* cost, void* total, const int4* lines,
                   int n_lines, int d, float p1, float p2, bool packed,
                   cudaStream_t stream) {
  constexpr int kLinesPerBlock = (kThreads / 32) * (32 / G);
  const int blocks = (n_lines + kLinesPerBlock - 1) / kLinesPerBlock;
  if (packed) {
    sgm_lines_kernel<G, VPT, true><<<blocks, kThreads, 0, stream>>>(
        cost, total, lines, n_lines, d, p1, p2);
  } else {
    sgm_lines_kernel<G, VPT, false><<<blocks, kThreads, 0, stream>>>(
        cost, total, lines, n_lines, d, p1, p2);
  }
  return cudaGetLastError();
}

// Widens the packed uint16 accumulator to the f32 total, 8 cells a thread.
__global__ void __launch_bounds__(256) unpack16_kernel(
    const uint4* __restrict__ acc, float4* __restrict__ total, long long n8) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const uint4 a = __ldg(acc + i);
  total[2 * i] = make_float4(a.x & 0xffffu, a.x >> 16, a.y & 0xffffu, a.y >> 16);
  total[2 * i + 1] = make_float4(a.z & 0xffffu, a.z >> 16, a.w & 0xffffu, a.w >> 16);
}

}  // namespace

// Adds the aggregation of cost (H*W, D) uint8 along the n_lines scan lines
// of ``lines`` (int32 x 4 each: first pixel, pixel step, length, direction)
// into ``total`` by reductions: the lines may cross. packed = 0: total is
// (H*W, D) float32. packed = 1: total is the (H*W, D) uint16 accumulator;
// the caller guarantees integer penalties and sums below 2^16. D is a
// multiple of 8 in [8, 256]. Returns a cudaError_t.
extern "C" int o3r_sgm_aggregate(const void* cost, void* total,
                                 const void* lines, int n_lines, int d,
                                 float p1, float p2, int packed, void* stream) {
  const auto* c = static_cast<const uint8_t*>(cost);
  const auto* l = static_cast<const int4*>(lines);
  auto s = static_cast<cudaStream_t>(stream);
  const bool k = packed != 0;
  if (n_lines < 1 || d < 8 || d > 256 || d % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d > 128) return launch<32, 8>(c, total, l, n_lines, d, p1, p2, k, s);
  if (d > 64) return launch<32, 4>(c, total, l, n_lines, d, p1, p2, k, s);
  if (d > 32) return launch<16, 4>(c, total, l, n_lines, d, p1, p2, k, s);
  if (d > 16) return launch<8, 4>(c, total, l, n_lines, d, p1, p2, k, s);
  if (d > 8) return launch<4, 4>(c, total, l, n_lines, d, p1, p2, k, s);
  return launch<2, 4>(c, total, l, n_lines, d, p1, p2, k, s);
}

// total (n,) float32 = acc (n,) uint16, n a multiple of 8, both 16-byte
// aligned. Returns a cudaError_t.
extern "C" int o3r_sgm_unpack16(const void* acc, void* total, long long n,
                                void* stream) {
  if (n < 8 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = n / 8;
  const unsigned blocks = static_cast<unsigned>((n8 + 255) / 256);
  unpack16_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(acc), static_cast<float4*>(total), n8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* o3r_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

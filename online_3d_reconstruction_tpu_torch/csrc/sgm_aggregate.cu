// SGM path aggregation over all scan directions at once, for Hopper (sm_90a).
//
// Replaces: online_3d_reconstruction_tpu/stereo/sgm_pallas.py::_multi_kernel
// (driven by _one_call -> scan_multi -> aggregate_fused), in both of its
// storage dtypes. That kernel runs the recurrence
//     L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1, min_k L(p-r, k) + P2)
//               - min_k L(p-r, k)
// for the vertical direction and both diagonals at once, on the TPU's
// (S, D, L) layout with lane-shifted carries, and sums the directions into
// an accumulator. Here a direction is a set of independent scan lines (rows,
// columns, or one of the two diagonal families); a line starts at an image
// edge with a zero carry, which is exactly what the zero-filled +-1 carry
// shift gives on the TPU.
//
// What bounds it on the H100: bytes. The f32 form must read the uint8 cost
// once and write the f32 total once, 5 bytes per cell: 62.9 MB at
// 384x512x64, 0.019 ms at 3.35 TB/s; the bf16 form writes a bf16 total, 3
// bytes per cell: 37.7 MB, 0.0113 ms. The recurrence itself is a chain of
// dependent steps along each line (384-512 at that shape, measured ~0.19 us
// each: a shuffle min over the disparities, two neighbour shuffles, four
// fminf), so no design that walks whole lines gets under ~0.1 ms, and the sum
// over 8 directions has to be formed somewhere: here in the 50 MB L2, by
// reductions, whose bytes are what the kernel's time follows once the chains
// overlap.
//
// Design:
// - One launch for all directions. The host makes a table of every scan line
//   of the frame (start pixel, pixel step, length, direction), longest first,
//   uploaded once per (H, W, paths); the 5,372 lines of an 8-path 384x512
//   frame are all resident at once, so the chains of all directions overlap
//   and the kernel's time tends to the longest chain, not to the sum over
//   directions.
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
// - The bf16 form keeps the TPU kernel's four roundings: it stores each
//   partial total in bf16, after the forward horizontal direction (group 0),
//   the backward one (1), the forward vertical and diagonals (2) and the
//   backward ones (3): bf16(bf16(bf16(bf16(g0) + g1) + g2) + g3). With
//   integer sums it is the packed launch into a group-major accumulator
//   (groups x H x W x D uint16; a line's direction names its group): groups 0
//   and 1 hold one value a cell, written by a plain 64-bit store, groups 2
//   and 3 the sum of up to three directions, by 64-bit reductions. A second,
//   streaming kernel reads the groups' sums and applies the four roundings.
//   Otherwise the ordered float4 form adds the directions into an f32 total
//   group by group, in the TPU kernel's order, and a rounding kernel stores
//   each group's partial total through bf16 (the last one as the bf16 total):
//   the f32 additions are the TPU kernel's own, in its order.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 64;
constexpr int kPrefetch = 8;  // steps of cost kept in flight per lane

// where a step's values go: the f32 total (float4 reductions), the packed
// uint16 accumulator (64-bit reductions), or the bf16 form's group-major
// uint16 accumulator (64-bit stores for groups 0 and 1, reductions for 2, 3)
enum Mode { kF32 = 0, kPacked = 1, kGroups = 2 };

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
// length, direction}. MODE kPacked: ``total`` is the uint16 accumulator
// (four cells per 64-bit word); kGroups: the group-major uint16 accumulator,
// ``plane`` cells a group; kF32: the f32 total.
template <int G, int VPT, int MODE>
__global__ void __launch_bounds__(kThreads) sgm_lines_kernel(
    const uint8_t* __restrict__ cost, void* __restrict__ total,
    const int4* __restrict__ lines, int n_lines, int d, float p1, float p2,
    long long plane) {
  constexpr int kLinesPerWarp = 32 / G;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp * kLinesPerWarp >= n_lines) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // lane within the line's group
  const int line = warp * kLinesPerWarp + lane / G;
  const int4 ln = line < n_lines ? __ldg(lines + line) : make_int4(0, 0, 0, 0);
  const int len = ln.z;
  // the bf16 form's group of this line's direction (DIRECTIONS order)
  const int group = ln.w < 2 ? ln.w : 2 + (ln.w & 1);
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
          if constexpr (MODE != kF32) {
            const unsigned long long packed =
                (unsigned long long)(unsigned)next[j] |
                (unsigned long long)(unsigned)next[j + 1] << 16 |
                (unsigned long long)(unsigned)next[j + 2] << 32 |
                (unsigned long long)(unsigned)next[j + 3] << 48;
            unsigned long long* word =
                static_cast<unsigned long long*>(total) + (cell + j) / 4;
            if constexpr (MODE == kGroups) {
              word += group * (plane / 4);
              // one line of a direction per cell: groups 0 and 1 are stored
              if (group < 2) {
                *word = packed;
                continue;
              }
            }
            atomicAdd(word, packed);
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
                   int n_lines, int d, float p1, float p2, int mode,
                   long long plane, cudaStream_t stream) {
  constexpr int kLinesPerBlock = (kThreads / 32) * (32 / G);
  const int blocks = (n_lines + kLinesPerBlock - 1) / kLinesPerBlock;
  if (mode == kGroups) {
    sgm_lines_kernel<G, VPT, kGroups><<<blocks, kThreads, 0, stream>>>(
        cost, total, lines, n_lines, d, p1, p2, plane);
  } else if (mode == kPacked) {
    sgm_lines_kernel<G, VPT, kPacked><<<blocks, kThreads, 0, stream>>>(
        cost, total, lines, n_lines, d, p1, p2, plane);
  } else {
    sgm_lines_kernel<G, VPT, kF32><<<blocks, kThreads, 0, stream>>>(
        cost, total, lines, n_lines, d, p1, p2, plane);
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

// x rounded to bf16 (to nearest, ties to even) and back to f32: exact
__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float(
      static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(x))) << 16);
}

// The bf16 form's second launch: reads the ``groups`` (2 or 4) group sums of
// 8 cells a thread and writes bf16(bf16(bf16(bf16(g0) + g1) + g2) + g3), the
// TPU kernel's four roundings (two with 2 groups).
__global__ void __launch_bounds__(256) finish_bf16_kernel(
    const uint4* __restrict__ acc, uint4* __restrict__ out, long long n8, int groups) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  unsigned sums[4][4] = {};
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (g < groups) {
      const uint4 a = __ldg(acc + g * n8 + i);
      sums[g][0] = a.x;
      sums[g][1] = a.y;
      sums[g][2] = a.z;
      sums[g][3] = a.w;
    }
  }
  unsigned words[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned word = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int shift = 16 * half;
      float t = round_bf16(static_cast<float>((sums[0][k] >> shift) & 0xffffu));
      t = round_bf16(t + static_cast<float>((sums[1][k] >> shift) & 0xffffu));
      if (groups == 4) {
        t = round_bf16(t + static_cast<float>((sums[2][k] >> shift) & 0xffffu));
        t = round_bf16(t + static_cast<float>((sums[3][k] >> shift) & 0xffffu));
      }
      word |= (__float_as_uint(t) >> 16) << shift;
    }
    words[k] = word;
  }
  out[i] = make_uint4(words[0], words[1], words[2], words[3]);
}

// The ordered bf16 form's rounding: out[i] = bf16(in[i]), as bf16
// (to_bf16) or as its f32 value (in place allowed).
__global__ void __launch_bounds__(256) round_bf16_kernel(
    const float* in, void* out, long long n, int to_bf16) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t = round_bf16(in[i]);
  if (to_bf16) {
    static_cast<unsigned short*>(out)[i] = static_cast<unsigned short>(__float_as_uint(t) >> 16);
  } else {
    static_cast<float*>(out)[i] = t;
  }
}

}  // namespace

// Adds the aggregation of cost (H*W, D) uint8 along the n_lines scan lines
// of ``lines`` (int32 x 4 each: first pixel, pixel step, length, direction)
// into ``total`` by reductions: the lines may cross. mode 0: total is
// (H*W, D) float32. mode 1: total is the (H*W, D) uint16 accumulator; mode
// 2: the bf16 form's (4, H*W, D) uint16 group accumulator, ``plane`` = H*W*D
// cells a group (groups 2 and 3 zeroed by the caller). Modes 1 and 2: the
// caller guarantees integer penalties and sums below 2^16. D is a multiple
// of 8 in [8, 256]. Returns a cudaError_t.
extern "C" int o3r_sgm_aggregate(const void* cost, void* total,
                                 const void* lines, int n_lines, int d,
                                 float p1, float p2, int mode, long long plane,
                                 void* stream) {
  const auto* c = static_cast<const uint8_t*>(cost);
  const auto* l = static_cast<const int4*>(lines);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_lines < 1 || d < 8 || d > 256 || d % 8 || mode < kF32 || mode > kGroups ||
      (mode == kGroups && (plane < 8 || plane % 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d > 128) return launch<32, 8>(c, total, l, n_lines, d, p1, p2, mode, plane, s);
  if (d > 64) return launch<32, 4>(c, total, l, n_lines, d, p1, p2, mode, plane, s);
  if (d > 32) return launch<16, 4>(c, total, l, n_lines, d, p1, p2, mode, plane, s);
  if (d > 16) return launch<8, 4>(c, total, l, n_lines, d, p1, p2, mode, plane, s);
  if (d > 8) return launch<4, 4>(c, total, l, n_lines, d, p1, p2, mode, plane, s);
  return launch<2, 4>(c, total, l, n_lines, d, p1, p2, mode, plane, s);
}

// total (n,) float32 = acc (n,) uint16, n a multiple of 8, both 16-byte
// aligned. Returns a cudaError_t.
extern "C" int o3r_sgm_unpack16(const void* acc, void* total, long long n,
                                void* stream) {
  if (n < 8 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = n / 8;
  const unsigned blocks = static_cast<unsigned>((n8 + 255) / 256);
  auto s = static_cast<cudaStream_t>(stream);
  unpack16_kernel<<<blocks, 256, 0, s>>>(static_cast<const uint4*>(acc),
                                         static_cast<float4*>(total), n8);
  return static_cast<int>(cudaGetLastError());
}

// out (n,) bfloat16 = the four roundings of acc's ``groups`` (2 or 4) group
// sums, acc (groups, n) uint16; n a multiple of 8, both 16-byte aligned.
// Returns a cudaError_t.
extern "C" int o3r_sgm_finish_bf16(const void* acc, void* out, long long n, int groups,
                                   void* stream) {
  if (n < 8 || n % 8 || (groups != 2 && groups != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n8 = n / 8;
  const unsigned blocks = static_cast<unsigned>((n8 + 255) / 256);
  auto s = static_cast<cudaStream_t>(stream);
  finish_bf16_kernel<<<blocks, 256, 0, s>>>(static_cast<const uint4*>(acc),
                                            static_cast<uint4*>(out), n8, groups);
  return static_cast<int>(cudaGetLastError());
}

// out (n,) = bf16(in (n,) float32): bfloat16 values (to_bf16 = 1) or their
// float32 values (to_bf16 = 0; out may be in). Returns a cudaError_t.
extern "C" int o3r_sgm_round_bf16(const void* in, void* out, long long n, int to_bf16,
                                  void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  auto s = static_cast<cudaStream_t>(stream);
  round_bf16_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(in), out, n, to_bf16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* o3r_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

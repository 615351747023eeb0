// SGM path aggregation over all scan directions at once, for Hopper (sm_90a).
//
// Replaces: online_3d_reconstruction_tpu/stereo/sgm_pallas.py::_multi_kernel
// (driven by _one_call -> scan_multi -> aggregate_fused), in its float32
// storage and in its half-precision ones (bfloat16, its default, and
// float16). That kernel runs the recurrence
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
// 384x512x64, 0.019 ms at 3.35 TB/s; a half form writes a 16-bit total, 3
// bytes per cell: 37.7 MB, 0.0113 ms. The recurrence itself is a chain of
// dependent steps along each line (384-512 at that shape, measured ~0.19 us
// each: a shuffle min over the disparities, two neighbour shuffles, four
// fminf; the chains alone, -DO3R_K1_NO_UPDATE, take 0.136 ms), so no design
// that walks whole lines gets under ~0.1 ms, and the sum over 8 directions
// has to be formed somewhere: here in the 50 MB L2, by reductions, whose
// traffic is what the kernel's time follows once the chains overlap.
// The half form at 384x512x64, 8 paths (one 16-bit plane is 25.2 MB), as
// measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/bench_sgm_kernels.py
// --only K1): the row pairs store their stash in the output, read it back
// and store t1 over it (25.2 MB each); the vertical and diagonal lines
// reduce into the zeroed 32-bit group sums (50.3 MB zeroed, 6 reductions a
// cell); the finishing launch reads the sums and t1 (75.5 MB) and writes the
// total (25.2 MB): about 0.05 ms of passes at the memory's rate. With the
// chains that is the probe's 0.143 ms; the reductions into a live set of
// 88 MB (sums, output, cost: beyond the L2) add ~0.057, to 0.200 ms. The
// group-major form it replaced (four 16-bit planes, 100.7 MB: two stored,
// two zeroed and reduced into, all four read to finish) took 0.211.
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
//   is never loaded. With integer costs and integer P1, P2 >= 0 every path
//   value is an integer in [0, 255 + P2], so any order gives the plain
//   version's bits.
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
//
// The half forms (sgm_half_kernel) keep the TPU kernel's four roundings r
// (to bf16 or fp16, to nearest, ties to even) of the exact group sums: the
// forward horizontal direction g0, the backward one g1, the forward vertical
// and diagonals g2, the backward ones g3: r(r(r(r(g0) + g1) + g2) + g3).
// - Groups 0 and 1 are finished in registers by the lines that own them. The
//   forward and the backward chain of an image row run at once in one warp
//   (D <= 64: 16 lanes a line or fewer) or in the two warps of one block (D
//   >= 128), and meet in the middle, as the one-launch K3 pair does
//   (sgm_scan_pair.cu). Before the crossing each chain stores at its cells
//   of the 16-bit output what the other will need: the forward chain r(g0)
//   in the storage format, the backward chain g1 as an integer. One barrier
//   (__syncwarp or __syncthreads) orders these stores before the reads.
//   After it each chain reads the other's value (__ldcg, eight steps ahead
//   in a register ring) and stores t1 = r(r(g0) + g1) over it. Plain 8-byte
//   stores and loads, one of each a cell: no reduction. The row pairs take
//   the first blocks of the launch, the vertical and diagonal lines the
//   rest, longest first: one launch for all lines, so all chains overlap.
// - g2 and g3 take 32 bits a cell: a pixel's D g2 sums as uint16, then its
//   D g3 sums, so a vertical or diagonal line adds its four values by ONE
//   64-bit reduction a step into contiguous words, as the f32 form's packed
//   accumulator. With integer P1, P2 >= 0 every path value is an integer
//   <= 255 + P2 and g2, g3 <= 3 (255 + P2) (8 paths; 255 + P2 with 4):
//   below 2^16 for P2 <= 21590 (65280), the host tests it
//   (sgm_cuda.groups_fit_32_bits; the stash g1 needs the same with 2 or 4
//   paths). No field can carry into the next.
// - A second, streaming launch reads t1 and the group sums and writes
//   r(r(t1 + g2) + g3) over t1. With 4 paths g2 and g3 are the vertical
//   directions alone; with 2 paths t1 is the total: one launch, no
//   accumulator, no zeroing.
// - The chains of the half form skip the per-step tests: whole turns of the
//   queue in which every line of a warp steps and refills run as
//   straight-line code, and only the last turns test, the K3 lesson
//   (sgm_scan_pair.cu). Measured: the chains 0.161 -> 0.143 ms (probe), the
//   form 0.215 -> 0.203 ms; an 8-step stash ring (against 4) 0.203 ->
//   0.197; a 16-step cost queue lost (0.204-0.215 ms).
// - Measured before this form, 8 paths: t1 kept in 10-bit fields of the
//   same 32-bit words, the row pairs stashing there by reductions, took
//   0.383 ms with a lane's four cells in one 16-byte quad and 0.258 ms with
//   a pixel's words of each group contiguous: a row pair's reductions and
//   loads cost more than the output's plain stores and loads, and the 25 MB
//   of output they would save.
// - Penalties beyond that bound take the ordered form: the float4 form adds
//   the directions into an f32 total group by group, in the TPU kernel's
//   order, and a rounding kernel stores each group's partial total through
//   the storage format (the last one as the total): the f32 additions are
//   the TPU kernel's own, in its order.
// -DO3R_K1_NO_UPDATE builds a probe without the updates of the total (and
// without the half form's stash reads): the chains and the cost reads alone
// (plus the zeroing and finishing launches, which it keeps).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 64;
constexpr int kPrefetch = 8;  // steps of cost kept in flight per lane
#ifdef O3R_K1_NO_UPDATE
constexpr bool kUpdate = false;
#else
constexpr bool kUpdate = true;
#endif

// where the f32 form's step values go: the f32 total (float4 reductions) or
// the packed uint16 accumulator (64-bit reductions)
enum Mode { kF32 = 0, kPacked = 1 };

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

// One recurrence step of a line held by G lanes (gl: this lane's index in
// its group), VPT disparities a lane: next from carry and the step's costs.
// Lanes past D (in_d false) hold kBig.
template <int G, int VPT>
__device__ __forceinline__ void line_step(const float (&carry)[VPT], const CostWords<VPT>& c,
                                          bool in_d, int gl, float p1, float p2,
                                          float (&next)[VPT]) {
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
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const float dm = (j == 0 ? lo : carry[j - 1]) + p1;
    const float dp = (j == VPT - 1 ? hi : carry[j + 1]) + p1;
    const float best = fminf(fminf(carry[j], m + p2), fminf(dm, dp));
    next[j] = in_d ? cost_at<VPT>(c, j) + best - m : kBig;
  }
}

// G lanes per line (a power of two, 2..32), VPT disparities per lane (4 or
// 8): a warp carries 32 / G lines. lines[i] = {first pixel, pixel step,
// length, direction}. MODE kPacked: ``total`` is the uint16 accumulator
// (four cells per 64-bit word); kF32: the f32 total.
template <int G, int VPT, int MODE>
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
      float next[VPT];
      line_step<G, VPT>(carry, c, in_d, gl, p1, p2, next);
#pragma unroll
      for (int j = 0; j < VPT; ++j) carry[j] = next[j];

      if (in_d && s < len) {
#pragma unroll
        for (int j = 0; j < VPT; j += 4) {
          if constexpr (!kUpdate) {  // probe build: the chains without the update
            if (next[j] == -1.f) static_cast<float*>(total)[0] = 0.f;
          } else if constexpr (MODE == kPacked) {
            // results unused: reductions, no round trip
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
        }
      }
      cell += step;
    }
  }
}

template <int G, int VPT>
cudaError_t launch(const uint8_t* cost, void* total, const int4* lines,
                   int n_lines, int d, float p1, float p2, int mode,
                   cudaStream_t stream) {
  constexpr int kLinesPerBlock = (kThreads / 32) * (32 / G);
  const int blocks = (n_lines + kLinesPerBlock - 1) / kLinesPerBlock;
  if (mode == kPacked) {
    sgm_lines_kernel<G, VPT, kPacked><<<blocks, kThreads, 0, stream>>>(
        cost, total, lines, n_lines, d, p1, p2);
  } else {
    sgm_lines_kernel<G, VPT, kF32><<<blocks, kThreads, 0, stream>>>(
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

// ---------------------------------------------------------------------------
// the half forms
// ---------------------------------------------------------------------------

// The storage formats: bits(x) is x rounded to the format (to nearest, ties
// to even) as its 16 bits, widen(b) those bits as f32 (exact).
struct Bf16 {
  static __device__ __forceinline__ unsigned short bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float widen(unsigned short b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
};
struct Fp16 {
  static __device__ __forceinline__ unsigned short bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
  static __device__ __forceinline__ float widen(unsigned short b) {
    return __half2float(__ushort_as_half(b));
  }
};

// x rounded to the format R and back to f32: exact
template <typename R>
__device__ __forceinline__ float round_to(float x) {
  return R::widen(R::bits(x));
}

// four 16-bit values as one 8-byte word (element 0 lowest)
__device__ __forceinline__ uint2 pack4(unsigned a, unsigned b, unsigned c, unsigned e) {
  return make_uint2(a | b << 16, c | e << 16);
}

// what a step of a half-form line does with its values
enum Part { kTri = 0, kStash = 1, kJoin = 2 };

// The update of one step of a line at ``cell`` (a multiple of 4; d0 its
// disparity). kTri adds v to the line's group sums in ``acc`` (group 0: g2,
// 1: g3): a pixel's 2 D 16-bit sums are its D g2 sums, then its D g3 sums,
// so the 64-bit word of g2 for cells (cell .. cell + 3) is
// (2 cell - d0) / 4, and the lanes of a line reduce into contiguous words.
// kStash stores the row chain's stash in ``out``: the forward chain r(g0)
// in the format R, the backward chain g1 as an integer. kJoin forms t1 =
// r(r(g0) + g1) from v and the ``found`` stash of the other chain and
// stores it in ``out``.
template <int PART, int VPT, typename R>
__device__ __forceinline__ void half_update(unsigned short* out, void* acc, long long cell,
                                            int d0, int d, const float (&v)[VPT], bool back,
                                            int group, const uint2 (&found)[VPT / 4]) {
#pragma unroll
  for (int q = 0; q < VPT / 4; ++q) {
    const float* w = v + 4 * q;
    if constexpr (PART == kTri) {
      const uint2 sums = pack4((unsigned)w[0], (unsigned)w[1], (unsigned)w[2], (unsigned)w[3]);
      atomicAdd(static_cast<unsigned long long*>(acc) + (2 * cell - d0) / 4 + q +
                    group * (d / 4),
                (unsigned long long)sums.x | (unsigned long long)sums.y << 32);
    } else {
      unsigned short s[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (PART == kStash) {
          s[k] = back ? static_cast<unsigned short>(w[k]) : R::bits(w[k]);
        } else {
          const unsigned word = k < 2 ? found[q].x : found[q].y;
          const auto b = static_cast<unsigned short>(word >> (16 * (k & 1)));
          // the backward chain finds r(g0) in the format, the forward chain g1
          const float other = back ? R::widen(b) : static_cast<float>(b);
          s[k] = R::bits((back ? w[k] : round_to<R>(w[k])) + other);
        }
      }
      reinterpret_cast<uint2*>(out + cell)[q] = pack4(s[0], s[1], s[2], s[3]);
    }
  }
}

// steps of stash a joining row chain keeps in flight, beside kPrefetch
// steps of cost (measured: 8 and 8 beat 4 and 8, 8 and 16, 16 and 16)
constexpr int kAhead = 8;

// Step s of a half-form line at ``cell``: the costs come from the queue's
// slot, which is refilled from kPrefetch steps ahead; a joining row chain's
// stash from its ring slot, refilled from kAhead steps ahead. STEADY: the
// step and its refills are in range for every line of the warp, so nothing
// is tested.
template <bool STEADY, int PART, int G, int VPT, typename R>
__device__ __forceinline__ void half_step(const uint8_t* __restrict__ cost,
                                          unsigned short* out, void* acc, long long& cell,
                                          long long step, int n, int s, bool in_d, int gl,
                                          int d, float p1, float p2, bool back, int group,
                                          CostWords<VPT>& slot, uint2 (&found)[VPT / 4],
                                          float (&carry)[VPT]) {
  const CostWords<VPT> c = slot;
  if (in_d && (STEADY || s + kPrefetch < n)) {
    slot = load_cost<VPT>(cost + cell + kPrefetch * step);
  }
  uint2 here[VPT / 4];
#pragma unroll
  for (int q = 0; q < VPT / 4; ++q) {
    here[q] = found[q];
    if (PART == kJoin && kUpdate && in_d && (STEADY || s + kAhead < n)) {
      found[q] = __ldcg(reinterpret_cast<const uint2*>(out + cell + kAhead * step) + q);
    }
  }
  float next[VPT];
  line_step<G, VPT>(carry, c, in_d, gl, p1, p2, next);
  if (STEADY || s < n) {  // a line's carry goes on into its next part
#pragma unroll
    for (int j = 0; j < VPT; ++j) carry[j] = next[j];
    if (in_d) {
      if constexpr (kUpdate) {
        half_update<PART, VPT, R>(out, acc, cell, gl * VPT, d, next, back, group, here);
      } else if (next[0] == -1.f) {  // probe build: the chains alone
        out[0] = 0;
      }
    }
    cell += step;
  }
}

// n steps of a half-form line from ``cell`` (this lane's first cell), carry
// updated in place; the warp loops to its longest n.
template <int PART, int G, int VPT, typename R>
__device__ __forceinline__ void half_walk(const uint8_t* __restrict__ cost, unsigned short* out,
                                          void* acc, long long cell, long long step, int n,
                                          bool in_d, int gl, int d, float p1, float p2,
                                          bool back, int group, float (&carry)[VPT]) {
  const int n_max = __reduce_max_sync(kFullMask, n);
  const int n_min = __reduce_min_sync(kFullMask, n);
  CostWords<VPT> queue[kPrefetch];
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    queue[k] = CostWords<VPT>{};
    if (in_d && k < n) queue[k] = load_cost<VPT>(cost + cell + k * step);
  }
  uint2 found[kAhead][VPT / 4];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
#pragma unroll
    for (int q = 0; q < VPT / 4; ++q) {
      found[k][q] = make_uint2(0u, 0u);
      if (PART == kJoin && kUpdate && in_d && k < n) {
        found[k][q] = __ldcg(reinterpret_cast<const uint2*>(out + cell + k * step) + q);
      }
    }
  }
  int s0 = 0;
  // Whole turns of the queue in which every line of the warp steps and
  // refills: straight-line code, as K3's steady loop (sgm_scan_pair.cu)
  for (; s0 + 2 * kPrefetch <= n_min; s0 += kPrefetch) {
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      half_step<true, PART, G, VPT, R>(cost, out, acc, cell, step, n, s0 + k, in_d, gl, d, p1,
                                       p2, back, group, queue[k], found[k % kAhead], carry);
    }
  }
  // the last turns: a line may have no step or no refill left
  for (; s0 < n_max; s0 += kPrefetch) {
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      half_step<false, PART, G, VPT, R>(cost, out, acc, cell, step, n, s0 + k, in_d, gl, d,
                                        p1, p2, back, group, queue[k], found[k % kAhead],
                                        carry);
    }
  }
}

// The half form's line launch. G, VPT as sgm_lines_kernel; R the storage
// format. lines[0, pair_lines) are the row pairs: the forward then the
// backward row of each image row (length-0 lines fill the section up to a
// multiple of 32 lines, so a block holds row pairs only or none); they
// stash in and write t1 to ``out``, the (H*W, D) 16-bit total. The rest
// are the vertical and diagonal lines, longest first; they add into
// ``acc``, the zeroed 32-bit group sums (none with 2 paths).
template <int G, int VPT, typename R>
__global__ void __launch_bounds__(kThreads) sgm_half_kernel(
    const uint8_t* __restrict__ cost, unsigned short* out, void* __restrict__ acc,
    const int4* __restrict__ lines, int n_lines, int pair_lines, int d, float p1, float p2) {
  constexpr int kLinesPerWarp = 32 / G;
  constexpr int kLinesPerBlock = (kThreads / 32) * kLinesPerWarp;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp * kLinesPerWarp >= n_lines) return;  // uniform; never in a pair block
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  const int line = warp * kLinesPerWarp + lane / G;
  const int4 ln = line < n_lines ? __ldg(lines + line) : make_int4(0, 0, 0, 0);
  const bool in_d = gl * VPT < d;
  float carry[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) carry[j] = in_d ? 0.f : kBig;
  const long long step = (long long)ln.y * d;
  const long long cell = (long long)ln.x * d + gl * VPT;

  if ((long long)blockIdx.x * kLinesPerBlock >= pair_lines) {  // uniform across the block
    // a vertical or diagonal line: its direction's group, g2 (forward) or g3
    half_walk<kTri, G, VPT, R>(cost, out, acc, cell, step, ln.z, in_d, gl, d, p1, p2, false,
                               ln.w & 1, carry);
    return;
  }
  // a row pair: each chain takes its half of the row first (the backward
  // chain the middle of an odd row), then goes on through the other's
  const bool back = ln.w == 1;
  const int first = back ? ln.z - ln.z / 2 : ln.z / 2;
  half_walk<kStash, G, VPT, R>(cost, out, acc, cell, step, first, in_d, gl, d, p1, p2, back,
                               0, carry);
  __threadfence_block();
  if constexpr (G == 32) {
    __syncthreads();  // the pair spans the block's two warps
  } else {
    __syncwarp();     // every pair of this warp has stashed
  }
  half_walk<kJoin, G, VPT, R>(cost, out, acc, cell + first * step, step, ln.z - first, in_d,
                              gl, d, p1, p2, back, 0, carry);
}

template <int G, int VPT, typename R>
cudaError_t launch_half(const uint8_t* cost, unsigned short* out, void* acc, const int4* lines,
                        int n_lines, int pair_lines, int d, float p1, float p2,
                        cudaStream_t stream) {
  constexpr int kLinesPerBlock = (kThreads / 32) * (32 / G);
  const int blocks = (n_lines + kLinesPerBlock - 1) / kLinesPerBlock;
  sgm_half_kernel<G, VPT, R><<<blocks, kThreads, 0, stream>>>(
      cost, out, acc, lines, n_lines, pair_lines, d, p1, p2);
  return cudaGetLastError();
}

template <typename R>
cudaError_t dispatch_half(const uint8_t* c, unsigned short* o, void* a, const int4* l,
                          int n_lines, int pair_lines, int d, float p1, float p2,
                          cudaStream_t s) {
  if (d > 128) return launch_half<32, 8, R>(c, o, a, l, n_lines, pair_lines, d, p1, p2, s);
  if (d > 64) return launch_half<32, 4, R>(c, o, a, l, n_lines, pair_lines, d, p1, p2, s);
  if (d > 32) return launch_half<16, 4, R>(c, o, a, l, n_lines, pair_lines, d, p1, p2, s);
  if (d > 16) return launch_half<8, 4, R>(c, o, a, l, n_lines, pair_lines, d, p1, p2, s);
  if (d > 8) return launch_half<4, 4, R>(c, o, a, l, n_lines, pair_lines, d, p1, p2, s);
  return launch_half<2, 4, R>(c, o, a, l, n_lines, pair_lines, d, p1, p2, s);
}

// The half form's second launch, 8 cells a thread: reads t1 from ``out``
// and g2, g3 from ``acc``, and writes r(r(t1 + g2) + g3) over t1.
template <typename R>
__global__ void __launch_bounds__(256) finish_half_kernel(
    const uint4* __restrict__ acc, uint4* out, long long n8, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  // cells 8 i .. 8 i + 7 of one pixel: their g2 sums from 16-bit element
  // 2 (8 i) - (8 i mod D), a multiple of 8; their g3 sums D elements on
  const long long g2 = (16 * i - 8 * i % d) / 8;
  const uint4 t = out[i], s2 = __ldg(acc + g2), s3 = __ldg(acc + g2 + d / 8);
  const unsigned tw[4] = {t.x, t.y, t.z, t.w}, w2[4] = {s2.x, s2.y, s2.z, s2.w},
                 w3[4] = {s3.x, s3.y, s3.z, s3.w};
  unsigned words[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned word = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int shift = 16 * half;
      const float t1 = R::widen(static_cast<unsigned short>(tw[k] >> shift));
      const float t2 = round_to<R>(t1 + static_cast<float>((w2[k] >> shift) & 0xffffu));
      word |= static_cast<unsigned>(
                  R::bits(t2 + static_cast<float>((w3[k] >> shift) & 0xffffu)))
              << shift;
    }
    words[k] = word;
  }
  out[i] = make_uint4(words[0], words[1], words[2], words[3]);
}

// The ordered half form's rounding: out[i] = r(in[i]), in the format R
// (to_half) or as its f32 value (in place allowed).
template <typename R>
__global__ void __launch_bounds__(256) round_half_kernel(
    const float* in, void* out, long long n, int to_half) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (to_half) {
    static_cast<unsigned short*>(out)[i] = R::bits(in[i]);
  } else {
    static_cast<float*>(out)[i] = round_to<R>(in[i]);
  }
}

}  // namespace

// Adds the aggregation of cost (H*W, D) uint8 along the n_lines scan lines
// of ``lines`` (int32 x 4 each: first pixel, pixel step, length, direction)
// into ``total`` by reductions: the lines may cross. mode 0: total is
// (H*W, D) float32. mode 1: total is the (H*W, D) uint16 accumulator; the
// caller guarantees integer penalties and sums below 2^16. D is a multiple
// of 8 in [8, 256]. Returns a cudaError_t.
extern "C" int o3r_sgm_aggregate(const void* cost, void* total,
                                 const void* lines, int n_lines, int d,
                                 float p1, float p2, int mode, void* stream) {
  const auto* c = static_cast<const uint8_t*>(cost);
  const auto* l = static_cast<const int4*>(lines);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_lines < 1 || d < 8 || d > 256 || d % 8 || mode < kF32 || mode > kPacked) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d > 128) return launch<32, 8>(c, total, l, n_lines, d, p1, p2, mode, s);
  if (d > 64) return launch<32, 4>(c, total, l, n_lines, d, p1, p2, mode, s);
  if (d > 32) return launch<16, 4>(c, total, l, n_lines, d, p1, p2, mode, s);
  if (d > 16) return launch<8, 4>(c, total, l, n_lines, d, p1, p2, mode, s);
  if (d > 8) return launch<4, 4>(c, total, l, n_lines, d, p1, p2, mode, s);
  return launch<2, 4>(c, total, l, n_lines, d, p1, p2, mode, s);
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

// The half form's line launch over the n_lines lines of ``lines`` (see
// sgm_half_kernel; the first pair_lines, a multiple of 32, are the row
// pairs), storage format ``fmt`` (0: bfloat16, 1: float16). ``out``: the
// (H*W, D) 16-bit total, which holds t1 after it (the total itself with 2
// paths); ``acc``: the zeroed (H*W, 2 D) uint16 group sums, finished by
// o3r_sgm_finish_half (may be null where every line is a row's). The
// caller guarantees integer penalties P1, P2 >= 0 with the group sums and
// the stash below 2^16. D is a multiple of 8 in [8, 256], the buffers
// 16-byte aligned. Returns a cudaError_t.
extern "C" int o3r_sgm_aggregate_half(const void* cost, void* out, void* acc, const void* lines,
                                      int n_lines, int pair_lines, int d, float p1, float p2,
                                      int fmt, void* stream) {
  const auto* c = static_cast<const uint8_t*>(cost);
  auto* o = static_cast<unsigned short*>(out);
  const auto* l = static_cast<const int4*>(lines);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_lines < 1 || d < 8 || d > 256 || d % 8 || (fmt != 0 && fmt != 1) ||
      pair_lines < 0 || pair_lines % 32 || pair_lines > n_lines ||
      (acc == nullptr && pair_lines != n_lines)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fmt == 0) return dispatch_half<Bf16>(c, o, acc, l, n_lines, pair_lines, d, p1, p2, s);
  return dispatch_half<Fp16>(c, o, acc, l, n_lines, pair_lines, d, p1, p2, s);
}

// out (n,) 16-bit = r(r(t1 + g2) + g3), in place over t1, with the group
// sums acc (n / D, 2 D) uint16 of the line launch, in the format ``fmt``
// (0: bfloat16, 1: float16); n cells of D disparities (D a multiple of 8),
// both 16-byte aligned. Returns a cudaError_t.
extern "C" int o3r_sgm_finish_half(const void* acc, void* out, long long n, int d, int fmt,
                                   void* stream) {
  if (n < 8 || n % 8 || d < 8 || d % 8 || n % d || (fmt != 0 && fmt != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n8 = n / 8;
  const unsigned blocks = static_cast<unsigned>((n8 + 255) / 256);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint4*>(acc);
  auto* o = static_cast<uint4*>(out);
  if (fmt == 0) {
    finish_half_kernel<Bf16><<<blocks, 256, 0, s>>>(a, o, n8, d);
  } else {
    finish_half_kernel<Fp16><<<blocks, 256, 0, s>>>(a, o, n8, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (n,) = r(in (n,) float32) in the format ``fmt`` (0: bfloat16, 1:
// float16): 16-bit values (to_half = 1) or their float32 values (to_half =
// 0; out may be in). Returns a cudaError_t.
extern "C" int o3r_sgm_round_half(const void* in, void* out, long long n, int to_half,
                                  int fmt, void* stream) {
  if (n < 1 || (fmt != 0 && fmt != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const float*>(in);
  if (fmt == 0) {
    round_half_kernel<Bf16><<<blocks, 256, 0, s>>>(i, out, n, to_half);
  } else {
    round_half_kernel<Fp16><<<blocks, 256, 0, s>>>(i, out, n, to_half);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* o3r_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

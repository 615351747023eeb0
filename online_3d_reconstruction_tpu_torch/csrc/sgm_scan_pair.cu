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
// What bounds it on the H100 (measured on an NVIDIA H100 80GB HBM3 at 700 W,
// 384x512x64 f32, tools/bench_sgm_kernels.py): the pair as one function must
// read the cost once and write the total once, 100.7 MB, 0.030 ms at
// 3.35 TB/s. A line is a chain of S dependent steps, each a min over D
// across lanes (shuffles) and four fminf, and there are only L lines, so the
// chain's length times the step's latency is a floor of its own: a separate
// pass sits on it (0.065 ms forward with or without its stores, ~0.17 us a
// step). The one-launch pair moves 2.5 times its compulsory bytes (the cost
// once per chain, the stash out and back, the total) and takes 0.084 ms,
// 3.0 TB/s: its own bytes bound it.
//
// Design:
// - Both chains of a line at once, one launch (o3r_scan_pair). The forward
//   chain of a line runs s = 0, 1, ... while the backward chain of the same
//   line runs s = S-1, S-2, ... in a neighbouring group of lanes of the same
//   block; the two recurrences do not depend on each other, only the final
//   sum joins them. They cross at the middle. Before the crossing each chain
//   is the first to reach its cells and stashes there, in f32, what the other
//   will need: the forward chain its result rounded to the storage dtype,
//   the backward chain its carry. One __syncthreads at the crossing orders
//   the stashes before the reads (the two chains of a line always share a
//   block). After it each chain reads the other's stash at its own cell,
//   adds, rounds and writes the total: round(round(fwd) + bwd_carry), the
//   TPU pair's two roundings. The stash of f32 storage is the output buffer
//   itself (a cell is read, then overwritten, by one thread); bf16 storage
//   cannot hold an f32 carry, so its stash is an f32 scratch volume the
//   caller allocates. With odd S the backward chain takes the middle cell
//   first.
// - The step's latency: four disparities a lane, the lanes of a line chosen
//   from D (64 disparities take 16 lanes: 4 shuffle rounds for the min, one
//   16-byte load or store a lane in f32, 8-byte in bf16), so a warp carries
//   32 / lanes chains. d-1 / d+1 cross lanes by one shuffle each with the
//   TPU kernel's 1e9 edge. Slots past D hold 1e9, which is that edge for the
//   last real disparity, and are left out of the min (real carries reach 1e9
//   on pre-skewed volumes, whose padding cells cost 1e9).
// - The load's latency: a line's address at step i is base + i * stride, so
//   each lane keeps the next steps' cost rows (16 steps), and after the
//   crossing the cost and the stash rows (8 steps each), in flight in
//   register rings; a step waits only for its shuffles. Depth 8 to 16 was
//   worth 12% to a pass: the lines move in step, so the loads come in bursts.
// - No branch in the steady state. A warp here is alone on its scheduler and
//   pays in full for every branch it meets: a loop that tested each step for
//   its range, its refill and its vector form took 0.087 ms for the forward
//   pass, the same steps as straight-line code 0.065 ms. So whole turns of
//   the ring in which every chain of the warp steps and refills run without a
//   test; only the last turns test. For that, every chain of a warp must
//   have steps: a chain past the last line repeats it and stores nothing,
//   and the vector form is a template parameter.
// - The separate passes (o3r_scan_fwd, o3r_scan_bwd: one TPU kernel each)
//   are the same code with one chain a line and no crossing.
// - The arithmetic is the reference's _step in its order, (cost + best) -
//   min_prev, all f32 additions and minima (nothing a compiler may contract
//   into a fused multiply-add), and the roundings to the storage dtype sit
//   where the TPU kernels have them, so the plain version's bits come out,
//   with integer costs and with 1e9 padding cells alike.
// - Rows are moved as 16-byte (f32) or 8-byte (bf16) vectors where D is a
//   multiple of 4 and the buffers are 16-byte aligned, element by element
//   otherwise.
// -DO3R_K3_NO_STORE builds a probe without the stores: the time of the
// chains and the loads alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 64;   // a pair's two chains must share a block: >= 2 * 32

enum Kind { kForward = 0, kBackward = 1, kPair = 2 };

// Storage elements travel as raw bits: float, or the 16 bits of a bfloat16.
// Chunk<E> is four of them, the unit of a vector load or store.
template <typename E>
struct Chunk;
template <>
struct Chunk<float> {
  float4 v;
};
template <>
struct Chunk<unsigned short> {
  uint2 v;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

template <typename E>
__device__ __forceinline__ E narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ unsigned short narrow<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// element k (0..3, a constant after unrolling) of a chunk, as f32
__device__ __forceinline__ float chunk_get(const Chunk<float>& c, int k) {
  return k == 0 ? c.v.x : k == 1 ? c.v.y : k == 2 ? c.v.z : c.v.w;
}
__device__ __forceinline__ float chunk_get(const Chunk<unsigned short>& c, int k) {
  const unsigned w = k < 2 ? c.v.x : c.v.y;
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// element k of a zeroed chunk set from storage bits
__device__ __forceinline__ void chunk_set(Chunk<float>& c, int k, float e) {
  if (k == 0) c.v.x = e;
  if (k == 1) c.v.y = e;
  if (k == 2) c.v.z = e;
  if (k == 3) c.v.w = e;
}
__device__ __forceinline__ void chunk_set(Chunk<unsigned short>& c, int k,
                                          unsigned short e) {
  const unsigned bits = static_cast<unsigned>(e) << (16 * (k & 1));
  if (k < 2) c.v.x |= bits;
  else c.v.y |= bits;
}

__device__ __forceinline__ Chunk<float> chunk_pack(float a, float b, float c,
                                                   float d, float) {
  return Chunk<float>{make_float4(a, b, c, d)};
}
__device__ __forceinline__ Chunk<unsigned short> chunk_pack(float a, float b,
                                                            float c, float d,
                                                            unsigned short) {
  const unsigned lo = narrow<unsigned short>(a) |
                      static_cast<unsigned>(narrow<unsigned short>(b)) << 16;
  const unsigned hi = narrow<unsigned short>(c) |
                      static_cast<unsigned>(narrow<unsigned short>(d)) << 16;
  return Chunk<unsigned short>{make_uint2(lo, hi)};
}

__device__ __forceinline__ float4 zero_of(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ uint2 zero_of(uint2) { return make_uint2(0u, 0u); }

// One lane's VPT storage elements of one line at one step.
template <typename E, int VPT>
struct Row {
  Chunk<E> c[VPT / 4];
};

// The row at p (this lane's first element; d0 its disparity), 0 past D.
// VEC: D is a multiple of 4 (a chunk is all in or all out) and the buffers
// are 16-byte aligned. CONSTANT: the kernel never writes the buffer (cost).
template <typename E, int VPT, bool VEC, bool CONSTANT>
__device__ __forceinline__ Row<E, VPT> load_row(const E* p, int d0, int d) {
  using V = decltype(Chunk<E>::v);
  Row<E, VPT> r;
#pragma unroll
  for (int q = 0; q < VPT / 4; ++q) r.c[q].v = zero_of(V{});
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < VPT / 4; ++q) {
      if (d0 + 4 * q < d) {
        const V* src = reinterpret_cast<const V*>(p + 4 * q);
        r.c[q].v = CONSTANT ? __ldg(src) : *src;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (d0 + j < d) chunk_set(r.c[j / 4], j % 4, CONSTANT ? __ldg(p + j) : p[j]);
    }
  }
  return r;
}

template <typename E, int VPT, bool VEC>
__device__ __forceinline__ void store_row(E* p, const float (&v)[VPT], int d0, int d) {
#ifdef O3R_K3_NO_STORE  // probe build: costs and penalties are >= 0, so never
  const bool on = v[0] == -1.f;
#else
  constexpr bool on = true;
#endif
  using V = decltype(Chunk<E>::v);
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < VPT / 4; ++q) {
      if (on && d0 + 4 * q < d) {
        *reinterpret_cast<V*>(p + 4 * q) =
            chunk_pack(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3], E{}).v;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (on && d0 + j < d) p[j] = narrow<E>(v[j]);
    }
  }
}

// One recurrence step of a line held by G lanes (gl: this lane's index in
// the group), VPT disparities each from d0: next from carry and cost c.
template <int G, int VPT>
__device__ __forceinline__ void sgm_step(const float (&carry)[VPT],
                                         const float (&c)[VPT], float (&next)[VPT],
                                         float p1, float p2, int gl, int d0, int d) {
  float m = (d0 < d) ? carry[0] : INFINITY;
#pragma unroll
  for (int j = 1; j < VPT; ++j) m = fminf(m, (d0 + j < d) ? carry[j] : INFINITY);
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
    next[j] = (d0 + j < d) ? c[j] + best - m : kBig;
  }
}

// What the steps of one chain (a line in one direction, held by G lanes)
// share. Each step's value v is the new carry, rounded through the storage
// type E first where ``round_first``. Without a partner, v is stored at its
// cell of ``side``; with one, the value found at that cell of ``side`` is
// added to v and the sum stored in ``out``.
template <typename E, typename P>
struct Chain {
  const E* cost;
  P* side;
  E* out;
  long long stride;  // elements from one step's cell to the next
  int n;             // steps to take
  bool writes;       // false: a copy of the last line that fills up a warp
  bool round_first;
  int gl, d0, d;
  float p1, p2;
};

// Step i of a chain at ``cell``: the rows come from the rings' slots, which
// are refilled from DEPTH steps ahead. STEADY: the step and its refill are
// in range for every chain of the warp, so nothing is tested.
template <bool STEADY, bool PARTNER, bool VEC, int G, int VPT, int DEPTH, typename E,
          typename P>
__device__ __forceinline__ void one_step(const Chain<E, P>& ch, Row<E, VPT>& cost_slot,
                                         Row<P, VPT>& side_slot, long long& cell, int i,
                                         float (&carry)[VPT]) {
  const Row<E, VPT> row = cost_slot;
  const Row<P, VPT> found = side_slot;
  if (STEADY || i + DEPTH < ch.n) {
    const long long ahead = cell + DEPTH * ch.stride;
    cost_slot = load_row<E, VPT, VEC, true>(ch.cost + ahead, ch.d0, ch.d);
    if constexpr (PARTNER) {
      side_slot = load_row<P, VPT, VEC, false>(ch.side + ahead, ch.d0, ch.d);
    }
  }
  float c[VPT], next[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) c[j] = chunk_get(row.c[j / 4], j % 4);
  sgm_step<G, VPT>(carry, c, next, ch.p1, ch.p2, ch.gl, ch.d0, ch.d);
  if (STEADY || i < ch.n) {
    float v[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      carry[j] = next[j];
      v[j] = ch.round_first ? widen(narrow<E>(next[j])) : next[j];
      if constexpr (PARTNER) v[j] += chunk_get(found.c[j / 4], j % 4);
    }
    if (ch.writes) {
      if constexpr (PARTNER) store_row<E, VPT, VEC>(ch.out + cell, v, ch.d0, ch.d);
      else store_row<P, VPT, VEC>(ch.side + cell, v, ch.d0, ch.d);
    }
    cell += ch.stride;
  }
}

// ch.n steps of a chain from ``cell`` (this lane's element offset), carry
// updated in place; the warp loops to its largest n.
template <bool PARTNER, bool VEC, int G, int VPT, typename E, typename P>
__device__ __forceinline__ void run_steps(const Chain<E, P>& ch, long long& cell,
                                          float (&carry)[VPT]) {
  // Steps of rows a lane keeps in flight: as deep as its registers allow. A
  // chain that also reads the other's value keeps two rings, so half as
  // deep; eight disparities a lane halve it again.
  constexpr int kDepth = (PARTNER ? 8 : 16) * 4 / VPT;
  const int n_max = __reduce_max_sync(kFullMask, ch.n);
  const int n_min = __reduce_min_sync(kFullMask, ch.n);
  Row<E, VPT> cost_ring[kDepth];
  Row<P, VPT> side_ring[PARTNER ? kDepth : 1];
  side_ring[0] = Row<P, VPT>{};
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    cost_ring[k] = Row<E, VPT>{};
    if (k < ch.n) {
      cost_ring[k] = load_row<E, VPT, VEC, true>(ch.cost + cell + k * ch.stride, ch.d0, ch.d);
      if constexpr (PARTNER) {
        side_ring[k] = load_row<P, VPT, VEC, false>(ch.side + cell + k * ch.stride,
                                                    ch.d0, ch.d);
      }
    }
  }
  int i0 = 0;
  // Whole turns of the ring in which every chain of the warp steps and
  // refills: straight-line code, the only branch the loop's own. A warp's
  // one instruction stream pays for every branch it meets, and the chain
  // leaves nothing else to hide them behind.
  if constexpr (VEC) {  // the element-by-element form is rare: one loop will do
    for (; i0 + 2 * kDepth <= n_min; i0 += kDepth) {
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        one_step<true, PARTNER, VEC, G, VPT, kDepth>(
            ch, cost_ring[k], side_ring[PARTNER ? k : 0], cell, i0 + k, carry);
      }
    }
  }
  // The last turns: a chain may have no step or no refill left. The test on
  // n_max is uniform across the warp, so the shuffles stay convergent.
  for (; i0 < n_max; i0 += kDepth) {
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (i0 + k < n_max) {
        one_step<false, PARTNER, VEC, G, VPT, kDepth>(
            ch, cost_ring[k], side_ring[PARTNER ? k : 0], cell, i0 + k, carry);
      }
    }
  }
}

// G lanes a chain (a power of two, 2..32), VPT disparities a lane (4 or 8).
// kForward / kBackward: one chain a line. kPair: two neighbouring chains a
// line, the even one forward, the odd one backward; ``stash`` (S, L, D) f32
// may be ``out`` itself where E is float. Chains past the last line repeat
// it and store nothing, so that every chain of a warp has steps to take.
template <typename E, int G, int VPT, int KIND, bool VEC>
__global__ void __launch_bounds__(kThreads) scan_kernel(
    const E* __restrict__ cost, E* out, float* stash, int s_len, int l_len, int d,
    float p1, float p2) {
  static_assert(kThreads % 64 == 0 && 32 % G == 0 && VPT % 4 == 0, "lane split");
  const long long chain = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  const int gl = threadIdx.x % G;
  const long long line = KIND == kPair ? chain >> 1 : chain;
  const bool backward = KIND == kPair ? (chain & 1) != 0 : KIND == kBackward;
  const bool live = line < l_len;
  const int d0 = gl * VPT;
  const long long row = (long long)l_len * d;
  const long long stride = backward ? -row : row;
  long long cell = (backward ? (s_len - 1) * row : 0) + (live ? line : l_len - 1) * d + d0;

  float carry[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) carry[j] = (d0 + j < d) ? 0.f : kBig;

  if constexpr (KIND != kPair) {
    const Chain<E, E> ch{cost, out, out, stride, s_len, live, false, gl, d0, d, p1, p2};
    run_steps<KIND == kBackward, VEC, G, VPT>(ch, cell, carry);
  } else {
    // the forward chain takes the cells below the middle first, the backward
    // chain the middle and above; then each goes on through the other's
    const int first = backward ? s_len - s_len / 2 : s_len / 2;
    Chain<E, float> ch{cost, stash, out, stride, first, live, !backward, gl, d0, d, p1, p2};
    run_steps<false, VEC, G, VPT>(ch, cell, carry);
    __syncthreads();  // every stash of this block's lines is written
    ch.n = s_len - first;
    run_steps<true, VEC, G, VPT>(ch, cell, carry);
  }
}

template <typename E, int G, int VPT, int KIND>
cudaError_t launch_kind(unsigned blocks, bool vec, const E* cost, E* out, float* stash,
                        int s, int l, int d, float p1, float p2, cudaStream_t stream) {
  if (vec) {
    scan_kernel<E, G, VPT, KIND, true><<<blocks, kThreads, 0, stream>>>(
        cost, out, stash, s, l, d, p1, p2);
  } else {
    scan_kernel<E, G, VPT, KIND, false><<<blocks, kThreads, 0, stream>>>(
        cost, out, stash, s, l, d, p1, p2);
  }
  return cudaGetLastError();
}

template <typename E, int G, int VPT>
cudaError_t launch(int kind, const void* cost, void* out, void* stash, int s,
                   int l, int d, float p1, float p2, cudaStream_t stream) {
  const E* c = static_cast<const E*>(cost);
  E* o = static_cast<E*>(out);
  float* side = static_cast<float*>(stash);
  auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const bool vec = d % 4 == 0 && aligned(cost) && aligned(out) &&
                   (kind != kPair || aligned(stash));
  constexpr int kChainsPerBlock = kThreads / G;
  const long long chains = (long long)l * (kind == kPair ? 2 : 1);
  const unsigned blocks =
      static_cast<unsigned>((chains + kChainsPerBlock - 1) / kChainsPerBlock);
  if (kind == kForward) {
    return launch_kind<E, G, VPT, kForward>(blocks, vec, c, o, side, s, l, d, p1, p2, stream);
  }
  if (kind == kBackward) {
    return launch_kind<E, G, VPT, kBackward>(blocks, vec, c, o, side, s, l, d, p1, p2, stream);
  }
  return launch_kind<E, G, VPT, kPair>(blocks, vec, c, o, side, s, l, d, p1, p2, stream);
}

template <typename E>
int dispatch(int kind, const void* cost, void* out, void* stash, int s, int l,
             int d, float p1, float p2, cudaStream_t st) {
  if (d > 128) return launch<E, 32, 8>(kind, cost, out, stash, s, l, d, p1, p2, st);
  if (d > 64) return launch<E, 32, 4>(kind, cost, out, stash, s, l, d, p1, p2, st);
  if (d > 32) return launch<E, 16, 4>(kind, cost, out, stash, s, l, d, p1, p2, st);
  if (d > 16) return launch<E, 8, 4>(kind, cost, out, stash, s, l, d, p1, p2, st);
  if (d > 8) return launch<E, 4, 4>(kind, cost, out, stash, s, l, d, p1, p2, st);
  return launch<E, 2, 4>(kind, cost, out, stash, s, l, d, p1, p2, st);
}

}  // namespace

// The bfloat16 half of ``scan``. sgm_scan_pair_bf16.cu defines it: it is this
// source compiled a second time, with O3R_SCAN_BF16_UNIT set, so that the two
// halves (36 kernels each) build side by side.
extern "C" int o3r_scan_bf16_unit(int kind, const void* cost, void* out, void* stash,
                                  int s, int l, int d, float p1, float p2, void* stream)
#ifdef O3R_SCAN_BF16_UNIT
{
  return dispatch<unsigned short>(kind, cost, out, stash, s, l, d, p1, p2,
                                  static_cast<cudaStream_t>(stream));
}
#else
    ;

namespace {

int scan(int kind, const void* cost, void* out, void* stash, int s, int l, int d,
         int dtype, float p1, float p2, void* stream) {
  if (s < 1 || l < 1 || d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return dispatch<float>(kind, cost, out, out, s, l, d, p1, p2,
                             static_cast<cudaStream_t>(stream));
    case 1:
      if (kind == kPair && stash == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return o3r_scan_bf16_unit(kind, cost, out, stash, s, l, d, p1, p2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Forward scan of cost (S, L, D) into out (S, L, D), both of the storage
// dtype (0: float32, 1: bfloat16). D is at most 256. Returns a cudaError_t.
extern "C" int o3r_scan_fwd(const void* cost, void* out, int s, int l, int d,
                            int dtype, float p1, float p2, void* stream) {
  return scan(kForward, cost, out, nullptr, s, l, d, dtype, p1, p2, stream);
}

// Backward scan of cost (S, L, D), added in place into the forward result
// ``acc_out`` (S, L, D) of the same storage dtype. Returns a cudaError_t.
extern "C" int o3r_scan_bwd(const void* cost, void* acc_out, int s, int l,
                            int d, int dtype, float p1, float p2,
                            void* stream) {
  return scan(kBackward, cost, acc_out, nullptr, s, l, d, dtype, p1, p2, stream);
}

// Forward plus backward scan of cost (S, L, D) into out (S, L, D) of the same
// storage dtype, in one launch: round(round(fwd) + bwd). ``stash`` is an
// (S, L, D) float32 scratch for dtype 1; dtype 0 stashes in ``out`` and
// ignores it. Returns a cudaError_t.
extern "C" int o3r_scan_pair(const void* cost, void* out, void* stash, int s,
                             int l, int d, int dtype, float p1, float p2,
                             void* stream) {
  return scan(kPair, cost, out, stash, s, l, d, dtype, p1, p2, stream);
}
#endif

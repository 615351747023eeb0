// A stand-in for the CUDA runtime that lets a host compiler build a .cu file
// of this repository and run its kernels on the CPU, warp semantics included:
// one OS thread per CUDA thread of a block (blocks run one after the other),
// a barrier per warp for the shuffles and reductions (every lane of a warp
// must reach them together, as on the card), a barrier per block for
// __syncthreads, real atomics for the reductions. It covers what
// csrc/sgm_scan_pair.cu, csrc/sgm_aggregate.cu, csrc/census_cost.cu,
// csrc/voxel_reduce.cu and csrc/ransac_fit.cu use and no more. A block's
// __shared__ arrays are statics, one copy for the threads of the block
// (blocks run one after the other); __constant__ arrays are plain globals.
// tests/test_torch_kernel_emulation.py and tests/test_torch_tracking_kernels.py
// include it as <cuda_runtime.h>, <cuda_bf16.h> and <cuda_fp16.h> and rewrite
// ``kernel<<<blocks, threads, 0, stream>>>(args)`` to
// ``emu_launch(kernel, blocks, threads, args)``.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <algorithm>
#include <atomic>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __constant__
struct dim3e { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3e threadIdx, blockIdx, blockDim;
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// the round-to-nearest intrinsics: the host's float arithmetic (SSE) rounds so
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
// the reductions: each component added atomically (the card's float4
// reduction is one instruction, but its components do not interact)
inline void atomicAdd(unsigned long long* p, unsigned long long v) {
  std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline void atomicAdd(float4* p, float4 v) {
  std::atomic_ref<float>(p->x).fetch_add(v.x);
  std::atomic_ref<float>(p->y).fetch_add(v.y);
  std::atomic_ref<float>(p->z).fetch_add(v.z);
  std::atomic_ref<float>(p->w).fetch_add(v.w);
}
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
template <typename T> inline T __ldg(const T* p) { return *p; }
template <typename T> inline T __ldcg(const T* p) { return *p; }
inline void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
struct __nv_bfloat16 { unsigned short x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {0x7fff};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
struct __half { unsigned short x; };
// float -> binary16, to nearest, ties to even (subnormals and overflow too)
inline __half __float2half_rn(float f) {
  const unsigned u = __float_as_uint(f), sign = (u >> 16) & 0x8000u, a = u & 0x7fffffffu;
  if (a > 0x7f800000u) return {(unsigned short)(sign | 0x7e00u)};
  if (a >= 0x47800000u) return {(unsigned short)(sign | 0x7c00u)};
  if (a < 0x38800000u)  // below 2^-14: a multiple of 2^-24 (1024 is the least normal)
    return {(unsigned short)(sign | (unsigned)std::nearbyint(__uint_as_float(a) * 16777216.0f))};
  unsigned h = ((((a >> 23) - 112u) << 10) | ((a & 0x7fffffu) >> 13));
  const unsigned rest = a & 0x1fffu;
  if (rest > 0x1000u || (rest == 0x1000u && (h & 1u))) ++h;
  return {(unsigned short)(sign | h)};
}
inline unsigned short __half_as_ushort(__half h) { return h.x; }
inline __half __ushort_as_half(unsigned short b) { return {b}; }
inline float __half2float(__half h) {
  const unsigned sign = (h.x & 0x8000u) << 16, e = (h.x >> 10) & 0x1fu, m = h.x & 0x3ffu;
  if (e == 0) return (sign ? -1.0f : 1.0f) * std::ldexp((float)m, -24);
  if (e == 31) return __uint_as_float(sign | 0x7f800000u | (m << 13));
  return __uint_as_float(sign | ((e + 112u) << 23) | (m << 13));
}

struct BlockCtx {
  int threads;
  std::barrier<> block;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<uint32_t> buf;     // two halves, used in turn by a warp's exchanges
  std::vector<uint64_t> buf64;
  BlockCtx(int t) : threads(t), block(t), buf(2 * t), buf64(2 * t) {
    for (int w = 0; w < t / 32; ++w) warp.emplace_back(new std::barrier<>(32));
  }
};
inline thread_local BlockCtx* g_ctx;
inline void __syncthreads() { g_ctx->block.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_ctx->warp[threadIdx.x / 32]->arrive_and_wait(); }
// A warp's exchange: every lane writes its value, waits for the others, and
// picks. The lanes of a warp make the same exchanges in the same order, and
// consecutive exchanges use the two halves of the buffer in turn, so a lane
// that runs ahead writes the other half while the rest still read: one
// barrier an exchange. A 64-bit value crosses in one exchange (the card moves
// it as two 32-bit halves).
inline thread_local unsigned g_exchanges;
template <typename T, typename F> inline T emu_exchange_in(std::vector<T>& buf, T mine, F pick) {
  int t = threadIdx.x, w = t / 32, lane = t % 32;
  T* half = &buf[(g_exchanges++ & 1u) * g_ctx->threads];
  half[t] = mine;
  g_ctx->warp[w]->arrive_and_wait();
  return pick(&half[w * 32], lane);
}
template <typename F> inline uint32_t emu_exchange(uint32_t mine, F pick) {
  return emu_exchange_in(g_ctx->buf, mine, pick);
}
template <typename F> inline uint64_t emu_exchange64(uint64_t mine, F pick) {
  return emu_exchange_in(g_ctx->buf64, mine, pick);
}
inline uint64_t emu_bits(double v) { uint64_t u; memcpy(&u, &v, 8); return u; }
inline double emu_double(uint64_t u) { double v; memcpy(&v, &u, 8); return v; }
inline double __shfl_xor_sync(unsigned, double v, int m, int = 32) {
  return emu_double(emu_exchange64(emu_bits(v), [&](uint64_t* b, int l) { return b[l ^ m]; }));
}
inline double __shfl_sync(unsigned, double v, int src, int = 32) {
  return emu_double(emu_exchange64(emu_bits(v), [&](uint64_t* b, int) { return b[src & 31]; }));
}
inline float __shfl_xor_sync(unsigned, float v, int m, int = 32) {
  return __uint_as_float(emu_exchange(__float_as_uint(v), [&](uint32_t* b, int l) { return b[l ^ m]; }));
}
inline int __shfl_xor_sync(unsigned, int v, int m, int = 32) {
  return (int)emu_exchange((uint32_t)v, [&](uint32_t* b, int l) { return b[l ^ m]; });
}
inline float __shfl_up_sync(unsigned, float v, int delta, int width = 32) {
  return __uint_as_float(emu_exchange(__float_as_uint(v), [&](uint32_t* b, int l) {
    return (l % width) < delta ? b[l] : b[l - delta]; }));
}
inline float __shfl_down_sync(unsigned, float v, int delta, int width = 32) {
  return __uint_as_float(emu_exchange(__float_as_uint(v), [&](uint32_t* b, int l) {
    return (l % width) + delta >= width ? b[l] : b[l + delta]; }));
}
inline int __reduce_max_sync(unsigned, int v) {
  return (int)emu_exchange((uint32_t)v, [&](uint32_t* b, int) {
    int m = (int)b[0]; for (int i = 1; i < 32; ++i) m = std::max(m, (int)b[i]); return (uint32_t)m; });
}
inline int __reduce_min_sync(unsigned, int v) {
  return (int)emu_exchange((uint32_t)v, [&](uint32_t* b, int) {
    int m = (int)b[0]; for (int i = 1; i < 32; ++i) m = std::min(m, (int)b[i]); return (uint32_t)m; });
}
template <typename K, typename... A>
void emu_launch(K kernel, unsigned blocks, int threads, A... args) {
  for (unsigned b = 0; b < blocks; ++b) {
    BlockCtx ctx(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t]() {
        g_ctx = &ctx; threadIdx.x = t; blockIdx.x = b; blockDim.x = threads;
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}

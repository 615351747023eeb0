// A stand-in for the CUDA runtime that lets a host compiler build a .cu file
// of this repository and run its kernels on the CPU, warp semantics included:
// one OS thread per CUDA thread of a block (blocks run one after the other),
// a barrier per warp for the shuffles and reductions (every lane of a warp
// must reach them together, as on the card), a barrier per block for
// __syncthreads. It covers what csrc/sgm_scan_pair.cu uses and no more.
// tests/test_torch_kernel_emulation.py includes it as <cuda_runtime.h> and
// <cuda_bf16.h> and rewrites ``kernel<<<blocks, threads, 0, stream>>>(args)``
// to ``emu_launch(kernel, blocks, threads, args)``.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <algorithm>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3e { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3e threadIdx, blockIdx, blockDim;
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
template <typename T> inline T __ldg(const T* p) { return *p; }
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

struct BlockCtx {
  int threads;
  std::barrier<> block;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<uint32_t> buf;
  BlockCtx(int t) : threads(t), block(t), buf(t) {
    for (int w = 0; w < t / 32; ++w) warp.emplace_back(new std::barrier<>(32));
  }
};
inline thread_local BlockCtx* g_ctx;
inline void __syncthreads() { g_ctx->block.arrive_and_wait(); }
template <typename F> inline uint32_t emu_exchange(uint32_t mine, F pick) {
  int t = threadIdx.x, w = t / 32, lane = t % 32;
  g_ctx->buf[t] = mine;
  g_ctx->warp[w]->arrive_and_wait();
  uint32_t r = pick(&g_ctx->buf[w * 32], lane);
  g_ctx->warp[w]->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int m, int = 32) {
  return __uint_as_float(emu_exchange(__float_as_uint(v), [&](uint32_t* b, int l) { return b[l ^ m]; }));
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

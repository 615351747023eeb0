// Tracking's RANSAC draw (K6) and its IRLS rigid fit (K7) for Hopper (sm_90a),
// as odometry/rigid.py computes them: K6 is hypothesis_indices_plain bit for
// bit, K7 is irls_fit_plain to float32 rounding.
//
// Replace no TPU kernel: the reference's draw and fit are XLA
// (online_3d_reconstruction_tpu/odometry/rigid.py: jax.random.randint,
// rigid_transform over a jnp.linalg.svd). The port's plain forms are chains
// of scalar tensor operations: the draw is three threefry2x32 hashes of
// ~170 int64 elementwise passes each, the fit four weighted Umeyama fits of
// ~100 passes each, most of them 24 dependent 4x4 float64 products. Inside
// the step's CUDA graph every pass is a node of ~2 us, so tracking took
// ~1000 nodes a frame for ~14 KB of data.
//
// What bounds them on the H100: latency, not bytes. At N = 512 matches the
// fit reads ~14 KB (positions, weights, masks) and the draw writes 3 KB, a
// few nanoseconds at 3.35 TB/s. K7's time is its dependent chain: 4 fits x
// (3 block sums + 24 trace-normalised 4x4 float64 squarings, each a few
// shuffles, a division and four dependent multiply-adds). K6's is one
// thread's five threefry hashes.
//
// K6 (o3r_ransac_draw): jax.random.randint(fold_in(PRNGKey(seed), frame),
// (iters, 3), 0, n) under jax_threefry_partitionable, one thread per value.
// Each thread hashes the fold-in and the split itself (five 20-round
// threefry2x32 hashes in uint32: cheaper than a barrier), then randint's
// double-width modulus: (higher % n * multiplier + lower % n) % n with
// multiplier = (2^16 % n)^2 % n, in uint32 arithmetic. The frame index is
// read on the device (the 0-dim int64 that unpack_frame gives), so a graph
// replay needs no host value; seed, n and the multiplier are launch
// arguments.
//
// K7 (o3r_rigid_irls): one block of 256 threads. Fit 0 on best_mask *
// weights, fits 1-3 on the Huber weights of the fit before times valid times
// weights, then those weights of fit 3 written out. A fit as rigid_transform
// does it: the block sums w (clamped below at 1e-9), then the centroids of
// the points weighted by w / sum, then the 3x3 covariance of the centred
// points with those weights; float32 sums, in another order than the plain
// form's. Each sum is a shuffle tree per warp and one barrier, after which
// every thread adds the warps' partial sums itself. Then warp 0 takes Horn's
// symmetric 4x4 matrix N(cov) in float64, one entry a lane (16 lanes; the
// upper half of the warp mirrors the lower), shifts it by |N|_F + 1e-300 and
// squares it 24 times, each square divided by the square of its base's
// trace (the first base divided by its trace before it is squared, as the
// plain form does every time, whatever N's scale). The trace comes from the
// four diagonal lanes, and from the second square on its division runs
// beside the product's shuffles instead of before them. The column of the largest
// diagonal (the first on ties) is the quaternion; nine lanes form R
// (float32) and three t = c_d - R c_s in shared memory, for the next fit's
// weights. The weights are never stored: each pass recomputes them from the
// fit before, so any N runs in the block-stride loops and only T and the
// final weights leave the block. Alone at N = 512 on the H100 it takes
// ~29 us: ~13 us for the passes and sums, the rest Horn's squarings.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDrawThreads = 128;
constexpr int kFitThreads = 256;
constexpr int kWarps = kFitThreads / 32;
constexpr int kIrlsSteps = 3;    // the refit on the best inliers, then these
constexpr int kSquarings = 24;   // odometry/rigid.py _SQUARINGS
constexpr unsigned kFull = 0xffffffffu;

// N[e] = sum_k cov[k] kHorn[e][k], e = 4a + b, k = 3i + j (rigid._horn_tables)
__constant__ signed char kHorn[16][9] = {
    {1, 0, 0, 0, 1, 0, 0, 0, 1},   {0, 0, 0, 0, 0, 1, 0, -1, 0},
    {0, 0, -1, 0, 0, 0, 1, 0, 0},  {0, 1, 0, -1, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 1, 0, -1, 0},  {1, 0, 0, 0, -1, 0, 0, 0, -1},
    {0, 1, 0, 1, 0, 0, 0, 0, 0},   {0, 0, 1, 0, 0, 0, 1, 0, 0},
    {0, 0, -1, 0, 0, 0, 1, 0, 0},  {0, 1, 0, 1, 0, 0, 0, 0, 0},
    {-1, 0, 0, 0, 1, 0, 0, 0, -1}, {0, 0, 0, 0, 0, 1, 0, 1, 0},
    {0, 1, 0, -1, 0, 0, 0, 0, 0},  {0, 0, 1, 0, 0, 0, 1, 0, 0},
    {0, 0, 0, 0, 0, 1, 0, 1, 0},   {-1, 0, 0, 0, -1, 0, 0, 0, 1}};
// R[e] = sum_ab q_a q_b kQuat[e][4a + b], e = 3i + j
__constant__ signed char kQuat[9][16] = {
    {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 0, 0, 0, 0, -1},
    {0, 0, 0, -2, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 2, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 2, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1},
    {0, -2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0},
    {0, 0, -2, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0},
    {1, 0, 0, 0, 0, -1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1}};

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 (20 rounds) of the count (x0, x1) under the key (k0, k1), in place
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1, unsigned& x0,
                                             unsigned& x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
}

__global__ void __launch_bounds__(kDrawThreads)
ransac_draw_kernel(const long long* __restrict__ frame_idx, long long* __restrict__ out,
                   unsigned seed, unsigned n, unsigned multiplier, int total) {
  const int c = blockIdx.x * kDrawThreads + threadIdx.x;
  if (c >= total) return;
  // fold_in: PRNGKey(seed) = (0, seed) hashes the count (0, frame mod 2^32)
  unsigned f0 = 0u, f1 = static_cast<unsigned>(*frame_idx);
  threefry2x32(0u, seed, f0, f1);
  // split: key i is the hash of the count (0, i)
  unsigned h0 = 0u, h1 = 0u, l0 = 0u, l1 = 1u;
  threefry2x32(f0, f1, h0, h1);
  threefry2x32(f0, f1, l0, l1);
  // 32 bits of each key for the count (0, c): higher from key 0, lower from key 1
  unsigned a0 = 0u, a1 = static_cast<unsigned>(c), b0 = 0u, b1 = static_cast<unsigned>(c);
  threefry2x32(h0, h1, a0, a1);
  threefry2x32(l0, l1, b0, b1);
  const unsigned higher = a0 ^ a1, lower = b0 ^ b1;
  out[c] = static_cast<long long>((higher % n * multiplier + lower % n) % n);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// The IRLS weight of match i under the fit t (R row-major, then t):
// torch.where(r <= huber, 1, huber / clamp(r, 1e-9)) * valid * weight
__device__ __forceinline__ float huber_weight(const float* t, const float* __restrict__ src,
                                              const float* __restrict__ dst,
                                              const uint8_t* __restrict__ valid,
                                              const float* __restrict__ weights, int i,
                                              float huber) {
  float r2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = src[3 * i] * t[3 * a] + src[3 * i + 1] * t[3 * a + 1] +
                    src[3 * i + 2] * t[3 * a + 2] + t[9 + a];
    const float d = p - dst[3 * i + a];
    r2 += d * d;
  }
  const float r = sqrtf(r2);
  const float h = r <= huber ? 1.0f : huber / clamp_min(r, 1e-9f);
  return h * (valid[i] != 0 ? 1.0f : 0.0f) * weights[i];
}

// Sums each of v[0..K) over the block into every thread's v: a shuffle tree
// in each warp, then each thread adds up the warps' sums from red (kWarps x
// 9 floats of shared memory that no other sum of the same fit uses, so one
// barrier a sum is enough).
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*red)[9]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[threadIdx.x / 32][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][k];
    v[k] = s;
  }
}

// Warp 0's 4x4 float64 matrix, one entry a lane (lane & 15 = 4 row + col):
// its trace, from the four diagonal lanes, and its square
__device__ __forceinline__ double trace4(double m) {
  return (__shfl_sync(kFull, m, 0) + __shfl_sync(kFull, m, 5)) +
         (__shfl_sync(kFull, m, 10) + __shfl_sync(kFull, m, 15));
}

__device__ __forceinline__ double square4(double m, int row, int col) {
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc += __shfl_sync(kFull, m, 4 * row + k) * __shfl_sync(kFull, m, 4 * k + col);
  }
  return acc;
}

// rigid_transform's best_rotation and translation, by warp 0 (all 32 lanes):
// R (row-major) and t into fit[12]
__device__ void horn_fit(const float (&cov)[9], const float (&c)[6], float* fit) {
  const int lane = threadIdx.x, l = lane & 15, row = l >> 2, col = l & 3;
  double m = 0.0;
#pragma unroll
  for (int k = 0; k < 9; ++k) m += static_cast<double>(cov[k]) * kHorn[l][k];
  double sq = m * m;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) sq += __shfl_xor_sync(kFull, sq, off);
  if (row == col) m += sqrt(sq) + 1e-300;
  // the first square of N divided by its trace, whatever N's scale; from
  // then on the trace lies in [1/4, 1] (a positive semi-definite matrix of
  // trace 1 squared), so each square is formed while the division by the
  // trace's square, which it does not wait for, runs beside it
  m = square4(m / trace4(m), row, col);
  for (int s = 1; s < kSquarings; ++s) {
    const double tr = trace4(m);
    const double scale = 1.0 / (tr * tr);
    m = square4(m, row, col) * scale;
  }
  // the column of the largest diagonal (the first on ties, as argmax)
  double top = __shfl_sync(kFull, m, 0);
  int best = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const double d = __shfl_sync(kFull, m, 5 * k);
    if (d > top) {
      top = d;
      best = k;
    }
  }
  double q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __shfl_sync(kFull, m, 4 * k + best);
  const double norm = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / norm;
  if (lane < 9) {
    double r = 0.0;
#pragma unroll
    for (int ab = 0; ab < 16; ++ab) r += (q[ab >> 2] * q[ab & 3]) * kQuat[lane][ab];
    fit[lane] = static_cast<float>(r);
  }
  __syncwarp();
  if (lane < 3) {
    fit[9 + lane] = c[3 + lane] - (fit[3 * lane] * c[0] + fit[3 * lane + 1] * c[1] +
                                   fit[3 * lane + 2] * c[2]);
  }
}

__global__ void __launch_bounds__(kFitThreads)
rigid_irls_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                  const uint8_t* __restrict__ best_mask, const uint8_t* __restrict__ valid,
                  const float* __restrict__ weights, float huber, int n,
                  float* __restrict__ out_t, float* __restrict__ out_w) {
  __shared__ float red[3][kWarps][9];   // one per sum of a fit
  __shared__ float fit[12];
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int f = 0; f <= kIrlsSteps; ++f) {
    // fit 0 weighs the best hypothesis' inliers, the others the last fit's
    // Huber weights; ``fit`` is read here and rewritten only after the
    // barriers of this fit's sums
    auto weight = [&](int i) -> float {
      return f == 0 ? (best_mask[i] != 0 ? 1.0f : 0.0f) * weights[i]
                    : huber_weight(fit, src, dst, valid, weights, i, huber);
    };
    float total[1] = {0.0f};
    for (int i = tid; i < n; i += kFitThreads) total[0] += weight(i);
    block_sum(total, red[0]);
    const float denom = clamp_min(total[0], 1e-9f);
    float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = tid; i < n; i += kFitThreads) {
      const float wn = weight(i) / denom;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        c[a] += src[3 * i + a] * wn;
        c[3 + a] += dst[3 * i + a] * wn;
      }
    }
    block_sum(c, red[1]);
    float cov[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = tid; i < n; i += kFitThreads) {
      const float wn = weight(i) / denom;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float s = (src[3 * i + a] - c[a]) * wn;
#pragma unroll
        for (int b = 0; b < 3; ++b) cov[3 * a + b] += s * (dst[3 * i + b] - c[3 + b]);
      }
    }
    block_sum(cov, red[2]);
    if (tid < 32) horn_fit(cov, c, fit);
    __syncthreads();
  }
  for (int i = tid; i < n; i += kFitThreads) {
    out_w[i] = huber_weight(fit, src, dst, valid, weights, i, huber);
  }
  if (tid < 16) {
    const int a = tid >> 2, b = tid & 3;
    out_t[tid] = a == 3 ? (b == 3 ? 1.0f : 0.0f) : (b == 3 ? fit[9 + a] : fit[3 * a + b]);
  }
}

}  // namespace

// frame_idx: a 0-dim int64 on the device; out: (total,) int64, written whole
// (total = 3 iters). 0 <= seed < 2^32, 1 <= n < 2^32, multiplier = (2^16 % n)^2
// % n.
extern "C" int o3r_ransac_draw(const void* frame_idx, void* out, long long seed, long long n,
                               long long multiplier, int total, void* stream) {
  if (seed < 0 || seed > 0xffffffffLL || n < 1 || n > 0xffffffffLL || multiplier < 0 ||
      multiplier >= n || total < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((total + kDrawThreads - 1) / kDrawThreads);
  ransac_draw_kernel<<<blocks, kDrawThreads, 0, s>>>(
      static_cast<const long long*>(frame_idx), static_cast<long long*>(out),
      static_cast<unsigned>(seed), static_cast<unsigned>(n),
      static_cast<unsigned>(multiplier), total);
  return static_cast<int>(cudaGetLastError());
}

// src, dst: contiguous (n, 3) float32; best_mask, valid: (n,) bool as bytes;
// weights: (n,) float32; out_t: (4, 4) float32 and out_w: (n,) float32,
// written whole. huber: the threshold in float32.
extern "C" int o3r_rigid_irls(const void* src, const void* dst, const void* best_mask,
                              const void* valid, const void* weights, float huber, int n,
                              void* out_t, void* out_w, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rigid_irls_kernel<<<1, kFitThreads, 0, s>>>(
      static_cast<const float*>(src), static_cast<const float*>(dst),
      static_cast<const uint8_t*>(best_mask), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(weights), huber, n, static_cast<float*>(out_t),
      static_cast<float*>(out_w));
  return static_cast<int>(cudaGetLastError());
}

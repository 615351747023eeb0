// Voxel-grid reduction (K5) for Hopper (sm_90a): a pool of n points (float32
// positions, float32 colors, bool validity) in, one centroid per occupied
// voxel out, in the pool's first slots in key order, the rest zero and
// invalid, as mapping/voxel.py::voxel_downsample_plain computes it.
//
// Replaces no TPU kernel: the reference's voxel_downsample
// (online_3d_reconstruction_tpu/mapping/voxel.py) is XLA. It was added
// because the profile of the EuRoC cell's flush frames named PyTorch's
// index_add_ (indexFuncLargeIndex) as their top device operation: one float
// atomicAdd per element and column, and every invalid slot of the pool adds
// a zero to the sentinel voxel's few addresses, so a mostly empty 2M pool
// queues about two million atomics on each of them.
//
// Semantics. Keys as PyTorch computes them on the card: floor((p + bounds) *
// inv) in float32, inv the float32 reciprocal of the voxel size (PyTorch's
// CUDA division by a scalar multiplies by its reciprocal; its CPU division
// divides), cast to int64, packed (ix * per_axis + iy) * per_axis + iz, and
// INT64_MAX (the sentinel) where a point is invalid or out of [0, per_axis).
// After the caller's stable sort, each voxel's points are summed from 0.0f in
// sorted order, which is input order within a voxel, one add at a time, as
// the CPU's index_add_ does, then divided by their count with IEEE division.
// So the centroids are bit-equal to the plain form on the CPU given the same
// keys, and equal from run to run. The sentinel run is never read: its slot
// and every slot past the last voxel are written as zero and invalid.
//
// What bounds it on the H100: bytes. The reduction must read the pool
// (positions, colors, validity: 25 bytes a slot) and write the same: 100 MB,
// 0.030 ms at 3.35 TB/s for the 2M pool. Its own passes add the int64 keys
// (written once, read back sorted with the order) and a 32-bit slot index.
//
// Design: three launches around two library calls (the caller's):
//   o3r_voxel_keys     one pass over positions and validity: the int64 keys;
//   (torch.sort, stable: the keys sorted and their order)
//   o3r_voxel_heads    1 where a run of equal keys starts, 0 elsewhere and
//                      on the sentinel run;
//   (torch.cumsum of those flags: each run's output slot + 1)
//   o3r_voxel_reduce   one thread per sorted position: the first of a run
//                      walks its run in sorted order and writes the centroid
//                      at its slot; a thread whose position lies past the
//                      last run zero-fills that slot.
// Run lengths: about 2 entries a voxel in a main pool that is downsampled
// after nearly every flush, tens in a staging pool. A thread first finds its
// run's end on the sorted keys (contiguous), then gathers its points with a
// known trip count, unrolled, so the gathers of one run are in flight
// together while the adds stay in order. A very long run is walked by one
// thread: the bits ask for its adds one after another, so its cost grows
// with its length and with nothing else.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSentinel = 0x7fffffffffffffffLL;

__global__ void __launch_bounds__(kThreads)
voxel_keys_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
                  long long* __restrict__ key, long long n, float bounds, float inv,
                  long long per_axis) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  long long k = kSentinel;
  if (valid[i] != 0) {
    long long c[3];
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float q = __fmul_rn(__fadd_rn(points[3 * i + a], bounds), inv);
      c[a] = static_cast<long long>(floorf(q));
      inside = inside && c[a] >= 0 && c[a] < per_axis;
    }
    if (inside) k = (c[0] * per_axis + c[1]) * per_axis + c[2];
  }
  key[i] = k;
}

__global__ void __launch_bounds__(kThreads)
voxel_heads_kernel(const long long* __restrict__ key_s, int* __restrict__ head, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long k = key_s[i];
  head[i] = k != kSentinel && (i == 0 || key_s[i - 1] != k);
}

__global__ void __launch_bounds__(kThreads)
voxel_reduce_kernel(const long long* __restrict__ key_s, const long long* __restrict__ order,
                    const int* __restrict__ slot, const float* __restrict__ points,
                    const float* __restrict__ colors, float* __restrict__ out_points,
                    float* __restrict__ out_colors, uint8_t* __restrict__ out_valid,
                    long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int runs = slot[n - 1];
  if (i >= runs) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      out_points[3 * i + a] = 0.0f;
      out_colors[3 * i + a] = 0.0f;
    }
    out_valid[i] = 0;
  }
  const int o = slot[i] - 1;   // this position's run's slot
  if (i > 0 && slot[i - 1] - 1 == o) return;   // not the first of a run (or sentinel)
  if (o < 0) return;                            // the sentinel run at position 0
  const long long k = key_s[i];
  long long end = i + 1;
  while (end < n && key_s[end] == k) ++end;
  float p[3] = {0.0f, 0.0f, 0.0f}, c[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (long long j = i; j < end; ++j) {
    const long long s = order[j];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      p[a] = __fadd_rn(p[a], points[3 * s + a]);
      c[a] = __fadd_rn(c[a], colors[3 * s + a]);
    }
  }
  const float count = static_cast<float>(end - i);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out_points[3LL * o + a] = __fdiv_rn(p[a], count);
    out_colors[3LL * o + a] = __fdiv_rn(c[a], count);
  }
  out_valid[o] = 1;
}

bool bad_length(long long n) { return n < 0 || n >= (1LL << 31); }

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// points: contiguous (n, 3) float32; valid: (n,) bool as bytes; key: (n,)
// int64, written whole. bounds and inv in float32 (inv = 1 / voxel size,
// rounded to float32); 1 <= per_axis and per_axis^3 fits int64.
extern "C" int o3r_voxel_keys(const void* points, const void* valid, void* key, long long n,
                              float bounds, float inv, long long per_axis, void* stream) {
  if (bad_length(n) || per_axis < 1 || per_axis > (1LL << 21)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  voxel_keys_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
      static_cast<long long*>(key), n, bounds, inv, per_axis);
  return static_cast<int>(cudaGetLastError());
}

// key_s: the (n,) int64 keys sorted; head: (n,) int32, written whole.
extern "C" int o3r_voxel_heads(const void* key_s, void* head, long long n, void* stream) {
  if (bad_length(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  voxel_heads_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const long long*>(key_s), static_cast<int*>(head), n);
  return static_cast<int>(cudaGetLastError());
}

// key_s, order: the stable sort's keys and int64 indices; slot: (n,) int32,
// the inclusive sum of o3r_voxel_heads' flags; points, colors: contiguous
// (n, 3) float32 in input order; out_points, out_colors (n, 3) float32 and
// out_valid (n,) bool, written whole.
extern "C" int o3r_voxel_reduce(const void* key_s, const void* order, const void* slot,
                                const void* points, const void* colors, void* out_points,
                                void* out_colors, void* out_valid, long long n, void* stream) {
  if (bad_length(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  voxel_reduce_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const long long*>(key_s), static_cast<const long long*>(order),
      static_cast<const int*>(slot), static_cast<const float*>(points),
      static_cast<const float*>(colors), static_cast<float*>(out_points),
      static_cast<float*>(out_colors), static_cast<uint8_t*>(out_valid), n);
  return static_cast<int>(cudaGetLastError());
}

// Speckle-filter run totals, for Hopper (sm_90a).
//
// Replaces: online_3d_reconstruction_tpu/stereo/sgm_pallas.py::_run_total_kernel
// (driven by _run_total_call -> speckle_filter_pallas). For every pixel it
// computes the sum of v over the pixel's maximal run along one axis: a
// segmented inclusive forward scan from the start flags, plus a segmented
// inclusive backward scan from the end flags (a run ends where the next
// pixel starts one, and at the last pixel), minus the pixel itself. The TPU
// kernel holds the whole frame in VMEM and runs unrolled Hillis-Steele
// sweeps over it.
//
// What bounds it on the H100: bytes, and few of them. A call must read v and
// the start flags and write the output, 12 bytes per pixel: 2.36 MB at
// 384x512, 0.7 us at 3.35 TB/s, so a call is never far above the cost of
// launching it. What a design can lose is parallelism and round trips: a
// line walked by one thread is hundreds of dependent global accesses.
//
// Design: a line is kept on chip for both directions and every array crosses
// the memory bus once. One warp takes one line in tiles of 512 pixels, 16
// consecutive pixels a lane in registers. A lane scans its 16 values
// serially; the lanes' (sum, flag) totals are combined by one segmented warp
// scan per direction with the associative operator
//     (s1, f1) + (s2, f2) = (f2 ? s2 : s1 + s2, f1 | f2)
// which gives each lane the carry entering its chunk; a second serial walk
// from that carry yields fwd and bwd, and fwd + bwd - v is written once: the
// output is never read back. A line longer than one tile (up to 32 tiles)
// first reduces each tile to its (sum, flag) total, scans those across the
// lanes the same way, and then walks the tiles again with their carries.
// - rows (axis 1): 16 contiguous floats a lane, loaded as four float4 where
//   the row is 16-byte aligned; one warp per row.
// - columns (axis 0): a block of 8 warps takes a strip of 8 columns through
//   shared memory. All 256 threads load the strip row by row (32 contiguous
//   bytes per row), then each warp scans one column out of shared memory
//   (chunks 17 words apart, so the lanes hit distinct banks), writes its
//   result back there, and the block stores the strip row by row: 64 blocks
//   at W = 512 instead of one thread per column on 4 blocks.
// The values are integers (pixel counts) below 2^24, so every f32 sum is
// exact whatever the order of the additions: bit-equal to the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 16;               // pixels per lane
constexpr int kTile = 32 * kChunk;       // pixels per warp and tile
constexpr int kMaxTiles = 32;            // one tile total per lane
constexpr int kRowThreads = 128;         // rows kernel: 4 rows per block
constexpr int kStripCols = 8;            // columns kernel: columns per block
constexpr int kColThreads = 32 * kStripCols;
constexpr int kChunkStride = kChunk + 1;  // odd: conflict-free shared reads
// words per column: 4 mod 32, so the 8 columns x 4 rows a warp moves at once
// fall into 32 distinct banks
constexpr int kColWords = 32 * kChunkStride + 4;

// Inclusive segmented scan of (sum, flag) across the lanes, toward higher
// lanes (kReverse = false) or lower lanes (true).
template <bool kReverse>
__device__ __forceinline__ void warp_segmented_scan(float& sum, int& flag,
                                                    int lane) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const float s = kReverse ? __shfl_down_sync(kFullMask, sum, k)
                             : __shfl_up_sync(kFullMask, sum, k);
    const int f = kReverse ? __shfl_down_sync(kFullMask, flag, k)
                           : __shfl_up_sync(kFullMask, flag, k);
    const bool has = kReverse ? lane + k < 32 : lane >= k;
    if (has) {
      if (!flag) sum += s;
      flag |= f;
    }
  }
}

// The carry entering each lane from before it (after it when kReverse):
// the exclusive segmented scan, seeded with ``outer`` (the carry entering
// the whole warp) where no flag intervenes. Also returns the warp's total.
template <bool kReverse>
__device__ __forceinline__ float lane_carry(float sum, int flag, float outer,
                                            int lane, float* total_sum,
                                            int* total_flag) {
  warp_segmented_scan<kReverse>(sum, flag, lane);
  const int last = kReverse ? 0 : 31;
  *total_sum = __shfl_sync(kFullMask, sum, last);
  *total_flag = __shfl_sync(kFullMask, flag, last);
  float s = kReverse ? __shfl_down_sync(kFullMask, sum, 1)
                     : __shfl_up_sync(kFullMask, sum, 1);
  int f = kReverse ? __shfl_down_sync(kFullMask, flag, 1)
                   : __shfl_up_sync(kFullMask, flag, 1);
  if (lane == (kReverse ? 31 : 0)) {
    s = 0.f;
    f = 0;
  }
  return f ? s : s + outer;
}

// One tile of one line in a warp's registers. ``starts`` bit j: pixel j of
// this lane's chunk starts a run; bit kChunk: the pixel after the chunk does
// (pixels past the line's end count as starts, and hold 0).
struct Tile {
  float v[kChunk];
  unsigned starts;
};

// This lane's chunk walked from a zero carry in both directions: the sum
// since its last start (fwd) and the sum up to its first end (bwd), with
// whether it holds a start, and an end (the pixel after an end is a start).
__device__ __forceinline__ void chunk_totals(const Tile& t, float* fwd,
                                             int* fwd_flag, float* bwd,
                                             int* bwd_flag) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    acc = (t.starts >> j & 1u) ? t.v[j] : acc + t.v[j];
  }
  *fwd = acc;
  *fwd_flag = (t.starts & 0xffffu) != 0;
  acc = 0.f;
#pragma unroll
  for (int j = kChunk - 1; j >= 0; --j) {
    acc = (t.starts >> (j + 1) & 1u) ? t.v[j] : acc + t.v[j];
  }
  *bwd = acc;
  *bwd_flag = (t.starts >> 1 & 0xffffu) != 0;
}

// Totals of the tile for the line-level scan: forward (sum since the last
// start, any start) and backward (sum up to the first end, any end).
__device__ __forceinline__ void tile_totals(const Tile& t, int lane, float* fs,
                                            int* ff, float* bs, int* bf) {
  float fwd, bwd;
  int fwd_flag, bwd_flag;
  chunk_totals(t, &fwd, &fwd_flag, &bwd, &bwd_flag);
  lane_carry<false>(fwd, fwd_flag, 0.f, lane, fs, ff);
  lane_carry<true>(bwd, bwd_flag, 0.f, lane, bs, bf);
}

// Replaces t.v by the run totals, given the carries entering the tile from
// the pixels before it (fwd_in) and after it (bwd_in).
__device__ __forceinline__ void tile_run_totals(Tile& t, int lane, float fwd_in,
                                                float bwd_in) {
  float fwd, bwd, ts;
  int fwd_flag, bwd_flag, tf;
  chunk_totals(t, &fwd, &fwd_flag, &bwd, &bwd_flag);
  float carry = lane_carry<false>(fwd, fwd_flag, fwd_in, lane, &ts, &tf);
  float out[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    carry = (t.starts >> j & 1u) ? t.v[j] : carry + t.v[j];
    out[j] = carry;  // fwd
  }
  carry = lane_carry<true>(bwd, bwd_flag, bwd_in, lane, &ts, &tf);
#pragma unroll
  for (int j = kChunk - 1; j >= 0; --j) {
    carry = (t.starts >> (j + 1) & 1u) ? t.v[j] : carry + t.v[j];
    out[j] = out[j] + carry - t.v[j];  // fwd + bwd - v
  }
#pragma unroll
  for (int j = 0; j < kChunk; ++j) t.v[j] = out[j];
}

// Runs a whole line of n pixels through a warp. load(tile_index, Tile&)
// fills the registers, store(tile_index, const Tile&) writes the result;
// both are called by all 32 lanes of the warp, once per tile and pass.
template <typename Load, typename Store>
__device__ __forceinline__ void line_run_total(int n, int lane, Load load,
                                               Store store) {
  const int n_tiles = (n + kTile - 1) / kTile;
  Tile t;
  if (n_tiles == 1) {
    load(0, t);
    tile_run_totals(t, lane, 0.f, 0.f);
    store(0, t);
    return;
  }
  // lane i keeps tile i's totals, then its carries
  float fwd = 0.f, bwd = 0.f;
  int fwd_flag = 1, bwd_flag = 1;
  for (int i = 0; i < n_tiles; ++i) {
    float fs, bs;
    int ff, bf;
    load(i, t);
    tile_totals(t, lane, &fs, &ff, &bs, &bf);
    if (lane == i) {
      fwd = fs;
      fwd_flag = ff;
      bwd = bs;
      bwd_flag = bf;
    }
  }
  float ts;
  int tf;
  fwd = lane_carry<false>(fwd, fwd_flag, 0.f, lane, &ts, &tf);
  bwd = lane_carry<true>(bwd, bwd_flag, 0.f, lane, &ts, &tf);
  for (int i = 0; i < n_tiles; ++i) {
    load(i, t);
    tile_run_totals(t, lane, __shfl_sync(kFullMask, fwd, i),
                    __shfl_sync(kFullMask, bwd, i));
    store(i, t);
  }
}

__global__ void __launch_bounds__(kRowThreads) run_total_rows_kernel(
    const float* __restrict__ v, const float* __restrict__ start,
    float* __restrict__ out, int h, int w) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= h) return;  // uniform across the warp
  const float* vr = v + (long long)row * w;
  const float* sr = start + (long long)row * w;
  float* outr = out + (long long)row * w;
  // float4 moves need every row 16-byte aligned
  const bool vec = (w & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(start) |
        reinterpret_cast<uintptr_t>(out)) & 15u) == 0;

  auto load = [&](int tile, Tile& t) {
    const int i0 = tile * kTile + lane * kChunk;
    t.starts = 0u;
    if (vec && i0 + kChunk <= w) {
#pragma unroll
      for (int j = 0; j < kChunk; j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(vr + i0 + j);
        const float4 s = *reinterpret_cast<const float4*>(sr + i0 + j);
        t.v[j] = a.x;
        t.v[j + 1] = a.y;
        t.v[j + 2] = a.z;
        t.v[j + 3] = a.w;
        t.starts |= (unsigned)(s.x > 0.5f) << j | (unsigned)(s.y > 0.5f) << (j + 1) |
                    (unsigned)(s.z > 0.5f) << (j + 2) | (unsigned)(s.w > 0.5f) << (j + 3);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const bool in = i0 + j < w;
        t.v[j] = in ? vr[i0 + j] : 0.f;
        t.starts |= (unsigned)(in ? sr[i0 + j] > 0.5f : true) << j;
      }
    }
    const int nxt = i0 + kChunk;
    t.starts |= (unsigned)(nxt < w ? sr[nxt] > 0.5f : true) << kChunk;
  };
  auto store = [&](int tile, const Tile& t) {
    const int i0 = tile * kTile + lane * kChunk;
    if (vec && i0 + kChunk <= w) {
#pragma unroll
      for (int j = 0; j < kChunk; j += 4) {
        *reinterpret_cast<float4*>(outr + i0 + j) =
            make_float4(t.v[j], t.v[j + 1], t.v[j + 2], t.v[j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (i0 + j < w) outr[i0 + j] = t.v[j];
      }
    }
  };
  line_run_total(w, lane, load, store);
}

__global__ void __launch_bounds__(kColThreads) run_total_cols_kernel(
    const float* __restrict__ v, const float* __restrict__ start,
    float* __restrict__ out, int h, int w) {
  // [column][chunk * 17 + j]: a column's 512 tile pixels, chunks skewed
  __shared__ float sv[kStripCols * kColWords];
  __shared__ unsigned char ss[kStripCols * kColWords];
  const int col0 = blockIdx.x * kStripCols;
  const int warp = threadIdx.x >> 5;  // the column of the strip this warp scans
  const int lane = threadIdx.x & 31;
  const int c_ld = threadIdx.x % kStripCols;  // this thread's column when moving rows
  const int r_ld = threadIdx.x / kStripCols;
  const bool col_ok = col0 + c_ld < w;

  auto load = [&](int tile, Tile& t) {
    __syncthreads();  // the previous tile's shared data is no longer needed
    for (int r = r_ld; r < kTile; r += kColThreads / kStripCols) {
      const int i = tile * kTile + r;
      const bool in = col_ok && i < h;
      const long long p = (long long)i * w + col0 + c_ld;
      const int at = c_ld * kColWords + (r / kChunk) * kChunkStride + r % kChunk;
      sv[at] = in ? v[p] : 0.f;
      ss[at] = in ? start[p] > 0.5f : 1;
    }
    __syncthreads();
    const int at = warp * kColWords + lane * kChunkStride;
    t.starts = 0u;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      t.v[j] = sv[at + j];
      t.starts |= (unsigned)ss[at + j] << j;
    }
    // the pixel after the chunk: the next lane's first, or the next tile's
    unsigned nxt = __shfl_down_sync(kFullMask, t.starts & 1u, 1);
    if (lane == 31) {
      const int i = (tile + 1) * kTile;
      nxt = (col0 + warp < w && i < h)
                ? start[(long long)i * w + col0 + warp] > 0.5f : 1u;
    }
    t.starts |= nxt << kChunk;
  };
  auto store = [&](int tile, const Tile& t) {
    const int at = warp * kColWords + lane * kChunkStride;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) sv[at + j] = t.v[j];
    __syncthreads();
    for (int r = r_ld; r < kTile; r += kColThreads / kStripCols) {
      const int i = tile * kTile + r;
      if (col_ok && i < h) {
        out[(long long)i * w + col0 + c_ld] =
            sv[c_ld * kColWords + (r / kChunk) * kChunkStride + r % kChunk];
      }
    }
  };
  line_run_total(h, lane, load, store);
}

}  // namespace

// out (H, W) = run totals of v (H, W) along ``axis`` (0: columns, 1: rows)
// with runs split at start (H, W) flags > 0.5. All float32, contiguous; the
// line length (H for axis 0, W for axis 1) is at most 16384. out must not
// alias v or start. Returns a cudaError_t.
extern "C" int o3r_run_total(const void* v, const void* start, void* out,
                             int h, int w, int axis, void* stream) {
  const auto* vp = static_cast<const float*>(v);
  const auto* sp = static_cast<const float*>(start);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || (axis == 1 ? w : h) > kTile * kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (axis == 1) {
    const int blocks = (h * 32 + kRowThreads - 1) / kRowThreads;
    run_total_rows_kernel<<<blocks, kRowThreads, 0, s>>>(vp, sp, op, h, w);
  } else if (axis == 0) {
    const int blocks = (w + kStripCols - 1) / kStripCols;
    run_total_cols_kernel<<<blocks, kColThreads, 0, s>>>(vp, sp, op, h, w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

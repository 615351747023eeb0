// Census transform and Hamming cost volume in one launch, for Hopper (sm_90a):
// two rectified (H, W) float32 images in, the uint8 (H, W, D) cost volume
// that K1 (sgm_aggregate.cu) reads out.
//
// Replaces no TPU kernel: the reference builds the codes and the volume as
// XLA elementwise operations (online_3d_reconstruction_tpu/stereo/census.py:
// census_transform, cost_volume), and the port's plain version
// (stereo/census.py) is a chain of about 220 int64 tensor passes a frame,
// each reading and writing the whole int64 volume (100.7 MB at
// 384x512x64). Here the codes are uint32 and never leave the chip.
//
// Semantics (bit-equal to census_transform + cost_volume + uint8): one code
// bit per non-centre neighbour of the wh x ww window, row-major, 1 iff
// neighbour < centre compared in float32, borders edge-replicated;
// cost[y, x, d] = popc(L[y, x] ^ R[y, x - d]), and OUT_OF_IMAGE_COST (32)
// where x - d < 0.
//
// What bounds it on the H100: bytes. It must read the two images (8 bytes a
// pixel) and write the volume (D bytes a pixel): 14.2 MB at 384x512x64,
// 4.2 us at 3.35 TB/s. The work beside the bytes is one XOR and one popcount
// a volume byte and 24 compares a code.
//
// Design: a block owns kTileW pixels of one row. It computes the left codes
// of its pixels and the right codes of the columns they reach (kTileW + D -
// 1 at most, none left of the image) into shared memory, each code once,
// its window read through the read-only cache (the rows are shared with the
// neighbouring blocks there). Then its threads write the tile's kTileW * D
// bytes, which are contiguous in the volume: where D is a multiple of 16
// and the volume starts on 16 bytes, each thread forms 16 consecutive
// disparities of one pixel and stores them as one 16-byte store, and
// neighbouring threads store neighbouring 16 bytes, so a warp writes 512
// contiguous bytes at once. Any other D, or a volume off 16 bytes, takes the
// same 16-byte pieces aligned in memory, computed byte by byte, with the
// tile's ragged first and last bytes stored one at a time. A window of 5 x 5
// (the configurations') has its compare loop unrolled at compile time; any
// other window runs the same loop with its radii read at run time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;          // pixels of one row per block
constexpr int kThreads = 256;
constexpr int kMaxD = 256;           // K1's limit too
constexpr unsigned kOutOfImage = 32u;  // stereo/census.py OUT_OF_IMAGE_COST

__device__ __forceinline__ int clamp_index(int v, int last) {
  return v < 0 ? 0 : (v > last ? last : v);
}

// The census code of pixel (y, x): radii kRy, kRx where they are known at
// compile time (>= 0), else ry, rx.
template <int kRy, int kRx>
__device__ __forceinline__ unsigned census_code(const float* __restrict__ img, int h, int w,
                                                int y, int x, int ry, int rx) {
  if (kRy >= 0) ry = kRy;
  if (kRx >= 0) rx = kRx;
  const float centre = __ldg(img + static_cast<long long>(y) * w + x);
  unsigned code = 0u;
  int bit = 0;
#pragma unroll
  for (int dy = -ry; dy <= ry; ++dy) {
    const float* row = img + static_cast<long long>(clamp_index(y + dy, h - 1)) * w;
#pragma unroll
    for (int dx = -rx; dx <= rx; ++dx) {
      if (dy == 0 && dx == 0) continue;
      code |= static_cast<unsigned>(__ldg(row + clamp_index(x + dx, w - 1)) < centre) << bit;
      ++bit;
    }
  }
  return code;
}

template <int kRy, int kRx, bool kWhole>
__global__ void __launch_bounds__(kThreads)
census_cost_kernel(const float* __restrict__ left, const float* __restrict__ right,
                   uint8_t* __restrict__ cost, int h, int w, int d, int ry, int rx,
                   int tiles) {
  __shared__ unsigned lcode[kTileW];
  __shared__ unsigned rcode[kTileW + kMaxD - 1];
  const int y = blockIdx.x / tiles;
  const int x0 = (blockIdx.x - y * tiles) * kTileW;
  const int tw = min(kTileW, w - x0);
  // right columns r0 .. x0 + tw - 1: those the tile's pixels reach at some d
  const int r0 = max(x0 - d + 1, 0);
  const int codes = tw + (x0 + tw - r0);
  for (int i = threadIdx.x; i < codes; i += kThreads) {
    if (i < tw) {
      lcode[i] = census_code<kRy, kRx>(left, h, w, y, x0 + i, ry, rx);
    } else {
      rcode[i - tw] = census_code<kRy, kRx>(right, h, w, y, r0 + i - tw, ry, rx);
    }
  }
  __syncthreads();

  uint8_t* out = cost + (static_cast<long long>(y) * w + x0) * d;   // the tile's tw * d bytes
  const int n = tw * d;
  if (kWhole) {
    // one pixel's 16 disparities d0 .. d0 + 15 a piece
    const int groups = d >> 4;
    for (int i = threadIdx.x; i < n >> 4; i += kThreads) {
      const int p = i / groups;
      const int d0 = (i - p * groups) << 4;
      const unsigned lc = lcode[p];
      const int j0 = x0 + p - d0;   // the right column at d0
      unsigned word[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned v = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 - 4 * q - b;
          const unsigned c = j < 0 ? kOutOfImage
                                   : static_cast<unsigned>(__popc(lc ^ rcode[j - r0]));
          v |= c << (8 * b);
        }
        word[q] = v;
      }
      *reinterpret_cast<uint4*>(out + 16 * i) = make_uint4(word[0], word[1], word[2], word[3]);
    }
  } else {
    // 16-byte pieces aligned in memory; byte k of piece i is tile byte 16 i - head + k
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(out) & 15u);
    const int pieces = (head + n + 15) >> 4;
    for (int i = threadIdx.x; i < pieces; i += kThreads) {
      const int f = 16 * i - head;
      const int lo = max(-f, 0), hi = min(16, n - f);
      int p = (f + lo) / d;
      int dd = f + lo - p * d;
      unsigned word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k >= lo && k < hi) {
          const int j = x0 + p - dd;
          const unsigned c = j < 0 ? kOutOfImage
                                   : static_cast<unsigned>(__popc(lcode[p] ^ rcode[j - r0]));
          word[k >> 2] |= c << (8 * (k & 3));
          if (++dd == d) {
            dd = 0;
            ++p;
          }
        }
      }
      if (lo == 0 && hi == 16) {
        *reinterpret_cast<uint4*>(out + f) = make_uint4(word[0], word[1], word[2], word[3]);
      } else {
        for (int k = lo; k < hi; ++k) {
          out[f + k] = static_cast<uint8_t>(word[k >> 2] >> (8 * (k & 3)));
        }
      }
    }
  }
}

template <int kRy, int kRx, bool kWhole>
void launch(const float* left, const float* right, uint8_t* cost, int h, int w, int d, int ry,
            int rx, int tiles, unsigned blocks, cudaStream_t stream) {
  census_cost_kernel<kRy, kRx, kWhole><<<blocks, kThreads, 0, stream>>>(
      left, right, cost, h, w, d, ry, rx, tiles);
}

}  // namespace

// left, right: contiguous (h, w) float32; cost: contiguous (h, w, d) uint8,
// written whole. window wh x ww: odd, at most 32 code bits; 1 <= d <= 256.
// Returns a cudaError_t (cudaErrorInvalidValue for arguments it does not take).
extern "C" int o3r_census_cost(const void* left, const void* right, void* cost, int h, int w,
                               int d, int wh, int ww, void* stream) {
  if (h < 1 || w < 1 || d < 1 || d > kMaxD || wh < 1 || ww < 1 || wh > 33 || ww > 33 ||
      wh % 2 == 0 || ww % 2 == 0 || wh * ww - 1 > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (w + kTileW - 1) / kTileW;
  const long long blocks = static_cast<long long>(h) * tiles;
  if (blocks >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* l = static_cast<const float*>(left);
  const float* r = static_cast<const float*>(right);
  uint8_t* c = static_cast<uint8_t*>(cost);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(blocks);
  const bool whole = d % 16 == 0 && (reinterpret_cast<uintptr_t>(cost) & 15u) == 0;
  const int ry = wh / 2, rx = ww / 2;
  if (ry == 2 && rx == 2) {
    (whole ? launch<2, 2, true> : launch<2, 2, false>)(l, r, c, h, w, d, ry, rx, tiles, b, s);
  } else {
    (whole ? launch<-1, -1, true> : launch<-1, -1, false>)(l, r, c, h, w, d, ry, rx, tiles, b,
                                                          s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 census_cost: the census and rank transforms and the census-Hamming and
// rank cost volumes on Hopper.
//
// Replaces stereo_tpu/ops/pallas/cost_kernel.py:census_cost_volume_pallas
// and rank_cost_volume_pallas: their transforms (census_transform at
// :504-505, rank_transform at :533-534, XLA on the TPU) and their kernels
// _cost_kernel_x (D >= 128) and _cost_kernel (D < 128), both reached
// through _roll_cost_volume. Two stages, two launches per view pair:
//
// Transform stage (census_transform_kernel, one launch per image). For an
// odd wy x wx window, on the image's values as int32 (uint8 as is, float32
// truncated toward zero, the reference's astype(int32)), with borders
// replicating the edge pixel: census bit k is 1 iff the k-th off-centre
// neighbour in row-major order is strictly less than the centre, in word
// k / 32 at bit k % 32 (at most 64 bits: [H, W, words] 32-bit words);
// rank is the count of those neighbours ([H, W], any window). A block of
// 32 x 8 pixels stages its tile and halo in shared memory (lanes along x,
// conflict-free), and each thread compares its window there; the presets'
// 9 x 7 and 5 x 5 windows are compiled with the window loops unrolled, so
// every bit position is a constant.
//
// Cost stage (census_cost_kernel):
//
//   census: C(y, x, d) = sum_k popcount(cl(y, x)[k] ^ cr(y, xr)[k])
//   rank:   C(y, x, d) = |rank_l(y, x) - rank_r(y, xr)|,  xr = x - md - d
//
// with xr clamped at 0 and max_unary_cost where xr < 0, into an int8
// [H, W, D] volume for any D in [1, 256] (one layout and one kernel: the TPU
// kernels' transposed copy and their d-major / x-major split at D = 128 were
// Mosaic-only needs). The rank form is the same kernel with another combine
// on one int32 word per pixel; its costs are at most the window area - 1.
//
// For a column patch of a larger frame (cost_kernel.py:356-375) the right
// plane is [H, W + ctx, words]: ctx frame-true columns precede the block,
// xr = x + ctx - md - d indexes that plane (clamped at 0), and the fill
// with max_unary_cost tests the GLOBAL column x_off + x - md - d < 0, x_off
// being the block's origin in the frame. The reference trims the context it
// does not need before its kernel; here the kernel simply indexes. A tile of
// the halo-tiled pipeline on the frame's left edge has a negative origin
// (the reference's traced `x_offset = ix * bw - halo`, cost_kernel.py:107):
// the same test then fills every lane of its leading columns up to the
// frame's edge. The cost stage has no interior/edge split: each voxel
// tests its own lane against lim = x_off + x - md, at any sign of x_off.
//
// Bound on the H100: the int8 write, 59.6 MB at 375x1242x128 (about 18 us at
// the 3.35 TB/s published for an H100 SXM at 700 W); the descriptor reads
// are 7.5 MB (census, 2 words) or 1.9 MB (rank) and the combine a few
// integer ops per voxel. Design: one block per (row, 128-column tile)
// stages the tile's left descriptors and the right descriptors of columns
// [x0 - md - D + 1, x0 + 128 - md) (clamped into the frame, the golden clamp
// at 0) in shared memory, one descriptor per column (two words are one
// 8-byte load). Lanes run along x and each thread owns a run of 16
// consecutive disparities of one column, so a warp's right-descriptor
// reads are 32 consecutive descriptors (no bank conflict) and its left
// descriptor sits in registers. The run's 16 costs go to a [128, D]
// tile in shared memory as one 16-byte store (rows padded to an odd number
// of 16-byte units: no conflict), and after a barrier the block writes the
// tile, one contiguous run of 128 * D bytes of the volume, with coalesced
// 16-byte stores. Where D is not a multiple of 16 (rows then start at any
// byte) the tile is unpadded and written bytewise.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 128;    // output columns per cost block
constexpr int kThreads = 256;
constexpr int kRun = 16;      // disparities per thread and run
constexpr int kTx = 32;       // transform block: 32 x 8 pixels
constexpr int kTy = 8;
constexpr size_t kSmemDefault = 48 * 1024;

enum Combine { kHamming = 0, kAbsDiff = 1 };
enum ImageType { kU8 = 0, kF32 = 1, kI32 = 2 };

__device__ __forceinline__ int as_int(uint8_t v) { return v; }
__device__ __forceinline__ int as_int(float v) { return __float2int_rz(v); }
__device__ __forceinline__ int as_int(int v) { return v; }

// WY, WX: the window when it is fixed at compile time (the presets' 9 x 7
// and 5 x 5: the loops unroll and every bit position is a constant), or 0
// to take wy, wx.
template <typename T, int WY, int WX>
__global__ void __launch_bounds__(kTx * kTy)
census_transform_kernel(const T* __restrict__ img, uint32_t* __restrict__ out,
                        int h, int w, int wy_, int wx_, int rank) {
  extern __shared__ int tile[];  // [kTy + wy - 1][kTx + wx - 1]
  const int wy = WY ? WY : wy_, wx = WX ? WX : wx_;
  const int ry = wy / 2, rx = wx / 2;
  const int tw = kTx + wx - 1, th = kTy + wy - 1;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  for (int i = threadIdx.y * kTx + threadIdx.x; i < tw * th;
       i += kTx * kTy) {
    const int ty = i / tw, tx = i - ty * tw;
    const int gy = min(max(y0 + ty - ry, 0), h - 1);
    const int gx = min(max(x0 + tx - rx, 0), w - 1);
    tile[i] = as_int(img[(size_t)gy * w + gx]);
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const int* win = tile + threadIdx.y * tw + threadIdx.x;
  const int c = win[ry * tw + rx];
  const size_t p = (size_t)y * w + x;
  if (rank) {
    int n = 0;
#pragma unroll
    for (int dy = 0; dy < wy; ++dy) {
#pragma unroll
      for (int dx = 0; dx < wx; ++dx) n += win[dy * tw + dx] < c;
    }
    out[p] = (uint32_t)n;  // the centre is never below itself
    return;
  }
  uint32_t lo = 0, hi = 0;
  int k = 0;
#pragma unroll
  for (int dy = 0; dy < wy; ++dy) {
#pragma unroll
    for (int dx = 0; dx < wx; ++dx) {
      if (dy == ry && dx == rx) continue;
      const uint32_t bit = win[dy * tw + dx] < c;
      if (k < 32) {
        lo |= bit << k;
      } else {
        hi |= bit << (k - 32);
      }
      ++k;
    }
  }
  if (k <= 32) {
    out[p] = lo;
  } else {
    out[2 * p] = lo;
    out[2 * p + 1] = hi;
  }
}

template <typename T>
int launch_transform(const void* img, uint32_t* out, int h, int w, int wy,
                     int wx, int rank, cudaStream_t s) {
  const size_t smem = (size_t)(kTy + wy - 1) * (kTx + wx - 1) * sizeof(int);
  if (smem > kSmemDefault) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy), block(kTx, kTy);
  const T* in = static_cast<const T*>(img);
  if (wy == 9 && wx == 7) {
    census_transform_kernel<T, 9, 7><<<grid, block, smem, s>>>(
        in, out, h, w, wy, wx, rank);
  } else if (wy == 5 && wx == 5) {
    census_transform_kernel<T, 5, 5><<<grid, block, smem, s>>>(
        in, out, h, w, wy, wx, rank);
  } else {
    census_transform_kernel<T, 0, 0><<<grid, block, smem, s>>>(
        in, out, h, w, wy, wx, rank);
  }
  return (int)cudaGetLastError();
}

// One descriptor as the cost stage reads it: one 32-bit word, or two read
// as one 8-byte word.
template <int WORDS>
using Desc = typename std::conditional<WORDS == 2, uint2, uint32_t>::type;

__device__ __forceinline__ int hamming(uint32_t a, uint32_t b) {
  return __popc(a ^ b);
}
__device__ __forceinline__ int hamming(uint2 a, uint2 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y);
}

// Row pitch in bytes of the cost tile in shared memory: an odd number of
// 16-byte units (16-byte stores of 8 lanes then hit distinct banks), or D
// itself when D is not a multiple of 16.
__host__ __device__ constexpr int tile_pitch(int d, bool vec) {
  return vec ? 16 * ((d / 16) | 1) : d;
}

// Words of shared memory before the cost tile (kept 16-byte aligned).
__host__ __device__ constexpr int tile_offset(int words, int d) {
  return (words * (2 * kTile + d - 1) + 3) & ~3;
}

// WORDS: 32-bit words per descriptor; COMBINE: Hamming or |l - r| (one
// word); VEC: D % 16 == 0, 16-byte stores.
template <int WORDS, int COMBINE, bool VEC>
__global__ void __launch_bounds__(kThreads)
census_cost_kernel(const uint32_t* __restrict__ cl,
                   const uint32_t* __restrict__ cr, int8_t* __restrict__ out,
                   int h, int w, int d, int md, int maxc, int ctx, int x_off) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int nx = min(kTile, w - x0);  // columns of this tile in the frame
  const int wr = w + ctx;             // width of the right plane
  const int base = x0 + ctx - md - d + 1;  // right column at smem index 0
  const int span = kTile + d - 1;     // right columns the tile can read
  const int pitch = tile_pitch(d, VEC);
  using D_ = Desc<WORDS>;
  D_* sl = reinterpret_cast<D_*>(smem);  // [kTile] left descriptors
  D_* sr = sl + kTile;                   // [span] right descriptors
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem + tile_offset(WORDS, d));
  const size_t row = (size_t)y * w;
  const size_t rrow = (size_t)y * wr;

  const D_* gl = reinterpret_cast<const D_*>(cl);
  const D_* gr = reinterpret_cast<const D_*>(cr);
  for (int i = threadIdx.x; i < span; i += kThreads) {
    sr[i] = gr[rrow + min(max(base + i, 0), wr - 1)];
  }
  for (int i = threadIdx.x; i < nx; i += kThreads) sl[i] = gl[row + x0 + i];
  __syncthreads();

  // Work items: (32-column group, run of 16 disparities), group fastest;
  // lane = column within the group.
  constexpr int kGroups = kTile / 32;
  const int lane = threadIdx.x & 31;
  const int runs = (d + kRun - 1) / kRun;
  for (int item = threadIdx.x >> 5; item < kGroups * runs;
       item += kThreads / 32) {
    const int xl = (item % kGroups) * 32 + lane;
    const int d0 = (item / kGroups) * kRun;
    if (xl >= nx) continue;
    const D_ l = sl[xl];
    // Lane dd has a right sample iff x_off + x - md - dd >= 0; sr holds
    // the plane's columns from base on, clamped at 0 as they were loaded:
    // column x + ctx - md - dd is smem index xl + d - 1 - dd.
    const int lim = x_off + x0 + xl - md;
    const D_* r = sr + xl + d - 1 - d0;
    uint32_t packed[kRun / 4];
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) packed[q] = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int dd = d0 + j;
      if (!VEC && dd >= d) break;
      int c = maxc;
      if (dd <= lim) {
        if constexpr (COMBINE == kAbsDiff) {
          c = abs((int)l - (int)r[-j]);
        } else {
          c = hamming(l, r[-j]);
        }
      }
      if (VEC) {
        packed[j / 4] |= (uint32_t)(uint8_t)c << (8 * (j % 4));
      } else {
        tile[xl * pitch + dd] = (uint8_t)c;
      }
    }
    if (VEC) {
      *reinterpret_cast<uint4*>(tile + xl * pitch + d0) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
  __syncthreads();

  // The tile's costs are one contiguous run of nx * D bytes of the volume.
  int8_t* dst = out + (row + x0) * d;
  if (VEC) {
    const int units = d / 16;
    for (int i = threadIdx.x; i < nx * units; i += kThreads) {
      const int xl = i / units;
      reinterpret_cast<uint4*>(dst)[i] = *reinterpret_cast<const uint4*>(
          tile + xl * pitch + 16 * (i - xl * units));
    }
  } else {
    for (int i = threadIdx.x; i < nx * d; i += kThreads) {
      dst[i] = (int8_t)tile[i];
    }
  }
}

size_t cost_smem(int words, int d) {
  const bool vec = d % 16 == 0;
  return (size_t)tile_offset(words, d) * sizeof(uint32_t) +
         (size_t)kTile * tile_pitch(d, vec);
}

template <int WORDS, int COMBINE>
int launch_cost(const uint32_t* l, const uint32_t* r, int8_t* o, int h, int w,
                int d, int md, int maxc, int ctx, int x_off, cudaStream_t s) {
  const dim3 grid((w + kTile - 1) / kTile, h);
  const size_t smem = cost_smem(WORDS, d);
  if (smem > kSmemDefault) return (int)cudaErrorInvalidValue;
  if (d % 16 == 0) {
    census_cost_kernel<WORDS, COMBINE, true><<<grid, kThreads, smem, s>>>(
        l, r, o, h, w, d, md, maxc, ctx, x_off);
  } else {
    census_cost_kernel<WORDS, COMBINE, false><<<grid, kThreads, smem, s>>>(
        l, r, o, h, w, d, md, maxc, ctx, x_off);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// img: [H, W] image of type `type` (0 uint8, 1 float32, 2 int32); out:
// [H, W, words] 32-bit census words (words = ceil((wy * wx - 1) / 32), at
// most 2), or with rank != 0 the [H, W] int32 rank. Odd wy, wx.
extern "C" int stpu_census_transform(const void* img, void* out, int h, int w,
                                     int wy, int wx, int type, int rank,
                                     void* stream) {
  if (h <= 0 || h > 65535 * kTy || w <= 0 || wy <= 0 || wx <= 0 ||
      wy % 2 == 0 || wx % 2 == 0 ||
      (!rank && (wy * wx - 1 > 64 || wy * wx < 2))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  switch (type) {
    case kU8: return launch_transform<uint8_t>(img, o, h, w, wy, wx, rank, s);
    case kF32: return launch_transform<float>(img, o, h, w, wy, wx, rank, s);
    case kI32: return launch_transform<int>(img, o, h, w, wy, wx, rank, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cl: [H, W, words], cr: [H, W + ctx, words] 32-bit descriptors; combine 0:
// census words (1 or 2), Hamming; combine 1: one int32 rank per pixel,
// absolute difference. ctx: right-context columns; x_off: the block's
// global column origin, of any sign (both 0 for a whole frame).
extern "C" int stpu_census_cost(const void* cl, const void* cr, void* out,
                                int h, int w, int d, int words, int combine,
                                int md, int maxc, int ctx, int x_off,
                                void* stream) {
  if (h <= 0 || h > 65535 || w <= 0 || d <= 0 || d > 256 || md < 0 ||
      ctx < 0 ||
      maxc < 0 || maxc > 127 || (words != 1 && words != 2) ||
      (combine != kHamming && combine != kAbsDiff) ||
      (combine == kAbsDiff && words != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const uint32_t*>(cl);
  const auto* r = static_cast<const uint32_t*>(cr);
  auto* o = static_cast<int8_t*>(out);
  if (combine == kAbsDiff) {
    return launch_cost<1, kAbsDiff>(l, r, o, h, w, d, md, maxc, ctx, x_off, s);
  }
  if (words == 1) {
    return launch_cost<1, kHamming>(l, r, o, h, w, d, md, maxc, ctx, x_off, s);
  }
  return launch_cost<2, kHamming>(l, r, o, h, w, d, md, maxc, ctx, x_off, s);
}

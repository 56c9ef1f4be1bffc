// K1 census_cost: the census-Hamming cost volume on Hopper.
//
// Replaces stereo_tpu/ops/pallas/cost_kernel.py:_cost_kernel_x (reached
// through _roll_cost_volume and census_cost_volume_pallas). Computes
//
//   C(y, x, d) = sum_k popcount(cl(y, x)[k] ^ cr(y, max(x - md - d, 0))[k])
//
// and max_unary_cost where x - md - d < 0, into an int8 [H, W, D] volume
// (one layout; the TPU kernel's transposed copy was a Mosaic-only need).
//
// Bound on the H100: the int8 write, 59.6 MB at 375x1242x128 (about 18 us at
// the 3.35 TB/s published for an H100 SXM at 700 W); the descriptor reads
// are 7.5 MB and the popcounts a few integer ops per voxel. Design: one
// block per (row, 128-column tile) stages the tile's left descriptors and
// the right descriptors of columns [x0 - md - D + 1, x0 + 128 - md) (clamped
// into the frame, the golden clamp at 0) in shared memory, word-planar so
// lanes reading neighbouring disparities spread over banks. Threads walk (x,
// d) with d fastest and 4 disparities each, so every thread issues one
// 32-bit store of 4 int8 costs and a warp writes 128 contiguous bytes.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 128;    // output columns per block
constexpr int kThreads = 256;

template <int WORDS>
__global__ void census_cost_kernel(const uint32_t* __restrict__ cl,
                                   const uint32_t* __restrict__ cr,
                                   int8_t* __restrict__ out, int h, int w,
                                   int d, int md, int maxc) {
  extern __shared__ uint32_t smem[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int base = x0 - md - d + 1;   // right column held at smem index 0
  const int span = kTile + d - 1;     // right columns the tile can read
  uint32_t* sl = smem;                // [WORDS][kTile] left descriptors
  uint32_t* sr = smem + WORDS * kTile;  // [WORDS][span] right descriptors
  const size_t row = (size_t)y * w;

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int col = min(max(base + i, 0), w - 1);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      sr[k * span + i] = cr[(row + col) * WORDS + k];
    }
  }
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int col = min(x0 + i, w - 1);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      sl[k * kTile + i] = cl[(row + col) * WORDS + k];
    }
  }
  __syncthreads();

  const int groups = d >> 2;  // 4 disparities per thread
  for (int i = threadIdx.x; i < kTile * groups; i += blockDim.x) {
    const int xl = i / groups;
    const int g = i - xl * groups;
    const int x = x0 + xl;
    if (x >= w) break;  // i grows with x: the rest of the loop is off frame
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = 4 * g + j;
      const int xr = x - md - dd;
      int c = maxc;
      if (xr >= 0) {
        const int s = xr - base;
        c = 0;
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
          c += __popc(sl[k * kTile + xl] ^ sr[k * span + s]);
        }
      }
      packed |= (uint32_t)(uint8_t)c << (8 * j);
    }
    reinterpret_cast<uint32_t*>(out + (row + x) * d)[g] = packed;
  }
}

}  // namespace

extern "C" int stpu_census_cost(const void* cl, const void* cr, void* out,
                                int h, int w, int d, int words, int md,
                                int maxc, void* stream) {
  if (h <= 0 || w <= 0 || d <= 0 || d % 4 != 0 || md < 0 ||
      (words != 1 && words != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((w + kTile - 1) / kTile, h);
  const size_t smem = (size_t)words * (2 * kTile + d - 1) * sizeof(uint32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const uint32_t*>(cl);
  const auto* r = static_cast<const uint32_t*>(cr);
  auto* o = static_cast<int8_t*>(out);
  if (words == 1) {
    census_cost_kernel<1><<<grid, kThreads, smem, s>>>(l, r, o, h, w, d, md,
                                                       maxc);
  } else {
    census_cost_kernel<2><<<grid, kThreads, smem, s>>>(l, r, o, h, w, d, md,
                                                       maxc);
  }
  return (int)cudaGetLastError();
}

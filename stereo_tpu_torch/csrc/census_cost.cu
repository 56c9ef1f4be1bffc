// K1 census_cost: the census-Hamming and rank cost volumes on Hopper.
//
// Replaces stereo_tpu/ops/pallas/cost_kernel.py:_cost_kernel_x (D >= 128)
// and _cost_kernel (D < 128), both reached through _roll_cost_volume from
// census_cost_volume_pallas and rank_cost_volume_pallas. Computes
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
// does not need before its kernel; here the kernel simply indexes.
//
// Bound on the H100: the int8 write, 59.6 MB at 375x1242x128 (about 18 us at
// the 3.35 TB/s published for an H100 SXM at 700 W); the descriptor reads
// are 7.5 MB (census, 2 words) or 1.9 MB (rank) and the combine a few
// integer ops per voxel. Design: one block per (row, 128-column tile) stages
// the tile's left descriptors and the right descriptors of columns
// [x0 - md - D + 1, x0 + 128 - md) (clamped into the frame, the golden clamp
// at 0) in shared memory, word-planar so lanes reading neighbouring
// disparities spread over banks. Threads walk (x, d) with d fastest and 4
// disparities each; where D is a multiple of 4 every thread makes one
// 32-bit store of 4 int8 costs and a warp writes 128 contiguous bytes, else
// (rows of D bytes are then not 4-byte aligned) each cost is stored as a
// byte and disparities past D are skipped.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 128;    // output columns per block
constexpr int kThreads = 256;

enum Combine { kHamming = 0, kAbsDiff = 1 };

// WORDS: 32-bit words per descriptor; COMBINE: Hamming or |l - r| (one
// word); PACKED: D % 4 == 0, one 32-bit store of 4 costs.
template <int WORDS, int COMBINE, bool PACKED>
__global__ void census_cost_kernel(const uint32_t* __restrict__ cl,
                                   const uint32_t* __restrict__ cr,
                                   int8_t* __restrict__ out, int h, int w,
                                   int d, int md, int maxc, int ctx,
                                   int x_off) {
  extern __shared__ uint32_t smem[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int wr = w + ctx;             // width of the right plane
  const int base = x0 + ctx - md - d + 1;  // right column at smem index 0
  const int span = kTile + d - 1;     // right columns the tile can read
  uint32_t* sl = smem;                // [WORDS][kTile] left descriptors
  uint32_t* sr = smem + WORDS * kTile;  // [WORDS][span] right descriptors
  const size_t row = (size_t)y * w;
  const size_t rrow = (size_t)y * wr;

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int col = min(max(base + i, 0), wr - 1);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      sr[k * span + i] = cr[(rrow + col) * WORDS + k];
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

  const int groups = (d + 3) >> 2;  // 4 disparities per thread
  for (int i = threadIdx.x; i < kTile * groups; i += blockDim.x) {
    const int xl = i / groups;
    const int g = i - xl * groups;
    const int x = x0 + xl;
    if (x >= w) break;  // i grows with x: the rest of the loop is off frame
    int8_t* voxel = out + (row + x) * d + 4 * g;
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = 4 * g + j;
      if (!PACKED && dd >= d) break;
      int c = maxc;
      if (x_off + x - md - dd >= 0) {
        // sr holds the plane's columns from base on, clamped at 0 as they
        // were loaded.
        const int s = x + ctx - md - dd - base;
        if (COMBINE == kAbsDiff) {
          c = abs((int)sl[xl] - (int)sr[s]);
        } else {
          c = 0;
#pragma unroll
          for (int k = 0; k < WORDS; ++k) {
            c += __popc(sl[k * kTile + xl] ^ sr[k * span + s]);
          }
        }
      }
      if (PACKED) {
        packed |= (uint32_t)(uint8_t)c << (8 * j);
      } else {
        voxel[j] = (int8_t)c;
      }
    }
    if (PACKED) *reinterpret_cast<uint32_t*>(voxel) = packed;
  }
}

template <int WORDS, int COMBINE>
void launch(const uint32_t* l, const uint32_t* r, int8_t* o, int h, int w,
            int d, int md, int maxc, int ctx, int x_off, cudaStream_t s) {
  const dim3 grid((w + kTile - 1) / kTile, h);
  const size_t smem = (size_t)WORDS * (2 * kTile + d - 1) * sizeof(uint32_t);
  if (d % 4 == 0) {
    census_cost_kernel<WORDS, COMBINE, true><<<grid, kThreads, smem, s>>>(
        l, r, o, h, w, d, md, maxc, ctx, x_off);
  } else {
    census_cost_kernel<WORDS, COMBINE, false><<<grid, kThreads, smem, s>>>(
        l, r, o, h, w, d, md, maxc, ctx, x_off);
  }
}

}  // namespace

// cl: [H, W, words], cr: [H, W + ctx, words] 32-bit descriptors; combine 0:
// census words (1 or 2), Hamming; combine 1: one int32 rank per pixel,
// absolute difference. ctx: right-context columns; x_off: the block's
// global column origin (both 0 for a whole frame).
extern "C" int stpu_census_cost(const void* cl, const void* cr, void* out,
                                int h, int w, int d, int words, int combine,
                                int md, int maxc, int ctx, int x_off,
                                void* stream) {
  if (h <= 0 || h > 65535 || w <= 0 || d <= 0 || d > 256 || md < 0 ||
      ctx < 0 || x_off < 0 ||
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
    launch<1, kAbsDiff>(l, r, o, h, w, d, md, maxc, ctx, x_off, s);
  } else if (words == 1) {
    launch<1, kHamming>(l, r, o, h, w, d, md, maxc, ctx, x_off, s);
  } else {
    launch<2, kHamming>(l, r, o, h, w, d, md, maxc, ctx, x_off, s);
  }
  return (int)cudaGetLastError();
}

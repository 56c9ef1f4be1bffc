// K5 sad_cost: the SAD block-matching cost volume on Hopper.
//
// Replaces stereo_tpu/ops/pallas/cost_kernel.py:_sad_kernel (reached
// through sad_cost_volume_pallas). Computes, for lane d (disparity md + d),
//
//   AD(y, x, d) = |L(y, x) - R(y, max(x + ctx - md - d, 0))|
//   C(y, x, d)  = floor(sum_{|dy| <= ry, |dx| <= rx}
//                       AD(clamp(y + dy), clamp(x + dx), d) / (wy * wx))
//
// and max_unary_cost where the global column x_off + x - md - d < 0 (x_off:
// the block's origin in a larger frame, 0 for a whole frame; the legacy
// banded runner's patches, and the halo-tiled pipeline's tiles, whose
// origin is negative on the frame's left edge, cost_kernel.py:704), into an
// int16 [H, W, D] volume
// (stereo_tpu/ops/cost.py:98-125). R is [H, W + ctx]: its first ctx
// columns are the frame-true columns before the block (a column patch's
// right context). The TPU kernel takes none (cost_kernel.py:680-683), and
// the reference sends SAD with a context to its golden volume
// (stereo_tpu/pipeline/pipeline.py:131-132), whose rule this is. The golden
// box filter edge-replicates the AD array, not the image: past column w-1
// the window repeats AD(w-1), whose right sample is R(w-1-md-d), where a
// replicated image would read R(w-md-d) and give another value. Clamping
// the AD column, as here, is that rule; the TPU kernel patches the lanes
// past the frame edge instead. Clamping a row replicates AD rows, which is
// the same as replicating image rows, since L and R clamp alike.
//
// The images are read in their own type: uint8 as is, int32, or float32
// truncated toward zero (the reference's astype(int32)). The wrapper
// admits int32 and float32 images with values in [-65535, 65535], so
// every window sum is below 2^31.
//
// Bound on the H100: the int16 write, 3.5 MB at 288x384x16 and 119 MB at
// 375x1242x128 (about 1 and 36 us at the 3.35 TB/s published for an H100
// SXM at 700 W); the images are a few hundred KB. The kernel is
// issue-bound instead: about 18 instructions a voxel (375x1242x128, 9x9,
// from its SASS), half of them keeping the vertical sums (shared loads
// among them), the rest the horizontal slide, divide and store; it runs at
// about 2.3x the bound (PERF.md, section 6, has the variants measured).
//
// Design. A block owns 128 columns, up to 16 rows and DC disparities (DC =
// 16 for D <= 16, else 32; the grid's z walks D in chunks of DC). It stages
// the L rows of its tile with their +-ry halo and +-rx columns (clamped at
// the frame's edges) and the R span those columns reach over the chunk's
// disparities (128 + 2 rx + DC - 1 columns, clamped at 0), every global
// load in flight at once, then walks its rows with no further barrier.
// Each thread owns one disparity d (lanes along d) and a run of XR = 16
// (DC = 32) or 8 (DC = 16) output columns, and keeps the vertical window
// sums of its XR + 2 rx window columns in registers (the window's
// half-width RX is a template argument, so the sums are registers): per
// row it adds the AD of the row entering the window and, after the row's
// outputs, drops the row leaving it. A row's outputs are a sliding
// horizontal sum over those registers, the divide and, where the voxel is
// invalid, max_unary_cost; a warp stores DC
// consecutive int16 of one column. The L samples of a row are 16-byte
// shared loads (one address across the warp), the R samples consecutive
// words, so no access conflicts.
//
// Arithmetic. uint8 images, on every path, sum in float: every sum is an
// integer below 255 * 17 * 17 < 2^24, so float adds are exact, and the
// absolute value is an operand modifier of the float add, so an AD and its
// accumulation are two instructions (three in integers). floor(sum / area)
// is floor(fma(sum, inv, bias)) with inv = f32(1 / area) and bias =
// f32(0.5 / area) (ops/cuda/cost_kernel.py:sad_reciprocal, checked there
// for every sum), taken by a round-down add of 1.5 * 2^23 whose low
// mantissa bits are the cost. int32 and float32 images sum in integers
// and divide by a magic multiply and shift (sad_divisor, exact below
// 2^31).

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;        // output columns per block
constexpr int kMaxRadius = 8;     // windows up to 17 x 17
constexpr int kMaxRows = 16;      // output rows per block
constexpr int kMinRows = 4;
constexpr int kFillBlocks = 264;  // two blocks per SM of an H100 SXM
// Staged rows per warp, and 32-column groups per staged row: at most
// kMaxRows + 2 * kMaxRadius rows and 128 + 16 + 31 columns.
constexpr int kStageRows = (kMaxRows + 2 * kMaxRadius) / kWarps;
constexpr int kStageCols = 6;
constexpr size_t kSmemDefault = 48 * 1024;
// 1.5 * 2^23: a float add of it rounded down leaves floor(y) in the low
// mantissa bits for 0 <= y < 2^22.
constexpr float kFloorMagic = 12582912.0f;

enum ImageType { kU8 = 0, kF32 = 1, kI32 = 2 };

__device__ __forceinline__ int as_int(uint8_t v) { return v; }
__device__ __forceinline__ int as_int(float v) { return __float2int_rz(v); }
__device__ __forceinline__ int as_int(int v) { return v; }

// Staged pitches (elements) of an L and an R row for half-width rx: the L
// pitch is a multiple of 4 for 16-byte loads.
__host__ __device__ constexpr int l_pitch(int rx) {
  return (kTile + 2 * rx + 3) & ~3;
}
__host__ __device__ constexpr int r_pitch(int rx, int dc) {
  return kTile + 2 * rx + dc - 1;
}

// The divide's constants: magic and shift for integer sums, inv and bias
// for float ones.
struct Divisor {
  unsigned magic;
  int shift;
  float inv, bias;
};

// floor(sum / area) in the low 16 bits of the result, which is all the
// int16 store keeps. Acc: float (uint8 images; the low mantissa bits of
// 1.5 * 2^23 + floor(y)) or int (int32 and float32 images).
template <typename Acc>
__device__ __forceinline__ int quotient(Acc sum, const Divisor& q) {
  if constexpr (std::is_same<Acc, float>::value) {
    const float y = __fmaf_rn(sum, q.inv, q.bias);
    return __float_as_int(__fadd_rd(y, kFloorMagic));
  } else {
    return (int)(((unsigned long long)(unsigned)sum * q.magic) >> q.shift);
  }
}

// One block's walk over its rows, its tile staged in ls / rs. EDGE: the
// tile's window columns reach past the frame, so the R sample of each
// column is taken at the clamped AD column, or some of its voxels are
// invalid; each output is then selected and its store guarded. Interior
// blocks (all but the frame's first and last column blocks, and the low
// disparity chunks of the first) store without either, and no warp splits
// between the two.
template <typename Acc, int RX, int DC, bool EDGE>
__device__ __forceinline__ void walk(const Acc* __restrict__ ls,
                                     const Acc* __restrict__ rs,
                                     int16_t* __restrict__ out, int w, int D,
                                     int md, int wy, int x0, int y0, int d0,
                                     int nrows, const Divisor& dv, int maxc,
                                     int x_off) {
  constexpr int XR = kTile / (kThreads / DC);  // output columns per thread
  constexpr int NC = XR + 2 * RX;              // window columns per thread
  constexpr int NV = (NC + 3) / 4;             // 16-byte L loads per row
  constexpr int LP = l_pitch(RX), RP = r_pitch(RX, DC);
  using Acc4 = typename std::conditional<std::is_same<Acc, float>::value,
                                         float4, int4>::type;
  const int dd = threadIdx.x % DC;
  const int c0 = (threadIdx.x / DC) * XR;  // first window column, staged
  const int d = d0 + dd;
  const int x = x0 + c0;
  // Window column c (staged) is frame column x0 - RX + c; its R sample is
  // staged at clamp(c) + DC - 1 - dd.
  const int jlo = RX - x0, jhi = w - 1 - x0 + RX;
  auto rcol = [&](int ci) {
    if (EDGE) return min(max(c0 + ci, jlo), jhi) + DC - 1 - dd;
    return c0 + ci + DC - 1 - dd;
  };
  Acc v[NC];
#pragma unroll
  for (int ci = 0; ci < NC; ++ci) v[ci] = 0;
  // v += AD of staged row s (sign 1), or v -= it (sign -1).
  auto add_row = [&](int s, int sign) {
    const Acc4* l4 = reinterpret_cast<const Acc4*>(ls + s * LP + c0);
    const Acc* rrow = rs + s * RP;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const Acc4 t = l4[k];
      const Acc lv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ci = 4 * k + u;
        if (ci < NC) {
          const Acc ad = lv[u] - rrow[rcol(ci)];
          if constexpr (std::is_same<Acc, float>::value) {
            v[ci] = sign > 0 ? v[ci] + fabsf(ad) : v[ci] - fabsf(ad);
          } else {
            v[ci] = sign > 0 ? v[ci] + abs(ad) : v[ci] - abs(ad);
          }
        }
      }
    }
  };
  for (int s = 0; s < wy - 1; ++s) add_row(s, 1);

  const bool active = d < D && x < w;
  const int lim = x_off + x - md - d;  // column x + q is valid iff q + lim >= 0
  for (int i = 0; i < nrows; ++i) {
    add_row(i + wy - 1, 1);
    if (active) {
      // The horizontal sums of the run: the first window's, then a slide
      // (one slide issues fewer instructions than several shorter ones).
      Acc h = 0;
#pragma unroll
      for (int ci = 0; ci <= 2 * RX; ++ci) h += v[ci];
      int16_t* o = out + ((size_t)(y0 + i) * w + x) * D + d;
#pragma unroll
      for (int q = 0; q < XR; ++q) {
        if (q > 0) h = h + v[q + 2 * RX] - v[q - 1];
        if (EDGE) {
          const int c = quotient(h, dv);
          if (x + q < w) o[q * D] = (int16_t)(q + lim < 0 ? maxc : c);
        } else {
          o[q * D] = (int16_t)quotient(h, dv);
        }
      }
    }
    add_row(i, -1);
  }
}

// Stages rows y0 - ry .. y0 + nrows + ry - 1 (clamped): L at columns
// x0 - RX + j (clamped), R at columns base + j (clamped at 0). Each warp
// takes rows warp, warp + 8, ... and its lanes the columns; every load is
// issued before the first store, so the block waits for one round trip to
// memory. Loads past the staged area are harmless clamped repeats.
template <typename Acc, typename T, int RX, int DC>
__device__ __forceinline__ void stage(const T* __restrict__ left,
                                      const T* __restrict__ right, Acc* ls,
                                      Acc* rs, int h, int w, int wr, int ry,
                                      int x0, int y0, int base, int sr) {
  constexpr int LP = l_pitch(RX), RP = r_pitch(RX, DC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Acc lv[kStageRows][kStageCols], rv[kStageRows][kStageCols];
#pragma unroll
  for (int k = 0; k < kStageRows; ++k) {
    const int gy = min(max(y0 - ry + warp + kWarps * k, 0), h - 1);
    const T* lrow = left + (size_t)gy * w;
    const T* rrow = right + (size_t)gy * wr;
#pragma unroll
    for (int u = 0; u < kStageCols; ++u) {
      const int j = lane + 32 * u;
      lv[k][u] = (Acc)as_int(lrow[min(max(x0 - RX + j, 0), w - 1)]);
      rv[k][u] = (Acc)as_int(rrow[min(max(base + j, 0), wr - 1)]);
    }
  }
#pragma unroll
  for (int k = 0; k < kStageRows; ++k) {
    const int s = warp + kWarps * k;
    if (s < sr) {
#pragma unroll
      for (int u = 0; u < kStageCols; ++u) {
        const int j = lane + 32 * u;
        if (j < LP) ls[s * LP + j] = lv[k][u];
        if (j < RP) rs[s * RP + j] = rv[k][u];
      }
    }
  }
}

// Acc float: uint8 images; Acc int: float32 (image_type kF32) or int32.
template <typename Acc, int RX, int DC>
__global__ void __launch_bounds__(kThreads, 2)
sad_cost_kernel(const void* __restrict__ left, const void* __restrict__ right,
                int16_t* __restrict__ out, int h, int w, int D, int md,
                int ry, Divisor dv, int maxc, int ctx, int x_off, int rows,
                int image_type) {
  constexpr int LP = l_pitch(RX);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* ls = reinterpret_cast<Acc*>(smem_raw);  // [sr][LP]
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * rows;
  const int d0 = blockIdx.z * DC;
  const int nrows = min(rows, h - y0);
  const int sr = nrows + 2 * ry;
  const int wr = w + ctx;
  // R column at staged index 0: window column 0 (frame column x0 - RX)
  // with the chunk's largest disparity.
  const int base = x0 - RX + ctx - md - d0 - (DC - 1);
  Acc* rs = ls + sr * LP;  // [sr][r_pitch]
  if constexpr (std::is_same<Acc, float>::value) {
    stage<Acc, uint8_t, RX, DC>(static_cast<const uint8_t*>(left),
                                static_cast<const uint8_t*>(right), ls, rs, h,
                                w, wr, ry, x0, y0, base, sr);
  } else if (image_type == kF32) {
    stage<Acc, float, RX, DC>(static_cast<const float*>(left),
                              static_cast<const float*>(right), ls, rs, h, w,
                              wr, ry, x0, y0, base, sr);
  } else {
    stage<Acc, int, RX, DC>(static_cast<const int*>(left),
                            static_cast<const int*>(right), ls, rs, h, w, wr,
                            ry, x0, y0, base, sr);
  }
  __syncthreads();
  // Interior: the window columns stay in the frame, and the block's
  // lowest global column less its largest disparity is >= 0 (at a negative
  // x_off more blocks fail this and take the edge walk; an interior block
  // then also has x - md - d >= -x_off > 0, so no R sample clamps).
  if (x0 - RX < 0 || x0 + kTile + RX > w ||
      x_off + x0 - md - (d0 + DC - 1) < 0) {
    walk<Acc, RX, DC, true>(ls, rs, out, w, D, md, 2 * ry + 1, x0, y0, d0,
                            nrows, dv, maxc, x_off);
  } else {
    walk<Acc, RX, DC, false>(ls, rs, out, w, D, md, 2 * ry + 1, x0, y0, d0,
                             nrows, dv, maxc, x_off);
  }
}

// Rows per block: the most up to 16 that still gives the grid two blocks
// per SM, at least 4.
int block_rows(int gx, int gz, int h) {
  int rows = kMaxRows;
  while (rows > kMinRows &&
         (long long)gx * ((h + rows - 1) / rows) * gz < kFillBlocks) {
    rows /= 2;
  }
  return rows;
}

size_t smem_bytes(int rows, int ry, int rx, int dc) {
  return (size_t)(rows + 2 * ry) * (l_pitch(rx) + r_pitch(rx, dc)) * 4;
}

template <typename Acc, int RX, int DC>
int launch(const void* left, const void* right, int16_t* out, int h, int w,
           int d, int md, int ry, const Divisor& dv, int maxc, int ctx,
           int x_off, int image_type, cudaStream_t s) {
  const int gx = (w + kTile - 1) / kTile, gz = (d + DC - 1) / DC;
  const int rows = block_rows(gx, gz, h);
  const int gy = (h + rows - 1) / rows;
  const size_t smem = smem_bytes(rows, ry, RX, DC);
  if (gy > 65535 || smem > kSmemDefault) return (int)cudaErrorInvalidValue;
  sad_cost_kernel<Acc, RX, DC><<<dim3(gx, gy, gz), kThreads, smem, s>>>(
      left, right, out, h, w, d, md, ry, dv, maxc, ctx, x_off, rows,
      image_type);
  return (int)cudaGetLastError();
}

template <typename Acc, int DC>
int launch_rx(int rx, const void* left, const void* right, int16_t* out,
              int h, int w, int d, int md, int ry, const Divisor& dv,
              int maxc, int ctx, int x_off, int image_type, cudaStream_t s) {
#define STPU_SAD_RX(R)                                                     \
  case R:                                                                  \
    return launch<Acc, R, DC>(left, right, out, h, w, d, md, ry, dv, maxc, \
                              ctx, x_off, image_type, s);
  switch (rx) {
    STPU_SAD_RX(0) STPU_SAD_RX(1) STPU_SAD_RX(2) STPU_SAD_RX(3)
    STPU_SAD_RX(4) STPU_SAD_RX(5) STPU_SAD_RX(6) STPU_SAD_RX(7)
    STPU_SAD_RX(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef STPU_SAD_RX
}

template <typename Acc>
int launch_dc(const void* left, const void* right, int16_t* out, int h,
              int w, int d, int md, int ry, int rx, const Divisor& dv,
              int maxc, int ctx, int x_off, int image_type, cudaStream_t s) {
  if (d <= 16) {
    return launch_rx<Acc, 16>(rx, left, right, out, h, w, d, md, ry, dv,
                              maxc, ctx, x_off, image_type, s);
  }
  return launch_rx<Acc, 32>(rx, left, right, out, h, w, d, md, ry, dv, maxc,
                            ctx, x_off, image_type, s);
}

}  // namespace

// Shared memory (bytes) of one block for D disparities and a wy x wx
// window, at the largest tile.
extern "C" int stpu_sad_cost_smem(int d, int wy, int wx) {
  return (int)smem_bytes(kMaxRows, wy / 2, wx / 2, d <= 16 ? 16 : 32);
}

// left: [H, W] and right: [H, W + ctx] images of one type (image_type:
// 0 uint8, 1 float32, 2 int32); out: [H, W, D] int16. The divide by
// wy * wx: floor(sum / area) = (sum * magic) >> shift for integer sums
// below 2^31, and floor(fma(sum, inv, bias)) for the float sums of uint8
// images (at most 255 * wy * wx).
extern "C" int stpu_sad_cost(const void* left, const void* right, void* out,
                             int h, int w, int d, int md, int wy, int wx,
                             int maxc, int ctx, int x_off, int image_type,
                             unsigned magic, int shift, float inv, float bias,
                             void* stream) {
  if (h <= 0 || w <= 0 || d <= 0 || d > 256 || md < 0 ||
      ctx < 0 || wy <= 0 || wx <= 0 || wy % 2 == 0 || wx % 2 == 0 ||
      wy / 2 > kMaxRadius || wx / 2 > kMaxRadius || shift < 31 ||
      shift > 63 || image_type < kU8 || image_type > kI32) {
    return (int)cudaErrorInvalidValue;
  }
  int16_t* o = static_cast<int16_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Divisor dv{magic, shift, inv, bias};
  if (image_type == kU8) {
    return launch_dc<float>(left, right, o, h, w, d, md, wy / 2, wx / 2, dv,
                            maxc, ctx, x_off, image_type, s);
  }
  return launch_dc<int>(left, right, o, h, w, d, md, wy / 2, wx / 2, dv,
                        maxc, ctx, x_off, image_type, s);
}

// K4 median3x3: 3x3 median of the float32 disparity map.
//
// Replaces stereo_tpu/ops/pallas/filter_kernel.py:_median_kernel (reached
// through median_3x3_pallas): edges replicate, and the value is the median
// that the reference's 19-exchange network (_NET, Paeth) leaves in v[4]
// (ops/postprocess.py:median_3x3 is the plain twin).
//
// Bound on the H100: one read and one write of the map, 45.8 MB at
// 1988x2880 (about 14 us at the 3.35 TB/s published for an H100 SXM at
// 700 W) and 3.7 MB at 375x1242, where launch latency dominates. Design: a
// block of 32 x 8 threads stages a 130 x 18 tile (128 x 16 outputs and a
// one-pixel halo, clamped at the frame's edges) in shared memory, with
// 16-byte loads where the width is a multiple of 4; each thread then takes
// 4 neighbouring pixels of 2 rows (small frames: 32 x 4 threads, a 130 x 6
// tile, one row a thread). Each 3-value column is sorted once (3
// exchanges) and serves the three pixels that share it; a pixel's median
// is the median of its three sorted columns' largest minimum, median of
// medians and smallest maximum, which is the 3x3 median. A thread writes
// its 4 pixels as one float4 where it can. About 20 min/max per pixel
// instead of the network's 38.
//
// The maps hold no NaN: K3 guards the parabola's denominator
// (stereo_tpu/ops/wta.py:85-89; csrc/sgm_select.cu, denom > 0). Nor do
// they hold -0.0: K3 writes f32(d0) + offset for d0 >= 1 (a value >= 0.5)
// or f32(d0) itself, then adds f32(md) with round-to-nearest, which never
// gives -0.0, and no other path step writes the map before K4. The CUDA
// tests hold the selection against the network bit for bit on maps with
// ties and with both zeros in one window too.

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;               // threads along x
constexpr int kRun = 4;                // pixels per thread along x
constexpr int kTileW = kTx * kRun;     // 128 output columns
// Staged row: [3] is column x0 - 1, [4, 4 + 128) the tile, [132] column
// x0 + 128, so the tile's float4s are 16-byte aligned.
constexpr int kPitch = kTileW + 8;
// Frames whose 128 x 16 tiles give fewer blocks than this (two per SM of
// an H100 SXM) take 128 x 4 tiles of 128 threads, so that more blocks
// share the latency of their one round trip to memory.
constexpr int kFillBlocks = 264;

__device__ __forceinline__ void sort2(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// The staged row's columns t[-1] .. t[kRun] (t is 16-byte aligned).
__device__ __forceinline__ void load_columns(float (&v)[kRun + 2],
                                             const float* t) {
  const float4 c = *reinterpret_cast<const float4*>(t);
  v[0] = t[-1];
  v[1] = c.x;
  v[2] = c.y;
  v[3] = c.z;
  v[4] = c.w;
  v[5] = t[kRun];
}

// VEC: w % 4 == 0, so each row's tile columns are 16-byte aligned. A
// block is kTx x TY threads and each thread takes ROWS rows.
template <bool VEC, int TY, int ROWS>
__global__ void __launch_bounds__(kTx * TY)
median3x3_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int h, int w) {
  constexpr int kTy = TY, kRows = ROWS, kTileH = TY * ROWS;
  __shared__ __align__(16) float tile[kTileH + 2][kPitch];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tx = threadIdx.x;
  const int xs = x0 + kRun * tx;  // this thread's first column
  for (int r = threadIdx.y; r < kTileH + 2; r += kTy) {
    const float* row = in + (size_t)min(max(y0 - 1 + r, 0), h - 1) * w;
    float* t = &tile[r][4 + kRun * tx];
    if (VEC && xs + kRun <= w) {
      *reinterpret_cast<float4*>(t) =
          __ldg(reinterpret_cast<const float4*>(row + xs));
    } else {
#pragma unroll
      for (int q = 0; q < kRun; ++q) t[q] = __ldg(row + min(xs + q, w - 1));
    }
    if (tx == 0) tile[r][3] = __ldg(row + max(x0 - 1, 0));
    if (tx == 1) tile[r][4 + kTileW] = __ldg(row + min(x0 + kTileW, w - 1));
  }
  __syncthreads();
  if (xs >= w) return;

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = kRows * threadIdx.y + k;  // output row y0 + r
    const int y = y0 + r;
    if (y >= h) return;
    // Columns xs - 1 .. xs + 4 of rows y - 1, y, y + 1, then each column
    // sorted: lo <= mi <= hi.
    float lo[kRun + 2], mi[kRun + 2], hi[kRun + 2];
    load_columns(lo, &tile[r][4 + kRun * tx]);
    load_columns(mi, &tile[r + 1][4 + kRun * tx]);
    load_columns(hi, &tile[r + 2][4 + kRun * tx]);
#pragma unroll
    for (int c = 0; c < kRun + 2; ++c) {
      sort2(lo[c], mi[c]);
      sort2(mi[c], hi[c]);
      sort2(lo[c], mi[c]);
    }
    float m[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      const float a = fmaxf(fmaxf(lo[q], lo[q + 1]), lo[q + 2]);
      const float b = med3(mi[q], mi[q + 1], mi[q + 2]);
      const float c = fminf(fminf(hi[q], hi[q + 1]), hi[q + 2]);
      m[q] = med3(a, b, c);
    }
    float* o = out + (size_t)y * w + xs;
    if (VEC && xs + kRun <= w) {
      *reinterpret_cast<float4*>(o) = make_float4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        if (xs + q < w) o[q] = m[q];
      }
    }
  }
}

template <int TY, int ROWS>
int launch(const float* in, float* out, int h, int w, cudaStream_t s) {
  const dim3 block(kTx, TY);
  const dim3 grid((w + kTileW - 1) / kTileW,
                  (h + TY * ROWS - 1) / (TY * ROWS));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (w % 4 == 0) {
    median3x3_kernel<true, TY, ROWS><<<grid, block, 0, s>>>(in, out, h, w);
  } else {
    median3x3_kernel<false, TY, ROWS><<<grid, block, 0, s>>>(in, out, h, w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stpu_median3x3(const void* in, void* out, int h, int w,
                              void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks =
      (long long)((w + kTileW - 1) / kTileW) * ((h + 15) / 16);
  if (blocks < kFillBlocks) return launch<4, 1>(i, o, h, w, s);
  return launch<8, 2>(i, o, h, w, s);
}

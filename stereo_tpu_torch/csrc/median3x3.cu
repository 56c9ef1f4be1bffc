// K4 median3x3: 3x3 median of the float32 disparity map.
//
// Replaces stereo_tpu/ops/pallas/filter_kernel.py:_median_kernel (reached
// through median_3x3_pallas): edges replicate, and the median is v[4]
// after the same 19-exchange network (_NET, Paeth) as the reference, so
// the result is bit-identical (min/max only, no arithmetic).
//
// Bound on the H100: 1.9 MB read and 1.9 MB written at 375x1242, a few
// microseconds at the 3.35 TB/s published for an H100 SXM at 700 W, so
// launch latency dominates. Design: one thread per pixel with clamped loads;
// the 9 neighbours of adjacent threads overlap and are served from L1.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void sort2(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__global__ void median3x3_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  float v[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = min(max(y + dy - 1, 0), h - 1);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = min(max(x + dx - 1, 0), w - 1);
      v[dy * 3 + dx] = in[(size_t)yy * w + xx];
    }
  }
  sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
  sort2(v[0], v[1]); sort2(v[3], v[4]); sort2(v[6], v[7]);
  sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
  sort2(v[0], v[3]); sort2(v[5], v[8]); sort2(v[4], v[7]);
  sort2(v[3], v[6]); sort2(v[1], v[4]); sort2(v[2], v[5]);
  sort2(v[4], v[7]); sort2(v[4], v[2]); sort2(v[6], v[4]);
  sort2(v[4], v[2]);
  out[(size_t)y * w + x] = v[4];
}

}  // namespace

extern "C" int stpu_median3x3(const void* in, void* out, int h, int w,
                              void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  median3x3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), h, w);
  return (int)cudaGetLastError();
}

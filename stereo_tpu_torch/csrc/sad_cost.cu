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
// banded runner's patches), into an int16 [H, W, D] volume
// (stereo_tpu/ops/cost.py:98-125). R is [H, W + ctx]: its first ctx
// columns are the frame-true columns before the block (a column patch's
// right context). The TPU kernel takes none (cost_kernel.py:680-683), and
// the reference sends SAD with a context to its golden volume
// (stereo_tpu/pipeline/pipeline.py:131-132), whose rule this is. The golden
// box filter edge-replicates the AD array, not the image: past column w-1
// the window repeats AD(w-1), whose right sample is R(w-1-md-d), where a
// replicated image would read R(w-md-d) and give another value. Clamping
// the AD index, as here, is that rule; the TPU kernel patches the lanes
// past the frame edge instead.
//
// Bound on the H100: the int16 write is 3.5 MB at 288x384x16 (about 1 us at
// the 3.35 TB/s published for an H100 SXM at 700 W) and the two int32 images
// fit in L2, so the kernel is bound by its 2 * wy * wx L1 loads per voxel.
// Design (a simple first version): one thread per voxel, threads walking
// (x, d) with d fastest, so a warp's stores are contiguous and its loads of
// L hit one address and of R neighbouring ones. A shared-memory row band
// with running window sums would cut the loads to a few per voxel.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void sad_cost_kernel(const int* __restrict__ left,
                                const int* __restrict__ right,
                                int16_t* __restrict__ out, int h, int w, int d,
                                int md, int ry, int rx, int area, int maxc,
                                int ctx, int x_off) {
  const int y = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // x * d + lane
  if (i >= w * d) return;
  const int x = i / d;
  const int shift = md + (i - x * d);
  int c = maxc;
  if (x_off + x - shift >= 0) {
    const int wr = w + ctx;  // right row length
    int sum = 0;
    for (int oy = -ry; oy <= ry; ++oy) {
      const int yy = min(max(y + oy, 0), h - 1);
      const int* lrow = left + (size_t)yy * w;
      const int* rrow = right + (size_t)yy * wr;
      for (int ox = -rx; ox <= rx; ++ox) {
        const int xx = min(max(x + ox, 0), w - 1);
        sum += abs(__ldg(lrow + xx) - __ldg(rrow + max(xx + ctx - shift, 0)));
      }
    }
    c = sum / area;  // floor: the sum is >= 0
  }
  out[(size_t)y * w * d + i] = (int16_t)c;
}

}  // namespace

// left: [H, W] and right: [H, W + ctx] int32 images; out: [H, W, D] int16.
extern "C" int stpu_sad_cost(const void* left, const void* right, void* out,
                             int h, int w, int d, int md, int wy, int wx,
                             int maxc, int ctx, int x_off, void* stream) {
  if (h <= 0 || h > 65535 || w <= 0 || d <= 0 || md < 0 || x_off < 0 ||
      ctx < 0 || wy <= 0 ||
      wx <= 0 || wy % 2 == 0 || wx % 2 == 0 ||
      (long long)w * d > (1LL << 31) - 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)(((long long)w * d + kThreads - 1) / kThreads), h);
  sad_cost_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(left), static_cast<const int*>(right),
      static_cast<int16_t*>(out), h, w, d, md, wy / 2, wx / 2, wy * wx, maxc,
      ctx, x_off);
  return (int)cudaGetLastError();
}

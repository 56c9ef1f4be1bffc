// K2 sgm_paths: one SGM path direction, added into the int16 sum S.
//
// Replaces stereo_tpu/ops/pallas/sgm_kernel.py:_h_kernel (the two
// horizontal paths), _v_kernel (the three down paths) and the path half of
// _v_fused_kernel (the three up paths). One launch per direction computes
//
//   L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d-1) + P1, L(p-r, d+1) + P1,
//                           min_k L(p-r, k) + P2) - min_k L(p-r, k)
//
// with L = C at each scanline's first pixel (stereo_tpu/ops/sgm.py:76-83)
// and stores S = L (first direction) or S += L (later directions).
//
// Adaptive P2 (stereo_tpu/ops/sgm.py:55-74, the Pallas kernels' `adaptive`
// and `cp_mode` forms): given the reference image, each step replaces P2
// with max(p2_min, P2 / g) where g = |I(p) - I(p-r)| - grad_floor > 0 (P2
// where g <= 0). The TPU precomputes eight [H, W] maps in XLA because it
// has no integer divide; here the warp reads I(p) once per step (one
// broadcast load, prefetched with the next pixel's C) and divides in
// registers, so no map touches device memory. The diagonals' predecessor
// is the diagonal neighbour for the image as for the carry; a scanline's
// first pixel has none and reads no gradient.
//
// Any D in [1, 256] and int8 or int16 costs: lanes hold DPL = ceil(D / 32)
// consecutive disparities, and the registers past D (half the warp at D =
// 16, the pyramid model's residual volume; the TPU packs several pixels'
// disparities into one vector there, `seg=`) load a cost of 2^24 instead of
// reading memory. Such a register's L stays in [2^24, 2^24 + P2]: it never
// wins min_k L and, plus P1, never beats min_k L + P2 as the d+-1 neighbour
// of a real disparity, so the edge rule at d = D-1 (skip the missing
// neighbour) holds at any lane; it is never stored. D = 32 * DPL is a form
// of its own (a template parameter) with no dead registers and, at D = 128,
// where every lane's 4 values are aligned, 4-wide vector loads and stores:
// guarding every load at run time made the D = 128 form a third slower on
// an H100 (700 W). This is also the staged S of sgm_aggregate_pallas (its
// _h_kernel and _v_kernel calls): S lands in device memory either way, and
// the selection kernel is a separate launch. SAD costs (up to 255) come as
// int16 and are read as such; S stays int16 under the same bound.
//
// Bound on the H100: each direction reads C (59.6 MB int8 at 375x1242x128)
// and reads and writes S (2 x 119 MB int16), about 90 us at the 3.35 TB/s
// published for an H100 SXM at 700 W. The horizontal directions have only H
// = 375 scanlines, so they are latency-bound: one dependent step per pixel
// along 1242 columns with few warps in flight (splitting lines or batching
// rows per warp would help). Design (the GPU SGM of arXiv 1610.04121): one
// warp per scanline, each lane holding D/32 consecutive disparities of the
// carry in registers; min_k L takes 5 xor shuffles, the d+-1 neighbours at
// lane edges come from shfl_up/down, and a missing neighbour at d=0 or d=D-1
// is skipped (the golden edge replicate adds P1 to L itself, which never
// wins). The next pixel's C and S are loaded before the current step's
// arithmetic, so their latency overlaps it. Directions run in sequence on
// one stream and one warp owns each pixel per direction, so the S update
// needs no atomics; 8 * (max_unary_cost + max(P2, p2_min)) < 2^15 keeps
// int16 exact (checked by the wrapper).

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// A register past D holds this cost (see the header).
constexpr int kDeadCost = 1 << 24;

// N values of T at p into v. Not PARTIAL: all N lie below D, and N == 4
// takes one vector load. PARTIAL: entries at or past `live` take `dead`
// and read nothing.
template <int N, bool PARTIAL, typename T>
__device__ __forceinline__ void load_lane(const T* p, int (&v)[N], int live,
                                          int dead) {
  if constexpr (PARTIAL) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = j < live ? (int)p[j] : dead;
  } else if constexpr (N == 4 && sizeof(T) == 1) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (int)(int8_t)(u >> (8 * j));
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = (int)(int16_t)(u.x & 0xffff);
    v[1] = (int)(int16_t)(u.x >> 16);
    v[2] = (int)(int16_t)(u.y & 0xffff);
    v[3] = (int)(int16_t)(u.y >> 16);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j];
  }
}

template <int N, bool PARTIAL>
__device__ __forceinline__ void store_sum(int16_t* p, const int (&s)[N],
                                          int live) {
  if constexpr (PARTIAL) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < live) p[j] = (int16_t)s[j];
    }
  } else if constexpr (N == 4) {
    uint2 v;
    v.x = (uint32_t)(uint16_t)s[0] | ((uint32_t)(uint16_t)s[1] << 16);
    v.y = (uint32_t)(uint16_t)s[2] | ((uint32_t)(uint16_t)s[3] << 16);
    *reinterpret_cast<uint2*>(p) = v;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = (int16_t)s[j];
  }
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// DPL = disparities per lane, ceil(D / 32); PARTIAL: D = d < 32 * DPL
// (registers past D are dead); ADAPTIVE: P2 from the image; CostT: int8
// (census, rank) or int16 (SAD) costs.
template <int DPL, bool PARTIAL, bool ADAPTIVE, typename CostT>
__global__ void sgm_path_kernel(const CostT* __restrict__ cost,
                                const int* __restrict__ image,
                                int16_t* __restrict__ sum, int h, int w,
                                int d, int step_y, int step_x, int p1, int p2,
                                int p2_min, int grad_floor, int accumulate,
                                int n_lines) {
  const int D = PARTIAL ? d : 32 * DPL;
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (line >= n_lines) return;  // uniform over the warp

  // First pixel of this scanline: the pixels whose predecessor p - r is
  // out of frame. Diagonals start on the entry row (W lines), then on the
  // entry column below or above the corner (H - 1 lines).
  int y, x;
  if (step_y == 0) {
    y = line;
    x = step_x > 0 ? 0 : w - 1;
  } else if (step_x == 0 || line < w) {
    x = line;
    y = step_y > 0 ? 0 : h - 1;
  } else {
    const int k = line - w + 1;
    x = step_x > 0 ? 0 : w - 1;
    y = step_y > 0 ? k : h - 1 - k;
  }

  const int live = D - lane * DPL;  // this lane's registers below D
  const ptrdiff_t voxel_step = ((ptrdiff_t)step_y * w + step_x) * D;
  ptrdiff_t off = ((ptrdiff_t)y * w + x) * D + lane * DPL;
  int c[DPL], s_old[DPL] = {}, L[DPL];
  load_lane<DPL, PARTIAL>(cost + off, c, live, kDeadCost);
  if (accumulate) load_lane<DPL, PARTIAL>(sum + off, s_old, live, 0);
  int img = 0, img_prev = 0, img_next = 0;  // I(p), I(p - r), I(p + r)
  if (ADAPTIVE) img = __ldg(image + (ptrdiff_t)y * w + x);

  bool first = true;
  while (true) {
    const int ny = y + step_y, nx = x + step_x;
    const bool more = ny >= 0 && ny < h && nx >= 0 && nx < w;
    const ptrdiff_t noff = off + voxel_step;
    int cn[DPL], sn[DPL] = {};
    if (more) {
      load_lane<DPL, PARTIAL>(cost + noff, cn, live, kDeadCost);
      if (accumulate) load_lane<DPL, PARTIAL>(sum + noff, sn, live, 0);
      if (ADAPTIVE) img_next = __ldg(image + (ptrdiff_t)ny * w + nx);
    }

    if (first) {
#pragma unroll
      for (int j = 0; j < DPL; ++j) L[j] = c[j];
      first = false;
    } else {
      int p2e = p2;
      if (ADAPTIVE) {
        const int grad = abs(img - img_prev) - grad_floor;
        if (grad > 0) p2e = max(p2_min, p2 / grad);  // floor: both >= 0
      }
      int m = L[0];
#pragma unroll
      for (int j = 1; j < DPL; ++j) m = min(m, L[j]);
      m = warp_min(m);
      const int below = __shfl_up_sync(kFull, L[DPL - 1], 1);  // d - 1
      const int above = __shfl_down_sync(kFull, L[0], 1);      // d + 1
      int nl[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        int cand = min(L[j], m + p2e);
        if (j > 0) {
          cand = min(cand, L[j - 1] + p1);
        } else if (lane > 0) {
          cand = min(cand, below + p1);
        }
        if (j < DPL - 1) {
          cand = min(cand, L[j + 1] + p1);
        } else if (lane < 31) {
          cand = min(cand, above + p1);
        }
        nl[j] = c[j] + cand - m;
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) L[j] = nl[j];
    }

    int out[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) out[j] = s_old[j] + L[j];
    store_sum<DPL, PARTIAL>(sum + off, out, live);

    if (!more) break;
    y = ny;
    x = nx;
    off = noff;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      c[j] = cn[j];
      s_old[j] = sn[j];
    }
    img_prev = img;
    img = img_next;
  }
}

template <int DPL, bool PARTIAL, typename CostT>
void launch(const void* cost, const int* image, int16_t* sum, int h, int w,
            int d, int step_y, int step_x, int p1, int p2, int p2_min,
            int grad_floor, int accumulate, cudaStream_t s) {
  int n_lines;
  if (step_y == 0) {
    n_lines = h;
  } else if (step_x == 0) {
    n_lines = w;
  } else {
    n_lines = w + h - 1;
  }
  const auto* c = static_cast<const CostT*>(cost);
  const int blocks = (n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (image != nullptr) {
    sgm_path_kernel<DPL, PARTIAL, true, CostT><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
        c, image, sum, h, w, d, step_y, step_x, p1, p2, p2_min, grad_floor,
        accumulate, n_lines);
  } else {
    sgm_path_kernel<DPL, PARTIAL, false, CostT><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
        c, image, sum, h, w, d, step_y, step_x, p1, p2, p2_min, grad_floor,
        accumulate, n_lines);
  }
}

}  // namespace

// cost: [H, W, D] int8 (cost_bytes 1) or int16 (cost_bytes 2); image: [H, W]
// int32 reference view for adaptive P2, or NULL for fixed P2.
extern "C" int stpu_sgm_path(const void* cost, int cost_bytes,
                             const void* image, void* sum, int h, int w,
                             int d, int step_y, int step_x, int p1, int p2,
                             int p2_min, int grad_floor, int accumulate,
                             void* stream) {
  if (h <= 0 || w <= 0 || d <= 0 || d > 256 || step_y < -1 || step_y > 1 ||
      step_x < -1 || step_x > 1 || (step_y == 0 && step_x == 0) ||
      (cost_bytes != 1 && cost_bytes != 2) || p1 < 0 || p2 < 0 ||
      p2_min < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* im = static_cast<const int*>(image);
  auto* s = static_cast<int16_t*>(sum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define STPU_PATH_AS(DPL, PARTIAL, T)                                       \
  launch<DPL, PARTIAL, T>(cost, im, s, h, w, d, step_y, step_x, p1, p2,     \
                          p2_min, grad_floor, accumulate, st)
#define STPU_PATH(DPL)                                                      \
  if (d == 32 * DPL) {                                                      \
    if (cost_bytes == 1) {                                                  \
      STPU_PATH_AS(DPL, false, int8_t);                                     \
    } else {                                                                \
      STPU_PATH_AS(DPL, false, int16_t);                                    \
    }                                                                       \
  } else if (cost_bytes == 1) {                                             \
    STPU_PATH_AS(DPL, true, int8_t);                                        \
  } else {                                                                  \
    STPU_PATH_AS(DPL, true, int16_t);                                       \
  }                                                                         \
  break
  switch ((d + 31) / 32) {
    case 1: STPU_PATH(1);
    case 2: STPU_PATH(2);
    case 3: STPU_PATH(3);
    case 4: STPU_PATH(4);
    case 5: STPU_PATH(5);
    case 6: STPU_PATH(6);
    case 7: STPU_PATH(7);
    default: STPU_PATH(8);
  }
#undef STPU_PATH
#undef STPU_PATH_AS
  return (int)cudaGetLastError();
}

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
// needs no atomics; 8 * (max_unary_cost + P2) < 2^15 keeps int16 exact
// (checked by the wrapper).

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int N>
__device__ __forceinline__ void load_cost(const int8_t* p, int (&c)[N]) {
  if constexpr (N == 4) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = (int)(int8_t)(v >> (8 * j));
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] = p[j];
  }
}

template <int N>
__device__ __forceinline__ void load_sum(const int16_t* p, int (&s)[N]) {
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    s[0] = (int)(int16_t)(v.x & 0xffff);
    s[1] = (int)(int16_t)(v.x >> 16);
    s[2] = (int)(int16_t)(v.y & 0xffff);
    s[3] = (int)(int16_t)(v.y >> 16);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = p[j];
  }
}

template <int N>
__device__ __forceinline__ void store_sum(int16_t* p, const int (&s)[N]) {
  if constexpr (N == 4) {
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

// DPL = disparities per lane (D / 32).
template <int DPL>
__global__ void sgm_path_kernel(const int8_t* __restrict__ cost,
                                int16_t* __restrict__ sum, int h, int w,
                                int step_y, int step_x, int p1, int p2,
                                int accumulate, int n_lines) {
  constexpr int D = 32 * DPL;
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

  const ptrdiff_t voxel_step = ((ptrdiff_t)step_y * w + step_x) * D;
  ptrdiff_t off = ((ptrdiff_t)y * w + x) * D + lane * DPL;
  int c[DPL], s_old[DPL] = {}, L[DPL];
  load_cost<DPL>(cost + off, c);
  if (accumulate) load_sum<DPL>(sum + off, s_old);

  bool first = true;
  while (true) {
    const int ny = y + step_y, nx = x + step_x;
    const bool more = ny >= 0 && ny < h && nx >= 0 && nx < w;
    const ptrdiff_t noff = off + voxel_step;
    int cn[DPL], sn[DPL] = {};
    if (more) {
      load_cost<DPL>(cost + noff, cn);
      if (accumulate) load_sum<DPL>(sum + noff, sn);
    }

    if (first) {
#pragma unroll
      for (int j = 0; j < DPL; ++j) L[j] = c[j];
      first = false;
    } else {
      int m = L[0];
#pragma unroll
      for (int j = 1; j < DPL; ++j) m = min(m, L[j]);
      m = warp_min(m);
      const int below = __shfl_up_sync(kFull, L[DPL - 1], 1);  // d - 1
      const int above = __shfl_down_sync(kFull, L[0], 1);      // d + 1
      int nl[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        int cand = min(L[j], m + p2);
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
    store_sum<DPL>(sum + off, out);

    if (!more) break;
    y = ny;
    x = nx;
    off = noff;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      c[j] = cn[j];
      s_old[j] = sn[j];
    }
  }
}

template <int DPL>
void launch(const int8_t* cost, int16_t* sum, int h, int w, int step_y,
            int step_x, int p1, int p2, int accumulate, cudaStream_t s) {
  int n_lines;
  if (step_y == 0) {
    n_lines = h;
  } else if (step_x == 0) {
    n_lines = w;
  } else {
    n_lines = w + h - 1;
  }
  const int blocks = (n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgm_path_kernel<DPL><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
      cost, sum, h, w, step_y, step_x, p1, p2, accumulate, n_lines);
}

}  // namespace

extern "C" int stpu_sgm_path(const void* cost, void* sum, int h, int w,
                             int d, int step_y, int step_x, int p1, int p2,
                             int accumulate, void* stream) {
  if (h <= 0 || w <= 0 || step_y < -1 || step_y > 1 || step_x < -1 ||
      step_x > 1 || (step_y == 0 && step_x == 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* c = static_cast<const int8_t*>(cost);
  auto* s = static_cast<int16_t*>(sum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: launch<1>(c, s, h, w, step_y, step_x, p1, p2, accumulate, st); break;
    case 64: launch<2>(c, s, h, w, step_y, step_x, p1, p2, accumulate, st); break;
    case 96: launch<3>(c, s, h, w, step_y, step_x, p1, p2, accumulate, st); break;
    case 128: launch<4>(c, s, h, w, step_y, step_x, p1, p2, accumulate, st); break;
    case 160: launch<5>(c, s, h, w, step_y, step_x, p1, p2, accumulate, st); break;
    case 192: launch<6>(c, s, h, w, step_y, step_x, p1, p2, accumulate, st); break;
    case 224: launch<7>(c, s, h, w, step_y, step_x, p1, p2, accumulate, st); break;
    case 256: launch<8>(c, s, h, w, step_y, step_x, p1, p2, accumulate, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

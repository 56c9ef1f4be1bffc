// K3 sgm_select: disparity selection on the summed volume S.
//
// Replaces the epilogue half of
// stereo_tpu/ops/pallas/sgm_kernel.py:_v_fused_kernel, in its base, emit_d0
// and emit_qr forms. Per pixel of one row it computes
//
//   * the left winner: c0 = min_d S, d0 = the first d with S = c0;
//   * uniqueness: f32(c2) > f32(c0) * f, c2 = min over |d - d0| > 1 and
//     f = f32(1 + ratio) rounded on the host as JAX rounds it
//     (stereo_tpu/ops/wta.py:65-73);
//   * subpixel: offset = f32(cm - cp) / f32(2 * denom) where
//     denom = cp + cm - 2 c0 > 0 (else 0), clipped to +-0.5, interior
//     winners only (wta.py:76-93); the integer parts are int32 and the
//     division is one IEEE __fdiv_rn, so no fast-math contraction can
//     change a bit;
//   * the cheap LR check: the right-view winner of column xr is the first
//     argmin over d of S(y, xr + md + d, d) with lanes past the frame
//     skipped (0 when none is left), and a pixel survives iff
//     xr = x - d0 - md is in frame and |d0 - dR(xr)| <= lr_tau
//     (stereo_tpu/ops/postprocess.py:24-62, 225-268).
//
// Framing (a column patch of a larger frame, parallel/bands.py): the block
// sits at global column x0 of a frame iw wide. "Past the frame" and "in
// frame" above are then global: a lane is skipped where x0 + xr + md + d >=
// iw, and the correspondence must have x0 + xr in [0, iw); the lookup
// itself clamps xr at 0 into the block. A lane whose source column lies
// past the block but inside the frame reads the block's last column, as
// the golden min(xr + md + d, W - 1) does: column W - 1 is a candidate for
// every right column it is clamped to. (The TPU kernel wraps mod W there
// instead; callers crop those columns.)
//
// The emit_qr form (the stitched runner's patches, _v_fused_kernel
// :1082-1112, :1181-1223) leaves the LR check open: only source columns in
// the owned range [own_lo, own_hi) feed the right view, which is extended
// by SP = spill_width(D, md) columns to the left of the block, and the
// kernel writes disp, the uniqueness gate and the LR verdict as separate
// bytes, d0, the packed partial min qr [H, W] = S * PD + d as float32 and
// the left spill [H, SP], with 3e38 for an empty column. (The TPU packs
// the gates as ok + 2 * lr + 4 * d0 into one word, a Mosaic economy not
// copied.) The TPU kernel's lr_bit is wrong by construction in the first
// D + md columns of a patch (its shift wraps mod W) and its tests compare
// it only past them; this kernel has no wrap, so lr_bit equals the golden
// lr_gate_from_right_map on the patch-local map everywhere.
//
// A negative md (the pyramid model's residual pass searches [-R/2, R/2))
// only shifts the winner, disp = (d0 + offset) + md in that order; it is
// taken with the cheap LR check off.
//
// Output: disp = d0 + offset + md (f32), valid (one byte, 0/1) and, if
// its pointer is set, the integer winner lane d0 (int32; the emit_d0 form,
// which the TPU packs as ok + 2 * d0 into one word). The exact LR check
// compares d0, since the subpixel disparity cannot be rounded back to it
// (offsets reach +-0.5 on ties).
//
// Any D in [1, 256]: lanes hold ceil(D / 32) disparities each, and when D
// is not a multiple of 32 (tsukuba_sad16 has D = 16) the lanes past D hold
// INT_MAX, so they never win the argmin, never lower the uniqueness
// runner-up and take no part in the right view. Keys stay below 2^23
// (S < 2^15, PD <= 256).
//
// Bound on the H100: one read of S, 119 MB int16 at 375x1242x128 (about 36
// us at the 3.35 TB/s published for an H100 SXM at 700 W). Design: one block
// per row. Phase 1 gives each warp whole pixels (lanes hold D/32 consecutive
// disparities, one coalesced load per pixel): it reduces the left winner
// with warp shuffles and keeps (d0, disp, unique) in shared memory, and it
// folds the same registers into the right view, where source pixel x lane d
// is a candidate for right column xr = x - md - d: a shared-memory atomicMin
// of the integer key S * PD + d (PD = power of two >= D) keeps the smallest
// cost and, among ties, the smallest d, i.e. the golden first argmin. After
// __syncthreads, phase 2 runs the LR test per pixel from shared memory and
// writes the row. S is read once instead of twice. Shared memory is 13 bytes
// per column plus 4 per spill column (38.4 KB at W = 2880); rows too wide for
// the card's 227 KB are refused.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr float kEmpty = 3e38f;      // an empty packed min, as the reference

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
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

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Where the block sits in its frame and, for the emit_qr form, what it
// owns and where its extra outputs go (qr == NULL: not that form).
struct Frame {
  int x0, iw;            // global column of block column 0; frame width
  int own_lo, own_hi;    // emit_qr: source columns that feed the right view
  int sp;                // emit_qr: spill columns left of the block
  uint8_t* lr_bit;       // emit_qr: [H, W] LR verdict
  float* qr;             // emit_qr: [H, W] packed partial min
  float* spill;          // emit_qr: [H, SP] packed partial min
};

// A right-view key as the reference packs it: S * pd + d with pd the
// smallest power of two >= D (the kernel's own radix PD is a power of two
// >= 32 * DPL, which differs for D <= 16), or 3e38 for an empty column.
__device__ __forceinline__ float packed_min(int key, int PD, int pd) {
  if (key == INT_MAX) return kEmpty;
  return (float)((key / PD) * pd + (key & (PD - 1)));
}

size_t smem_bytes(int w, int sp) {
  return (size_t)(w + sp) * sizeof(int) +
         (size_t)w * (sizeof(int) + sizeof(float) + sizeof(uint8_t));
}

// DPL = disparities per lane; PARTIAL: D = d < 32 * DPL (masked lanes).
template <int DPL, bool PARTIAL>
__global__ void sgm_select_kernel(const int16_t* __restrict__ sum,
                                  float* __restrict__ disp,
                                  uint8_t* __restrict__ valid,
                                  int* __restrict__ d0_out, int w, int d,
                                  int md, int subpixel, int uniqueness,
                                  float uniq_f, int lr_check, float lr_tau,
                                  Frame f) {
  const int D = PARTIAL ? d : 32 * DPL;
  constexpr int PD = pow2_at_least(32 * DPL);
  const bool emit_qr = f.qr != nullptr;
  const int sp = emit_qr ? f.sp : 0;
  const int pd = pow2_at_least(D);
  extern __shared__ unsigned char smem[];
  // Right-view keys of block-local columns [-sp, w): column xr at xr + sp.
  int* rkey = reinterpret_cast<int*>(smem);
  int* d0s = rkey + sp + w;                        // [w] left winner
  float* disps = reinterpret_cast<float*>(d0s + w);  // [w] refined disp
  uint8_t* oks = reinterpret_cast<uint8_t*>(disps + w);  // [w] unique

  const int y = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row = (size_t)y * w;
  // Source columns that feed the right view: inside the frame and, with
  // emit_qr, owned.
  const int src_lo = emit_qr ? f.own_lo : 0;
  const int src_hi = min(emit_qr ? f.own_hi : w, f.iw - f.x0);

  for (int i = threadIdx.x; i < sp + w; i += blockDim.x) rkey[i] = INT_MAX;
  __syncthreads();

  for (int x = warp; x < w; x += nwarps) {
    int v[DPL];
    const int dbase = lane * DPL;
    if (PARTIAL) {
      const int16_t* p = sum + (row + x) * D;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        v[j] = dbase + j < D ? (int)p[dbase + j] : INT_MAX;
      }
    } else {
      load_sum<DPL>(sum + (row + x) * D + dbase, v);
    }

    int c0 = v[0];
#pragma unroll
    for (int j = 1; j < DPL; ++j) c0 = min(c0, v[j]);
    c0 = warp_min(c0);
    int first = D;
#pragma unroll
    for (int j = DPL - 1; j >= 0; --j) {
      if (v[j] == c0) first = dbase + j;
    }
    const int d0 = warp_min(first);

    bool ok = true;
    if (uniqueness) {
      int c2 = INT_MAX;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        if (abs(dbase + j - d0) > 1) c2 = min(c2, v[j]);
      }
      c2 = warp_min(c2);
      ok = (float)c2 > __fmul_rn((float)c0, uniq_f);
    }

    float dv = (float)d0;
    if (subpixel && d0 > 0 && d0 < D - 1) {  // uniform over the warp
      int cm = INT_MAX, cp = INT_MAX;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        if (dbase + j == d0 - 1) cm = v[j];
        if (dbase + j == d0 + 1) cp = v[j];
      }
      cm = warp_min(cm);
      cp = warp_min(cp);
      const int denom = cp + cm - 2 * c0;
      float off = 0.0f;
      if (denom > 0) off = __fdiv_rn((float)(cm - cp), (float)(2 * denom));
      off = fminf(fmaxf(off, -0.5f), 0.5f);
      dv = __fadd_rn(dv, off);
    }
    dv = __fadd_rn(dv, (float)md);

    if (lane == 0) {
      d0s[x] = d0;
      disps[x] = dv;
      oks[x] = ok;
    }
    if (lr_check && x >= src_lo && x < src_hi) {
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int dd = dbase + j;
        if (PARTIAL && dd >= D) continue;
        const int key = v[j] * PD + dd;
        const int xr = x - md - dd;
        if (xr >= -sp) atomicMin(&rkey[xr + sp], key);
        if (!emit_qr && x == w - 1) {
          // Lanes whose source lies past the block but inside the frame
          // read this last column: right columns up to the frame's edge.
          const int last = min(w - 1, f.iw - 1 - f.x0 - md - dd);
          for (int xc = max(xr + 1, 0); xc <= last; ++xc) {
            atomicMin(&rkey[xc], key);
          }
        }
      }
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    bool ok = oks[x];
    bool lr_ok = true;
    int key = INT_MAX;
    if (lr_check) {
      const int d0 = d0s[x];
      const int xr = x - d0 - md;  // <= x: only the clamp at 0 can bind
      const int dr_key = rkey[max(xr, 0) + sp];
      const int dr = dr_key == INT_MAX ? 0 : (dr_key & (PD - 1));
      lr_ok = f.x0 + xr >= 0 && f.x0 + xr < f.iw &&
              fabsf((float)(d0 - dr)) <= lr_tau;
      key = rkey[x + sp];
    }
    disp[row + x] = disps[x];
    if (emit_qr) {
      valid[row + x] = ok ? 1 : 0;
      f.lr_bit[row + x] = lr_ok ? 1 : 0;
      f.qr[row + x] = packed_min(key, PD, pd);
    } else {
      valid[row + x] = ok && lr_ok ? 1 : 0;
    }
    if (d0_out != nullptr) d0_out[row + x] = d0s[x];
  }
  if (emit_qr) {
    for (int j = threadIdx.x; j < sp; j += blockDim.x) {
      f.spill[(size_t)y * sp + j] = packed_min(rkey[j], PD, pd);
    }
  }
}

template <int DPL, bool PARTIAL>
int launch(const int16_t* sum, float* disp, uint8_t* valid, int* d0, int h,
           int w, int d, int md, int subpixel, int uniqueness, float uniq_f,
           int lr_check, float lr_tau, const Frame& f, cudaStream_t s) {
  const size_t smem = smem_bytes(w, f.qr != nullptr ? f.sp : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgm_select_kernel<DPL, PARTIAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sgm_select_kernel<DPL, PARTIAL><<<h, kThreads, smem, s>>>(
      sum, disp, valid, d0, w, d, md, subpixel, uniqueness, uniq_f, lr_check,
      lr_tau, f);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 if a row of w columns (and sp spill slots, 0 without emit_qr) fits a
// block's shared memory, else 0: the one place that knows the layout.
extern "C" int stpu_sgm_select_fits(int w, int sp) {
  return smem_bytes(w, sp) <= kMaxSmem ? 1 : 0;
}

// d0: [H, W] int32 winner lanes, or NULL when not wanted. x0, iw: the
// block's global column origin and the frame's width (0 and w for a whole
// frame). qr != NULL selects the emit_qr form: valid then holds the
// uniqueness gate alone, and lr_bit [H, W] bytes, qr [H, W] and spill
// [H, sp] floats are written from the source columns [own_lo, own_hi); it
// needs d0 and lr_check.
extern "C" int stpu_sgm_select(const void* sum, void* disp, void* valid,
                               void* d0, int h, int w, int d, int md,
                               int subpixel, int uniqueness, float uniq_f,
                               int lr_check, float lr_tau, int x0, int iw,
                               void* lr_bit, void* qr, void* spill,
                               int own_lo, int own_hi, int sp,
                               void* stream) {
  // md < 0 only without the cheap LR check, whose right-view columns
  // x - md - d would leave the row's shared-memory keys.
  if (h <= 0 || w <= 0 || d <= 0 || d > 256 || (md < 0 && lr_check) ||
      x0 < 0 || iw < x0 + w) {
    return (int)cudaErrorInvalidValue;
  }
  if (qr != nullptr &&
      (!lr_check || d0 == nullptr || lr_bit == nullptr || spill == nullptr ||
       own_lo < 0 || own_hi > w || own_lo > own_hi || sp < d + md - 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* s = static_cast<const int16_t*>(sum);
  auto* o = static_cast<float*>(disp);
  auto* v = static_cast<uint8_t*>(valid);
  auto* w0 = static_cast<int*>(d0);
  const Frame f{x0, iw, own_lo, own_hi, sp, static_cast<uint8_t*>(lr_bit),
                static_cast<float*>(qr), static_cast<float*>(spill)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define STPU_SELECT(DPL)                                                    \
  if (d % 32 == 0) {                                                        \
    return launch<DPL, false>(s, o, v, w0, h, w, d, md, subpixel,           \
                              uniqueness, uniq_f, lr_check, lr_tau, f, st); \
  }                                                                         \
  return launch<DPL, true>(s, o, v, w0, h, w, d, md, subpixel, uniqueness,  \
                           uniq_f, lr_check, lr_tau, f, st)
  switch ((d + 31) / 32) {
    case 1: STPU_SELECT(1);
    case 2: STPU_SELECT(2);
    case 3: STPU_SELECT(3);
    case 4: STPU_SELECT(4);
    case 5: STPU_SELECT(5);
    case 6: STPU_SELECT(6);
    case 7: STPU_SELECT(7);
    default: STPU_SELECT(8);
  }
#undef STPU_SELECT
}

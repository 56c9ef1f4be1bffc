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
// A tile of the halo-tiled pipeline (parallel/tiling.py) is framed the
// same way at any origin: x0 < 0 on the frame's left edge, and x0 + W > iw
// on its right edge (the tile's halo and padding). Sources at or past the
// frame's edge are skipped as above, and past the edge the block's last
// column feeds no right column. Only a block that misses the frame is
// refused.
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
// its pointer is set, the integer winner d0 (int32; the emit_d0 form,
// which the TPU packs as ok + 2 * d0 into one word). The exact LR check
// compares d0, since the subpixel disparity cannot be rounded back to it
// (offsets reach +-0.5 on ties).
//
// Any D in [1, 256]; right-view keys are S * pd + d with pd the smallest
// power of two >= D, the reference's packing, and stay below 2^23
// (S < 2^15).
//
// Bound on the H100: one read of S, 119 MB int16 at 375x1242x128 (about 36
// us at the 3.35 TB/s published for an H100 SXM at 700 W). Design: one block
// per row, and one lane per pixel: a warp takes 64 consecutive columns, two
// per lane (x and x + 32, two independent chains), and walks the
// disparities in order. The per-pixel warp reductions of a
// lane-per-disparity layout (three or more reductions and two shuffles per
// pixel, and D / 32 shared-memory atomics per lane and pixel) become a few
// integer instructions per (pixel, d), shared by the 32 pixels of an
// instruction:
//   * the left winner is a running strict minimum (first argmin), and the
//     uniqueness runner-up is kept on the way: the prefix minimum up to
//     d - 2 when a new minimum appears at d, then the minimum of the
//     values from d + 2 on;
//   * the right view is a diagonal minimum carried across lanes: lane L at
//     step d holds the partial min for right column x - md - d, which at
//     step d + 1 is lane L + 1's column, so one __shfl_up_sync per step
//     moves the carries (lane 0 takes lane 31's, from x + 31 to x + 32);
//     lane 0's first pixel starts a new column and the 64th pixel's leaves
//     the warp with one single-lane shared-memory atomicMin into the row's
//     keys (the other warps' partial mins for that column land there too;
//     a sink slot takes the columns left of the spill, so the atomic needs
//     no test);
//   * the parabola's neighbours are two loads once d0 is known.
// S reaches the lanes through shared memory: each warp double-buffers
// chunks of its 64 pixels' next 32 disparities (4 KB each) with cp.async,
// 16 coalesced bytes per lane, and each lane reads its pixels' rows there
// 16 bytes at a time (rows swizzled so that 8 lanes' 16-byte reads hit
// distinct banks). Rows that are not whole 16-byte units (D % 8 != 0) are
// staged by element loads. (d0, disp, unique) go to shared memory; after
// __syncthreads the LR test runs per pixel from shared memory and writes
// the row. Shared memory is 13 bytes per column plus 4 per spill column
// plus 64 KB of staging (101 KB at W = 2880); rows too wide for the
// card's 227 KB are refused.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 2;                 // pixels per lane: x and x + 32
constexpr int kGroup = 32 * kPix;       // columns per warp item
constexpr int kChunk = 32;              // disparities per staged chunk
constexpr int kUnits = kChunk / 8;      // 16-byte units per pixel and chunk
constexpr int kStage = kGroup * kUnits;  // 16-byte units per staged chunk
constexpr int kStages = 2;              // chunks a warp keeps in its ring
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr float kEmpty = 3e38f;      // an empty packed min, as the reference

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

// A right-view key as the reference packs it, or 3e38 for an empty column.
__device__ __forceinline__ float packed_min(int key) {
  return key == INT_MAX ? kEmpty : (float)key;
}

// Bytes before the staging buffers (rounded to 16), and in all.
__host__ __device__ constexpr size_t row_bytes(int w, int sp) {
  return ((size_t)(w + sp + 1) * 4 + (size_t)w * 9 + 15) / 16 * 16;
}
size_t smem_bytes(int w, int sp) {
  return row_bytes(w, sp) + (size_t)kWarps * kStages * kStage * 16;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kStages - 1 of the calling lane's copy groups are
// pending.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Slot of pixel p's 16-byte unit u in a staged chunk: rows of kUnits
// units, swizzled so that lanes 8k .. 8k + 7 reading one unit each hit 8
// distinct 16-byte bank groups.
__device__ __forceinline__ int slot(int p, int u) {
  return p * kUnits + (u ^ ((p / (8 / kUnits)) & (kUnits - 1)));
}

// The warp stages disparities [dc, dc + kChunk) of the pixels
// [xw, xw + kGroup) of row `srow` (columns past w repeat column w - 1)
// into `buf`: with VEC (rows of whole 16-byte units) one cp.async per
// unit, else element by element.
template <bool VEC>
__device__ __forceinline__ void stage(uint4* buf, const int16_t* srow,
                                      int xw, int w, int D, int dc,
                                      int lane) {
  if (VEC) {
    const int units = min(kUnits, (D - dc) / 8);
#pragma unroll
    for (int i = lane; i < kStage; i += 32) {
      const int p = i / kUnits, u = i % kUnits;
      if (u < units) {
        cp_async16(buf + slot(p, u),
                   srow + (size_t)min(xw + p, w - 1) * D + dc + 8 * u);
      }
    }
  } else {
    int16_t* b = reinterpret_cast<int16_t*>(buf);
    for (int e = lane; e < kGroup * kChunk; e += 32) {
      const int p = e / kChunk, j = e % kChunk;
      if (dc + j < D) {
        b[8 * slot(p, j / 8) + j % 8] =
            srow[(size_t)min(xw + p, w - 1) * D + dc + j];
      }
    }
  }
}

// The 8 sign-extended int16 values of a 16-byte unit, in order.
__device__ __forceinline__ void unpack8(const uint4& u, int (&v)[8]) {
  const unsigned q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = (int)(int16_t)(q[j] & 0xffff);
    v[2 * j + 1] = (int)(int16_t)(q[j] >> 16);
  }
}

// VEC: D % 8 == 0; UNIQ: the uniqueness test; LR: the cheap LR check.
template <bool VEC, bool UNIQ, bool LR>
__global__ void __launch_bounds__(kThreads)
sgm_select_kernel(const int16_t* __restrict__ sum, float* __restrict__ disp,
                  uint8_t* __restrict__ valid, int* __restrict__ d0_out,
                  int w, int D, int md, int subpixel, float uniq_f,
                  float lr_tau, Frame f) {
  const bool emit_qr = f.qr != nullptr;
  const int sp = emit_qr ? f.sp : 0;
  const int pd = pow2_at_least(D);
  extern __shared__ __align__(16) unsigned char smem[];
  // Right-view keys of block-local columns [-sp, w): column xr at
  // xr + sp + 1; slot 0 is a sink for the columns left of -sp.
  int* rkey = reinterpret_cast<int*>(smem);
  int* d0s = rkey + sp + w + 1;                    // [w] left winner
  float* disps = reinterpret_cast<float*>(d0s + w);  // [w] refined disp
  uint8_t* oks = reinterpret_cast<uint8_t*>(disps + w);  // [w] unique

  const int y = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This warp's ring of staging buffers.
  uint4* ring = reinterpret_cast<uint4*>(smem + row_bytes(w, sp)) +
                warp * kStages * kStage;
  const size_t row = (size_t)y * w;
  const int16_t* srow = sum + row * D;
  // Source columns that feed the right view: inside the frame and, with
  // emit_qr, owned.
  const int src_lo = emit_qr ? f.own_lo : 0;
  const int src_hi = min(emit_qr ? f.own_hi : w, f.iw - f.x0);
  // Where right column xr's key lives: the sink left of -sp, and past the
  // row (where only the empty key INT_MAX arrives) the last column.
  auto key_at = [&](int xr) {
    return rkey + min(max(xr + sp + 1, 0), sp + w);
  };

  for (int i = threadIdx.x; i < sp + w + 1; i += kThreads) rkey[i] = INT_MAX;
  __syncthreads();

  // The warp's items: (group of kGroup columns, chunk of disparities),
  // chunks fastest; items t + 1 .. t + kStages - 1 are in flight while
  // item t is walked. Lane L holds pixels xw + L and xw + 32 + L.
  const int nch = (D + kChunk - 1) / kChunk;
  const int groups = (w + kGroup - 1) / kGroup;
  const int mine = warp < groups ? (groups - warp + kWarps - 1) / kWarps : 0;
  const int items = mine * nch;
  auto fetch = [&](int t) {
    if (t < items) {
      stage<VEC>(ring + (t % kStages) * kStage, srow,
                 kGroup * (warp + kWarps * (t / nch)), w, D,
                 kChunk * (t % nch), lane);
    }
    cp_async_commit();  // one group per item, empty past the end
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  int c0[kPix], d0[kPix], lft[kPix], q[kPix], pm1[kPix], pm2[kPix];
  int carry[kPix], mask[kPix];
  bool fresh[kPix];
  for (int t = 0; t < items; ++t) {
    fetch(t + kStages - 1);
    cp_async_wait_ring();
    __syncwarp();
    const int xw = kGroup * (warp + kWarps * (t / nch));
    const int dc = kChunk * (t % nch);
    if (dc == 0) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        // A pixel's keys enter the right view iff it is a source column;
        // the others carry INT_MAX (max with the mask keeps the key or
        // INT_MAX).
        const int x = xw + 32 * k + lane;
        mask[k] = LR && x < w && x >= src_lo && x < src_hi ? INT_MIN
                                                           : INT_MAX;
        c0[k] = INT_MAX;
        d0[k] = 0;
        lft[k] = q[k] = pm1[k] = pm2[k] = carry[k] = INT_MAX;
        fresh[k] = false;
      }
    }
    const uint4* buf = ring + (t % kStages) * kStage;
    const int n = min(kChunk, D - dc);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      if (8 * u >= n) break;
      int v[kPix][8];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        unpack8(buf[slot(32 * k + lane, u)], v[k]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = dc + 8 * u + j;
        if (!VEC && d >= D) break;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          // Selects, not branches: lanes disagree on `lower`.
          const int s = v[k][j];
          const bool lower = s < c0[k];
          if (UNIQ) {
            // c2 = min(lft, q): lft the prefix min up to d0 - 2, q the
            // min from d0 + 2 on (the step right after a new minimum,
            // d0 + 1, is the one that does not fold).
            const int qn = fresh[k] ? q[k] : min(q[k], s);
            q[k] = lower ? INT_MAX : qn;
            lft[k] = lower ? pm2[k] : lft[k];
            fresh[k] = lower;
            pm2[k] = pm1[k];
            pm1[k] = min(pm1[k], s);
          }
          c0[k] = lower ? s : c0[k];
          d0[k] = lower ? d : d0[k];
        }
        if (LR) {
          // After step d each carry moves up one pixel: pixel x carries
          // right column x - md - d - 1, taken over from pixel x - 1. Lane
          // 0's first pixel starts a new column, and the last pixel's
          // column (xw + kGroup - 1 - md - d) leaves the warp, folded into
          // the row's keys by lane 0.
          int up[kPix];
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const int own = min(carry[k], max(v[k][j] * pd + d, mask[k]));
            up[k] = __shfl_sync(kFull, own, (lane + 31) & 31);
          }
          if (lane == 0) {
            atomicMin(key_at(xw + kGroup - 1 - md - d), up[kPix - 1]);
          }
#pragma unroll
          for (int k = kPix - 1; k > 0; --k) {
            carry[k] = lane == 0 ? up[k - 1] : up[k];
          }
          carry[0] = lane == 0 ? INT_MAX : up[0];
        }
      }
    }
    __syncwarp();  // every lane is done with this buffer before its refill
    if (dc + kChunk < D) continue;

    // The group's last chunk: finish its pixels.
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int x = xw + 32 * k + lane;
      const int16_t* p = srow + (size_t)min(x, w - 1) * D;
      // The carry still in flight: pixel x holds column x - md - D.
      if (LR) atomicMin(key_at(x - md - D), carry[k]);
      bool ok = true;
      if (UNIQ) {
        ok = (float)min(lft[k], q[k]) > __fmul_rn((float)c0[k], uniq_f);
      }
      float dv = (float)d0[k];
      if (subpixel && d0[k] > 0 && d0[k] < D - 1) {
        const int cm = p[d0[k] - 1], cp = p[d0[k] + 1];
        const int denom = cp + cm - 2 * c0[k];
        float off = 0.0f;
        if (denom > 0) off = __fdiv_rn((float)(cm - cp), (float)(2 * denom));
        off = fminf(fmaxf(off, -0.5f), 0.5f);
        dv = __fadd_rn(dv, off);
      }
      dv = __fadd_rn(dv, (float)md);
      if (x < w) {
        d0s[x] = d0[k];
        disps[x] = dv;
        oks[x] = ok;
      }
    }
    if (LR && !emit_qr && xw + kGroup >= w && w - 1 >= src_lo &&
        w - 1 < src_hi) {
      // This group holds the block's last column, a source: sources past
      // the block but inside the frame read it, so each of its keys is a
      // candidate for every right column up to the frame's edge that such
      // a source feeds (none for a whole frame). Lanes split the
      // disparities.
      const int16_t* p = srow + (size_t)(w - 1) * D;
      for (int d = lane; d < D; d += 32) {
        const int key = (int)p[d] * pd + d;
        const int last = min(w - 1, f.iw - 1 - f.x0 - md - d);
        for (int xc = max(w - md - d, 0); xc <= last; ++xc) {
          atomicMin(key_at(xc), key);
        }
      }
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < w; x += kThreads) {
    bool ok = oks[x];
    bool lr_ok = true;
    int key = INT_MAX;
    if (LR) {
      const int d0 = d0s[x];
      const int xr = x - d0 - md;  // <= x: only the clamp at 0 can bind
      const int dr_key = *key_at(max(xr, 0));
      const int dr = dr_key == INT_MAX ? 0 : (dr_key & (pd - 1));
      lr_ok = f.x0 + xr >= 0 && f.x0 + xr < f.iw &&
              fabsf((float)(d0 - dr)) <= lr_tau;
      key = *key_at(x);
    }
    disp[row + x] = disps[x];
    if (emit_qr) {
      valid[row + x] = ok ? 1 : 0;
      f.lr_bit[row + x] = lr_ok ? 1 : 0;
      f.qr[row + x] = packed_min(key);
    } else {
      valid[row + x] = ok && lr_ok ? 1 : 0;
    }
    if (d0_out != nullptr) d0_out[row + x] = d0s[x];
  }
  if (emit_qr) {
    for (int j = threadIdx.x; j < sp; j += kThreads) {
      f.spill[(size_t)y * sp + j] = packed_min(rkey[j + 1]);
    }
  }
}

template <bool VEC, bool UNIQ, bool LR>
int launch(const int16_t* sum, float* disp, uint8_t* valid, int* d0, int h,
           int w, int d, int md, int subpixel, float uniq_f, float lr_tau,
           const Frame& f, cudaStream_t s) {
  const size_t smem = smem_bytes(w, f.qr != nullptr ? f.sp : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgm_select_kernel<VEC, UNIQ, LR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sgm_select_kernel<VEC, UNIQ, LR><<<h, kThreads, smem, s>>>(
      sum, disp, valid, d0, w, d, md, subpixel, uniq_f, lr_tau, f);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_vec(const int16_t* sum, float* disp, uint8_t* valid, int* d0,
               int h, int w, int d, int md, int subpixel, int uniqueness,
               float uniq_f, int lr_check, float lr_tau, const Frame& f,
               cudaStream_t s) {
  if (uniqueness && lr_check) {
    return launch<VEC, true, true>(sum, disp, valid, d0, h, w, d, md,
                                   subpixel, uniq_f, lr_tau, f, s);
  }
  if (uniqueness) {
    return launch<VEC, true, false>(sum, disp, valid, d0, h, w, d, md,
                                    subpixel, uniq_f, lr_tau, f, s);
  }
  if (lr_check) {
    return launch<VEC, false, true>(sum, disp, valid, d0, h, w, d, md,
                                    subpixel, uniq_f, lr_tau, f, s);
  }
  return launch<VEC, false, false>(sum, disp, valid, d0, h, w, d, md,
                                   subpixel, uniq_f, lr_tau, f, s);
}

}  // namespace

// 1 if a row of w columns (and sp spill slots, 0 without emit_qr) fits a
// block's shared memory, else 0: the one place that knows the layout.
extern "C" int stpu_sgm_select_fits(int w, int sp) {
  return smem_bytes(w, sp) <= kMaxSmem ? 1 : 0;
}

// d0: [H, W] int32 winner lanes, or NULL when not wanted. x0, iw: the
// block's global column origin, of any sign, and the frame's width (0 and w
// for a whole frame); the block overlaps the frame. qr != NULL selects the emit_qr form: valid then holds the
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
      x0 >= iw || x0 + w <= 0) {
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
  if (d % 8 == 0) {
    return launch_vec<true>(s, o, v, w0, h, w, d, md, subpixel, uniqueness,
                            uniq_f, lr_check, lr_tau, f, st);
  }
  return launch_vec<false>(s, o, v, w0, h, w, d, md, subpixel, uniqueness,
                           uniq_f, lr_check, lr_tau, f, st);
}

// K2 sgm_paths: one SGM path direction (or the horizontal pair, both
// horizontals at once), added into the int16 sum S.
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
// Rectangle form (RECT; replaces the Pallas kernels' `bounds` form,
// stereo_tpu/ops/pallas/sgm_kernel.py:66-81, the halo-tiled pipeline's tile
// of a larger frame): given the tile's in-frame rectangle [y_lo, y_hi) x
// [x_lo, x_hi), L = C wherever a pixel's predecessor p - r lies outside it,
// whatever the pixel's own place. That is the plain masked recurrence
// (stereo_tpu_torch/ops/sgm.py, `valid` = the rectangle) over the WHOLE
// tile, where the TPU kernels leave the pixels outside the rectangle
// undefined. A scanline is a straight line and the rectangle convex, so
// its pixels inside the rectangle are one run of steps [t_in, t_out); the
// step t keeps its carry iff t_in < t <= t_out, else it zeroes L first
// (L = 0 gives L = C, as at a scanline's first pixel). The test is per
// step, not per round, and uniform over the warp; the whole-frame form
// (RECT false) compiles without it, so its step is unchanged.
//
// Sheared form (SHEAR; the exact reshard mode's diagonals,
// stereo_tpu/parallel/exact.py, stereo_tpu/ops/sgm.py:127-157, 238-256): a
// vertical scan of a band of the sheared volume [H, W+H-1, D], in which
// the down-right (sign +1: sheared column x' holds frame column
// x' + y - (H-1)) or down-left (sign -1: x' - y) diagonals are columns.
// Given the band's global sheared column origin x0' and the frame width W,
// the scanline of sheared column x = x0' + line keeps its carry only over
// the one run of rows whose source column lies in the frame, 0 <= x + y -
// (H-1) < W or 0 <= x - y < W: outside the run L = C, and the run's first
// row starts fresh. That is the rectangle form's per-step test with the
// run [t_in, t_out) of each line taken from the shear instead of the
// rectangle, computed once per line; the plain twin is the masked vertical
// recurrence under the reference's sheared validity (_shear(valid) &
// geometry), over the whole band, the rows outside the run too. Under
// adaptive P2 the vertical predecessor in the sheared image is the frame's
// diagonal predecessor, so the gradient needs nothing new.
//
// Mask form (MASK; the reference's golden path under an arbitrary `valid`
// mask, stereo_tpu/ops/sgm.py:83, and every family of its constrained
// composition, :232-256, whose sheared validity is a mask too): given an
// [H, W] byte mask of the block, step t keeps its carry iff t > 0 and
// mask[pixel t - 1]; otherwise L = 0, so L = C, whatever the pixel's own
// byte. A scanline may restart many times. Lane 1 stages the 4-byte word
// that holds a pixel's byte into its ring slot beside I(p), so a round's
// bytes arrive with its C and S, after the same wait, and the test on the
// chain is a bit of a register, uniform over the warp. Under adaptive P2
// nothing changes at a restart: L = C whatever P2 is.
//
// Adaptive P2 (stereo_tpu/ops/sgm.py:55-74, the Pallas kernels' `adaptive`
// and `cp_mode` forms): given the reference image, each step replaces P2
// with max(p2_min, P2 / g) where g = |I(p) - I(p-r)| - grad_floor > 0 (P2
// where g <= 0). The TPU precomputes eight [H, W] maps in XLA because it
// has no integer divide; here the warp stages I(p) with the pixel's C and
// divides in registers, so no map touches device memory: lane g divides
// for step g of a round, so the warp issues one divide a round, and each
// step takes its P2 by a shuffle. The diagonals'
// predecessor is the diagonal neighbour for the image as for the carry; a
// scanline's first pixel has none and reads no gradient.
//
// Horizontal pair (RUN = kPair; the whole form's two horizontals in
// one launch): both horizontals of a row chain 1242 dependent steps at
// KITTI size with only 375 rows to spread over 132 SMs, so one direction
// takes as long as its chain, however few rows; run one after the other
// they cost two chains. The pair runs them at once, one block of two warps
// per row: warp 0 scans left to right, warp 1 right to left, each with its
// own ring and the lone direction's body. Both start together and step at
// the same pace, so warp 0 reaches the left half [0, ceil(W/2)) first and
// warp 1 the right half. Phase 0: each warp scans its first half and
// stores S as a lone direction does (L, or S_old + L when the pair is not
// the call's first launch). Then each warp drains its ring, fences, and
// the block meets at one __syncthreads. Phase 1: each warp carries its L
// on into the other half, where it reads the S the other warp stored in
// phase 0 and adds its L. The ring must not cross the midpoint: a copy of
// second-half S staged before the barrier would read S before the other
// warp stored it, so each phase stages only its own steps and phase 1
// refills the ring from the midpoint (three rounds, once per row). The
// carry, the adaptive predecessor I(p - r) and each step are a lone
// direction's, and integer adds in either order give the same int16 sum,
// so S is bit for bit what the two launches give: the partial sum S_old +
// L_first lies below the full one, which the wrapper's bound keeps in
// int16. No atomics, and the same bytes move as in two launches.
//
// Sweep groups (RUN = kGroup; the whole form's three down directions, (1,
// 0), (1, 1) and (1, -1), in one launch, and the three up ones in
// another): a single direction reads C and reads and writes S, so six of
// them move S six times where two groups move it twice. A group sweeps the
// frame's rows t = 0, 1, ... (frame row t going down, h - 1 - t going up)
// and keeps the three carries of a pixel in the registers of one warp,
// reads its C (and its four image words under adaptive P2) once, and
// stores S_old + L_v + L_d1 + L_d2 once (the sum alone as the call's first
// launch). The warp owns a sheared column u = x + t: its pixels are (t, u -
// t), so it walks along the (1, -1) diagonal, whose carry stays in its
// registers. The vertical carry of (t, x) comes from the warp of column u -
// 1 and the (1, 1) diagonal's from u - 2, both from row t - 1: every carry
// flows toward larger u, never back. A block is a strip of k adjacent
// sheared columns [u0, u0 + k), a warp each, which step the rows together,
// one barrier a row, handing their two carries on through shared memory
// (two rows of slots, so one barrier a row does). Its first two warps take
// theirs from the strip before, u0 - 2 and u0 - 1, whose last two warps
// store them to an edge buffer in device memory every row: each 64-bit
// word holds a pair of 16-bit values and the launch's tag, and a load sees
// such a word whole or not at all, so a word that holds this launch's tag
// holds its value, with no flag and no fence. The first two warps read the
// next row's words ahead and read again while a tag is an older launch's.
// A strip waits only on the strip before it, never on the one after, and
// never on a block that has not started: each block takes its strip from
// a ticket counter as it starts. The edge buffer has a row for every strip
// and row, so no strip waits for room; the last block done zeroes the
// counters and leaves the tag, which the next launch counts on from. The
// carries are handled as pairs of 16-bit halves (Hopper's 16x2 minimum and
// add-minimum instructions): every value lies in [0, 2^15), so the halves
// never carry into each other. k: as many warps as fit the shared memory
// (group_warps), which makes the chain of strips across the frame short.
// Integer adds in any order give the same int16 sum, so S is bit for bit
// what the three single launches give.
//
// Any D in [1, 256] and int8 or int16 costs: lanes hold DPL = ceil(D / 32)
// consecutive disparities, and the registers past D (half the warp at D =
// 16, the pyramid model's residual volume; the TPU packs several pixels'
// disparities into one vector there, `seg=`) take a cost of 2^24 instead of
// a staged one. Such a register's L stays in [2^24, 2^24 + P2]: it never
// wins min_k L and, plus P1, never beats min_k L + P2 as the d+-1 neighbour
// of a real disparity, so the edge rule at d = D-1 (skip the missing
// neighbour) holds at any lane; it is never stored. D = 32 * DPL is a form
// of its own (a template parameter, not PARTIAL) whose loads and stores are
// vectors. This is also the staged S of sgm_aggregate_pallas (its _h_kernel
// and _v_kernel calls): S lands in device memory either way, and the
// selection kernel is a separate launch. SAD costs (up to 255) come as
// int16; S stays int16 under the same bound.
//
// Bound on the H100: each direction reads C (59.6 MB int8 at 375x1242x128)
// and reads and writes S (2 x 119 MB int16), about 90 us at the 3.35 TB/s
// published for an H100 SXM at 700 W. Each scanline is a chain of
// dependent steps, so a direction is bound by the length of one step times
// the longest scanline where scanlines are few (the horizontals at KITTI
// size: 375 warps for 132 SMs, 1242 steps) and by the bytes in flight where
// they are many (the horizontal pair runs the horizontals' two chains at
// once). Design (the GPU SGM of arXiv 1610.04121, deep-staged): one warp
// per scanline, each lane holding D/32 consecutive disparities of the
// carry in registers, one warp per block so that few scanlines still reach
// every SM. Each warp owns a ring of kStages slots in shared memory and
// keeps the C, S (when accumulating) and I(p) (adaptive) of its scanline's
// next three rounds of pixels in flight with cp.async: 16-byte copies for
// rows of whole 16-byte chunks, the 4-byte words that cover the row
// otherwise (its start then lies 0-3 bytes into the slot). A round reads
// its pixels' inputs into registers after one wait, then runs their steps
// back to back: min_k L in one __reduce_min_sync, the d+-1 neighbours at
// lane edges from shfl_up/down, the adaptive divide off the chain, S stored
// from registers. A missing neighbour at d=0 or d=D-1 is skipped (the
// golden edge replicate adds P1 to L itself, which never wins). Launches
// run in sequence on one stream and one warp owns each pixel per
// direction (the pair's two warps each own one half of the row at a
// time), so the S update needs no atomics; 8 * (max_unary_cost +
// max(P2, p2_min)) < 2^15 keeps int16 exact (checked by the wrapper).

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

// This file builds twice, one nvcc each, in parallel: as itself, with the
// C entry points and the instances for int8 costs, and included by
// sgm_paths_int16.cu (STPU_K2_INT16) with the instances for int16 costs,
// which ::stpu_k2::launch_int16 launches.
namespace stpu_k2 {

// The rectangle's bounds (the RECT form's arguments) and, for the SHEAR
// form, the sheared band's shear sign (+1 or -1), its global sheared
// column origin and the frame's width; for the sweep groups, their
// counters and tag and their edge buffer (stpu_sgm_path).
struct Rect {
  int y_lo, y_hi, x_lo, x_hi;
  int shear, x0, frame_w;
  int* sync;
  uint64_t* edge;
};

int launch_int16(const void* cost, const int* image, const uint8_t* mask,
                 int16_t* sum, int h, int w, int d, int step_y, int step_x,
                 int p1, int p2, int p2_min, int grad_floor, int accumulate,
                 int run, const Rect& r, cudaStream_t s);

}  // namespace stpu_k2

using stpu_k2::Rect;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// A register past D holds this cost (see the header).
constexpr int kDeadCost = 1 << 24;

// Pixels a warp handles per round (see the kernel's loop), for D = 32 *
// dpl disparities: the carry's registers grow with dpl * round.
__host__ __device__ constexpr int round_pixels(int dpl) {
  return dpl <= 2 ? 8 : 4;
}

// Pixels in a warp's ring: four rounds, the current one and three in
// flight.
__host__ __device__ constexpr int ring_stages(int dpl) {
  return 4 * round_pixels(dpl);
}

// One ring slot: a pixel's C, its S, then I(p) and the word holding its
// mask byte, each part a multiple of 16 bytes, with room for the 0-3
// leading bytes of a word-aligned copy.
__host__ __device__ constexpr int slot_c(int dpl, int cost_bytes) {
  return 32 * dpl * cost_bytes + 16;
}
__host__ __device__ constexpr int slot_s(int dpl) { return 64 * dpl + 16; }
__host__ __device__ constexpr int slot_bytes(int dpl, int cost_bytes) {
  return slot_c(dpl, cost_bytes) + slot_s(dpl) + 16;
}
__host__ __device__ constexpr int ring_smem(int dpl, int cost_bytes) {
  return ring_stages(dpl) * slot_bytes(dpl, cost_bytes);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp copies a row of `bytes` bytes at `src` into `dst`. A row of
// whole 16-byte chunks (at most 512 bytes; src is then 16-byte aligned, as
// every row of a 16-byte aligned volume is) takes one 16-byte copy per
// lane. Any other row takes the 4-byte words that cover it, from the word
// holding src, so its bytes start at dst + (src & 3).
__device__ __forceinline__ void stage_bytes(char* dst, const void* src,
                                            int bytes, int lane) {
  if (bytes % 16 == 0) {
    if (lane * 16 < bytes) {
      cp_async16(dst + lane * 16, static_cast<const char*>(src) + lane * 16);
    }
  } else {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const char* base = reinterpret_cast<const char*>(a & ~uintptr_t(3));
    const int n = (int)(a & 3) + bytes;
    for (int i = lane * 4; i < n; i += 32 * 4) cp_async4(dst + i, base + i);
  }
}

// Element j of type T in little-endian words w.
template <typename T, int W>
__device__ __forceinline__ int element(const uint32_t (&w)[W], int j) {
  if constexpr (sizeof(T) == 1) {
    return (int)(int8_t)(w[j >> 2] >> (8 * (j & 3)));
  } else {
    return (int)(int16_t)(w[j >> 1] >> (16 * (j & 1)));
  }
}

// N values of T at p (shared memory) into v. Not PARTIAL: all N lie below
// D and p is aligned to N * sizeof(T), so rows of 4, 8 or 16 bytes take one
// vector read. PARTIAL: entries at or past `live` take `dead` and read
// nothing.
template <int N, bool PARTIAL, typename T>
__device__ __forceinline__ void read_lane(const T* p, int (&v)[N], int live,
                                          int dead) {
  constexpr int kRow = N * (int)sizeof(T);
  if constexpr (PARTIAL) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = j < live ? (int)p[j] : dead;
  } else if constexpr (kRow == 4 || kRow == 8 || kRow == 16) {
    uint32_t w[kRow / 4];
    if constexpr (kRow == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (kRow == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x;
      w[1] = u.y;
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = element<T>(w, j);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j];
  }
}

// N sums to p (device memory), as read_lane reads them.
template <int N, bool PARTIAL>
__device__ __forceinline__ void store_sum(int16_t* p, const int (&s)[N],
                                          int live) {
  if constexpr (PARTIAL) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < live) p[j] = (int16_t)s[j];
    }
  } else if constexpr (N == 2 || N == 4 || N == 8) {
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      w[i] = (uint32_t)(uint16_t)s[2 * i] |
             ((uint32_t)(uint16_t)s[2 * i + 1] << 16);
    }
    if constexpr (N == 2) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else if constexpr (N == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = (int16_t)s[j];
  }
}

// The steps [a, b) of a scanline that starts at coordinate p, moves by
// step (-1, 0 or 1) and has n pixels, at which the coordinate lies in
// [lo, hi).
__device__ __forceinline__ void axis_run(int p, int step, int lo, int hi,
                                         int n, int& a, int& b) {
  if (step == 0) {
    a = 0;
    b = p >= lo && p < hi ? n : 0;
  } else if (step > 0) {
    a = lo - p;
    b = hi - p;
  } else {
    a = p - hi + 1;
    b = p - lo + 1;
  }
}

// Where a scanline keeps its carry: on every step (kWhole), over its run
// inside a rectangle (kRect), over the run of rows of a sheared column
// whose source column lies in the frame (kShear), or after each pixel
// whose mask byte is set (kMask). kPair is the whole form's two
// horizontals in one launch, kGroup a sweep group (see the header).
enum Run { kWhole = 0, kRect = 1, kShear = 2, kMask = 3, kPair = 4,
           kGroup = 5 };

// Most warps of a sweep group's block.
constexpr int kGroupWarps = 19;

// Warps per block: one per scanline, two (one per direction) for kPair,
// at most kGroupWarps for kGroup (a strip of sheared columns).
__host__ __device__ constexpr int block_warps(int run) {
  return run == kPair ? 2 : run == kGroup ? kGroupWarps : 1;
}

// The sweep groups' instances: int8 costs at D = 256 and 128, the only
// blocks launch_plan gives them (its groups_pay).
template <int DPL, bool PARTIAL, typename CostT>
constexpr bool group_built() {
  return !PARTIAL && (DPL == 8 || DPL == 4) && sizeof(CostT) == 1;
}

// A group warp's ring: three rounds, the current one and two in flight.
__host__ __device__ constexpr int group_stages(int dpl) {
  return 3 * round_pixels(dpl);
}

// Shared memory of a group block of `warps` warps: their rings, then the
// int16 carry rows (32 * dpl entries) of the V and the (1, 1) carries each
// warp hands on, two rows of each.
__host__ __device__ constexpr int group_smem(int dpl, int cost_bytes,
                                             int warps) {
  return warps * group_stages(dpl) * slot_bytes(dpl, cost_bytes) +
         2 * 2 * warps * 64 * dpl;
}

// Shared memory a block may use on the H100 (227 KB).
constexpr int kBlockSmem = 232448;

// Warps of a group block for d disparities: the strip's width. Each
// strip hands its edge to the next through device memory, a hop that the
// whole frame's chain of strips pays once each, so the strip is as wide as
// its rings let one block be: kGroupWarps, or fewer where D's rings do not
// fit (measured on the H100 at 1988 x 2880 x 256: 16 warps 4.34 ms for the
// down group, 19 warps 4.01).
int group_warps(int d) {
  int k = kGroupWarps;
  while (k > 2 && group_smem((d + 31) / 32, 1, k) > kBlockSmem) --k;
  return k;
}

// W 32-bit words at p (shared or device memory, 4 * W-byte aligned, W =
// 1, 2 or 4) as one access.
template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&v)[W]) {
  static_assert(W == 1 || W == 2 || W == 4, "a vector of 4, 8 or 16 bytes");
  if constexpr (W == 1) {
    v[0] = *static_cast<const uint32_t*>(p);
  } else if constexpr (W == 2) {
    const uint2 u = *static_cast<const uint2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
    const uint4 u = *static_cast<const uint4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&v)[W]) {
  static_assert(W == 2 || W == 4, "a vector of 8 or 16 bytes");
  if constexpr (W == 2) {
    *static_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *static_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The same to device memory, as a streaming store: nothing in the launch
// reads it again.
template <int W>
__device__ __forceinline__ void store_words_cs(void* p,
                                               const uint32_t (&v)[W]) {
  static_assert(W == 2 || W == 4, "a vector of 8 or 16 bytes");
  if constexpr (W == 2) {
    __stcs(static_cast<uint2*>(p), make_uint2(v[0], v[1]));
  } else {
    __stcs(static_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
  }
}

// One step of each of a group's three directions, on the carries as pairs
// of 16-bit halves (word i of a lane holds disparities 2i and 2i + 1 of
// its DPL): L(p) from L(p - r) and C(p), for the three carries at once, so
// that their warp reductions and shuffles are in flight together. Every
// value is an integer in [0, 2^15) (C >= 0; L <= max C + P2 and S below the
// wrapper's bound), so the halves' minima are unsigned 16-bit ones and
// c + cand - m, added as whole words, carries and borrows nothing across
// halves. A missing neighbour at d = -1 or D takes 0x7fff, which plus P1
// never wins.
template <int DPL>
__device__ __forceinline__ void group_step(uint32_t (&L)[3][DPL / 2],
                                           const uint32_t (&c)[DPL / 2],
                                           int p1, const int (&p2e)[3],
                                           int lane) {
  constexpr int W = DPL / 2;
  const uint32_t p1x2 = (uint32_t)p1 * 0x10001u;
  int m[3];
  uint32_t below[3], above[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    uint32_t mm = L[q][0];
#pragma unroll
    for (int i = 1; i < W; ++i) mm = __vminu2(mm, L[q][i]);
    m[q] = (int)min(mm & 0xffffu, mm >> 16);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) m[q] = __reduce_min_sync(kFull, m[q]);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    // The word whose high half is d - 1 of word 0, and the one whose low
    // half is d + 1 of the last word.
    below[q] = __shfl_up_sync(kFull, L[q][W - 1], 1);
    above[q] = __shfl_down_sync(kFull, L[q][0], 1);
    if (lane == 0) below[q] = 0x7fff0000u;
    if (lane == 31) above[q] = 0x00007fffu;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint32_t mp2 = (uint32_t)(m[q] + p2e[q]) * 0x10001u;
    const uint32_t mx2 = (uint32_t)m[q] * 0x10001u;
    uint32_t out[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t prev = __byte_perm(i > 0 ? L[q][i - 1] : below[q],
                                        L[q][i], 0x5432);
      const uint32_t next = __byte_perm(L[q][i],
                                        i < W - 1 ? L[q][i + 1] : above[q],
                                        0x5432);
      uint32_t cand = __vminu2(L[q][i], mp2);
      cand = __viaddmin_u16x2(prev, p1x2, cand);
      cand = __viaddmin_u16x2(next, p1x2, cand);
      out[i] = c[i] + cand - mx2;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) L[q][i] = out[i];
  }
}

// A tagged edge word: a 16-bit pair of a carry row and the launch's tag
// in one 64-bit word, which a load sees whole or not at all.
__device__ __forceinline__ void store_tagged(uint64_t* p, uint32_t w0,
                                             uint32_t w1, uint32_t tag) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};\n" ::"l"(p),
               "l"((uint64_t)w0 | ((uint64_t)tag << 32)),
               "l"((uint64_t)w1 | ((uint64_t)tag << 32))
               : "memory");
}

// W tagged words of an edge row at p, as they are now.
template <int W>
__device__ __forceinline__ void load_tagged(const uint64_t* p,
                                            uint64_t (&v)[W]) {
#pragma unroll
  for (int i = 0; i < W; i += 2) {
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];\n"
                 : "=l"(v[i]), "=l"(v[i + 1])
                 : "l"(p + i)
                 : "memory");
  }
}

// The values of the W tagged words of the edge row at p (out), from the
// words read ahead (v), which are read again until every one holds the
// tag.
template <int W>
__device__ __forceinline__ void take_tagged(const uint64_t* p,
                                            uint64_t (&v)[W], uint32_t tag,
                                            uint32_t (&out)[W]) {
  while (true) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < W; ++i) ok = ok && (uint32_t)(v[i] >> 32) == tag;
    if (__all_sync(kFull, ok)) break;
    load_tagged<W>(p, v);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = (uint32_t)v[i];
}

// A sweep group (RUN = kGroup; see the header): dir = +1 the down group,
// -1 the up group. sync: [0] the ticket counter, [1] the blocks done, [2]
// the tag of the last launch; edge: [blocks][h][3][32][DPL / 2] tagged
// words, strip b's row t: the V carry of its last warp, the (1, 1) carry of
// the one before it and of its last, each lane's words together.
template <int DPL, bool PARTIAL, bool ADAPTIVE, typename CostT>
__device__ __forceinline__ void group_sweep(
    const CostT* __restrict__ cost, const int* __restrict__ image,
    int16_t* __restrict__ sum, int h, int w, int dir, int p1, int p2,
    int p2_min, int grad_floor, int accumulate, int* __restrict__ sync,
    uint64_t* __restrict__ edge) {
  constexpr int kCB = (int)sizeof(CostT);
  constexpr int kRound = round_pixels(DPL);
  constexpr int kStages = group_stages(DPL);
  constexpr int kSlot = slot_bytes(DPL, kCB);
  constexpr int kC = slot_c(DPL, kCB);
  constexpr int kS = slot_s(DPL);
  constexpr int kVec = 32 * DPL;  // entries of an int16 carry row
  constexpr int W = DPL / 2;      // 32-bit words a lane holds of a row
  constexpr int kEdgeVec = 32 * W;  // tagged words of an edge carry row
  static_assert(3 * kRound <= 32, "a lane per divide of a round");
  static_assert(!PARTIAL && W % 2 == 0, "the groups' instances: whole lanes");
  extern __shared__ __align__(16) char smem[];
  __shared__ int ticket;
  __shared__ uint32_t tag_s;
  const int D = 32 * DPL;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = (int)(blockDim.x >> 5);  // the strip's width
  int16_t* const xv = reinterpret_cast<int16_t*>(smem + k * kStages * kSlot);
  int16_t* const xd = xv + 2 * k * kVec;  // [2][k][kVec] each
  if (threadIdx.x == 0) {
    ticket = atomicAdd(&sync[0], 1);
    tag_s = *reinterpret_cast<volatile uint32_t*>(&sync[2]) + 1;
  }
  __syncthreads();
  const int b = ticket;
  const uint32_t tag = tag_s;
  const int u0 = b * k;
  // The rows this strip has pixels on.
  const int t_lo = max(0, u0 - (w - 1));
  const int t_hi = min(h, u0 + k);

  char* const ring = smem + warp * (kStages * kSlot);
  const int u = u0 + warp;
  // This warp's pixels: rows [a, e), pixel (t, u - t); none past the
  // frame's last sheared column.
  const int a = max(0, u - (w - 1));
  const int e = min(h, u + 1);
  const ptrdiff_t row_step = dir > 0 ? w : -(ptrdiff_t)w;  // (t+1, x)
  const ptrdiff_t pix_step = row_step - 1;
  // The pixel at row t (t may lie outside [a, e): arithmetic only).
  auto pix_at = [&](int t) {
    return (ptrdiff_t)(dir > 0 ? a : h - 1 - a) * w + (u - a) +
           (ptrdiff_t)(t - a) * pix_step;
  };
  // Strip s's edge row t, this lane's words of its carry row q.
  auto edge_at = [&](int s, int t, int q) {
    return edge + (((ptrdiff_t)s * h + t) * 3 + q) * kEdgeVec + lane * W;
  };
  const int acc = accumulate;
  // Start row t's copies into `slot` as one commit group (empty where the
  // warp has no pixel): C, S, then I(p) and the image words of its three
  // predecessors, V, (1, 1) and (1, -1), where they lie in the frame.
  auto stage = [&](int t, char* slot) {
    if (t >= a && t < e) {
      const ptrdiff_t pix = pix_at(t);
      const ptrdiff_t off = pix * D;
      stage_bytes(slot, cost + off, D * kCB, lane);
      if (acc) stage_bytes(slot + kC, sum + off, 2 * D, lane);
      if (ADAPTIVE) {
        const int x = u - t;
        const ptrdiff_t pred = pix - row_step;
        if (lane == 0) cp_async4(slot + kC + kS, image + pix);
        if (t > 0) {
          if (lane == 1) cp_async4(slot + kC + kS + 4, image + pred);
          if (lane == 2 && x > 0) {
            cp_async4(slot + kC + kS + 8, image + pred - 1);
          }
          if (lane == 3 && x < w - 1) {
            cp_async4(slot + kC + kS + 12, image + pred + 1);
          }
        }
      }
    }
    cp_async_commit();
  };

  uint32_t L[3][W];  // the V, (1, 1) and (1, -1) carries, as 16-bit pairs
  // The first two warps' edge words read ahead (V and (1, 1); warp 1 the
  // (1, 1) only): tag 0, which no launch has, until read.
  uint64_t ahead_v[W], ahead_d[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    L[0][i] = L[1][i] = L[2][i] = 0;
    ahead_v[i] = ahead_d[i] = 0;
  }
  // The ring holds three rounds: round r of the strip in slots
  // (r % 3) * kRound on.
#pragma unroll 1
  for (int i = 0; i < kStages - kRound; ++i) stage(t_lo + i, ring + i * kSlot);
  int base = 0;  // the current round's first slot
#pragma unroll 1
  for (int t0 = t_lo; t0 < t_hi; t0 += kRound) {
    char* const cur = ring + base * kSlot;
    // Round r + 2 takes the slots of round r - 1.
    char* const ahead =
        ring + (base == 0 ? kStages - kRound : base - kRound) * kSlot;
    base = base == kStages - kRound ? 0 : base + kRound;
    __syncwarp();  // every lane has read the slots refilled below
#pragma unroll
    for (int g = 0; g < kRound; ++g) {
      stage(t0 + kStages - kRound + g, ahead + g * kSlot);
    }
    cp_async_wait<kStages - kRound>();
    __syncwarp();
    // ADAPTIVE: lane q < 3 * kRound divides for direction q / kRound at
    // step q % kRound; each step takes its three P2s by shuffles.
    int p2_lane = p2;
    if (ADAPTIVE && lane < 3 * kRound) {
      const int* words = reinterpret_cast<const int*>(
          cur + (lane % kRound) * kSlot + kC + kS);
      const int grad = abs(words[0] - words[1 + lane / kRound]) - grad_floor;
      if (grad > 0) p2_lane = max(p2_min, p2 / grad);  // floor: both >= 0
    }
    ptrdiff_t off = pix_at(t0) * D + lane * DPL;
#pragma unroll 1
    for (int g = 0; g < kRound; ++g, off += pix_step * D) {
      const int t = t0 + g;
      if (t >= t_hi) break;  // uniform over the block
      int p2e[3] = {p2, p2, p2};
      if (ADAPTIVE) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          p2e[q] = __shfl_sync(kFull, p2_lane, q * kRound + g);
        }
      }
      if (t >= a && t < e) {
        const int x = u - t;
        // The carries of the predecessors, from the warps of columns u - 1
        // and u - 2, or for the first two warps from the strip before's
        // edge rows, once they hold this launch's tag; L = 0 where a
        // predecessor leaves the frame, so L = C.
        const int16_t* const prev_v = xv + ((t - 1) & 1) * k * kVec;
        const int16_t* const prev_d = xd + ((t - 1) & 1) * k * kVec;
        if (t == 0) {
#pragma unroll
          for (int i = 0; i < W; ++i) L[0][i] = 0;
        } else if (warp > 0) {
          load_words<W>(prev_v + (warp - 1) * kVec + lane * DPL, L[0]);
        } else {
          take_tagged<W>(edge_at(b - 1, t - 1, 0), ahead_v, tag, L[0]);
        }
        if (t == 0 || x == 0) {
#pragma unroll
          for (int i = 0; i < W; ++i) L[1][i] = 0;
        } else if (warp > 1) {
          load_words<W>(prev_d + (warp - 2) * kVec + lane * DPL, L[1]);
        } else {
          take_tagged<W>(edge_at(b - 1, t - 1, 1 + warp), ahead_d, tag, L[1]);
        }
        if (t == 0 || x == w - 1) {
#pragma unroll
          for (int i = 0; i < W; ++i) L[2][i] = 0;
        }
        const char* const slot = cur + g * kSlot;
        // C as 16-bit pairs: its bytes, zero-extended (costs are >= 0).
        uint32_t cw[W / 2], c[W];
        load_words<W / 2>(slot + lane * DPL, cw);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          c[i] = __byte_perm(cw[i / 2], 0, (i & 1) ? 0x4342 : 0x4140);
        }
        group_step<DPL>(L, c, p1, p2e, lane);
        uint32_t sw[W];
        if (acc) {
          load_words<W>(slot + kC + lane * DPL * 2, sw);
        } else {
#pragma unroll
          for (int i = 0; i < W; ++i) sw[i] = 0;
        }
        // S_old + L_v + L_d1 + L_d2 in int16 halves: the three carries add
        // as whole words (each half stays below 2^15), S_old by halves.
#pragma unroll
        for (int i = 0; i < W; ++i) {
          sw[i] = __vadd2(sw[i], L[0][i] + L[1][i] + L[2][i]);
        }
        store_words_cs<W>(sum + off, sw);
        // Hand the V and (1, 1) carries on: to the next warps, and from
        // the strip's last two warps to the strip after it.
        int16_t* const next_v = xv + (t & 1) * k * kVec + warp * kVec;
        int16_t* const next_d = xd + (t & 1) * k * kVec + warp * kVec;
        store_words<W>(next_v + lane * DPL, L[0]);
        store_words<W>(next_d + lane * DPL, L[1]);
        if (warp >= k - 2) {
          // The strip after reads these, tagged, in device memory.
#pragma unroll
          for (int i = 0; i < W; i += 2) {
            if (warp == k - 1) {
              store_tagged(edge_at(b, t, 0) + i, L[0][i], L[0][i + 1], tag);
              store_tagged(edge_at(b, t, 2) + i, L[1][i], L[1][i + 1], tag);
            } else {
              store_tagged(edge_at(b, t, 1) + i, L[1][i], L[1][i + 1], tag);
            }
          }
        }
      }
      // The first two warps read the strip before's edge row t ahead,
      // which row t + 1 takes.
      if (warp < 2 && b > 0 && t + 1 < e) {
        if (warp == 0) load_tagged<W>(edge_at(b - 1, t, 0), ahead_v);
        load_tagged<W>(edge_at(b - 1, t, 1 + warp), ahead_d);
      }
      // Row t's carries are stored before any warp reads them.
      __syncthreads();
    }
  }
  cp_async_wait<0>();
  // The last block done zeroes the counters and leaves this launch's tag
  // for the next launch to count on from.
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(&sync[1], 1) == (int)gridDim.x - 1) {
    sync[0] = 0;
    sync[1] = 0;
    sync[2] = (int)tag;
  }
}

template <int DPL, bool PARTIAL, bool ADAPTIVE, int RUN, typename CostT>
__global__ void __launch_bounds__(32 * block_warps(RUN))
    sgm_path_kernel(const CostT* __restrict__ cost,
                    const int* __restrict__ image,
                    const uint8_t* __restrict__ mask,
                    int16_t* __restrict__ sum, int h, int w, int d,
                    int step_y, int step_x, int p1, int p2, int p2_min,
                    int grad_floor, int accumulate, Rect rect) {
  if constexpr (RUN == kGroup) {  // step_y: +1 the down group, -1 the up
    group_sweep<DPL, PARTIAL, ADAPTIVE, CostT>(
        cost, image, sum, h, w, step_y, p1, p2, p2_min, grad_floor,
        accumulate, rect.sync, rect.edge);
    return;
  }
  constexpr int kCB = (int)sizeof(CostT);
  constexpr int kStages = ring_stages(DPL);
  constexpr int kRound = round_pixels(DPL);
  static_assert(kStages % kRound == 0 && kStages > kRound, "ring");
  constexpr int kSlot = slot_bytes(DPL, kCB);
  constexpr int kC = slot_c(DPL, kCB);
  constexpr int kS = slot_s(DPL);
  extern __shared__ __align__(16) char smem[];  // kStages slots a warp
  const int D = PARTIAL ? d : 32 * DPL;
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x;  // one block per scanline
  // kPair: warp 0 scans the row left to right, warp 1 right to left.
  const int warp = RUN == kPair ? (int)(threadIdx.x >> 5) : 0;
  char* const ring = smem + warp * (kStages * kSlot);
  if (RUN == kPair) {
    step_y = 0;
    step_x = warp == 0 ? 1 : -1;
  }

  // First pixel of this scanline: the pixels whose predecessor p - r is
  // out of frame. Diagonals start on the entry row (W lines), then on the
  // entry column below or above the corner (H - 1 lines). n: its pixels.
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
  int n = step_x == 0 ? h : w;
  if (step_y != 0 && step_x != 0) {
    n = min(step_y > 0 ? h - y : y + 1, step_x > 0 ? w - x : x + 1);
  }
  const ptrdiff_t pix_step = (ptrdiff_t)step_y * w + step_x;
  const ptrdiff_t voxel_step = pix_step * D;
  const ptrdiff_t pix0 = (ptrdiff_t)y * w + x;
  const ptrdiff_t off0 = pix0 * D;
  const int live = D - lane * DPL;  // this lane's registers below D
  // RECT and SHEAR: the steps whose pixel lies in the run, [t_in, t_out);
  // step t keeps its carry iff its predecessor t - 1 does: t_in < t <=
  // t_out. SHEAR scans a column (step_x = 0): its run is the rows [lo, hi)
  // whose source column x' + y - (H-1) (sign +1) or x' - y (sign -1) lies
  // in [0, W).
  int t_in = 0, t_out = n;
  if (RUN == kRect) {
    int ay, by, ax, bx;
    axis_run(y, step_y, rect.y_lo, rect.y_hi, n, ay, by);
    axis_run(x, step_x, rect.x_lo, rect.x_hi, n, ax, bx);
    t_in = max(max(ay, ax), 0);
    t_out = min(min(by, bx), n);
  } else if (RUN == kShear) {
    const int xs = rect.x0 + x;
    const int lo = rect.shear > 0 ? h - 1 - xs : xs - rect.frame_w + 1;
    int a, b;
    axis_run(y, step_y, max(lo, 0), min(lo + rect.frame_w, h), n, a, b);
    t_in = max(a, 0);
    t_out = min(b, n);
  }

  // The steps [t_lo, t_hi) that the current phase runs: the whole
  // scanline, or for kPair the warp's first half (phase 0: the pixels it
  // reaches before the other warp) and then the rest (phase 1, which adds
  // into the S the other warp stored in its phase 0).
  int t_lo = 0, t_hi = n;
  int acc = accumulate;  // S is read and added to
  // Start pixel t's copies (pixel pix, its voxels at off) into its slot,
  // as one commit group (an empty one past the phase's end).
  auto stage = [&](int t, ptrdiff_t pix, ptrdiff_t off) {
    if (t < t_hi) {
      char* slot = ring + (t & (kStages - 1)) * kSlot;
      stage_bytes(slot, cost + off, D * kCB, lane);
      if (acc) stage_bytes(slot + kC, sum + off, 2 * D, lane);
      if (ADAPTIVE && lane == 0) cp_async4(slot + kC + kS, image + pix);
      if (RUN == kMask && lane == 1) {  // the word holding pix's byte
        cp_async4(slot + kC + kS + 4, mask + (pix & ~ptrdiff_t(3)));
      }
    }
    cp_async_commit();
  };
  // Read pixel t's C, S, I(p) and mask byte (voxels at off) from its slot.
  auto read = [&](int t, ptrdiff_t off, int (&c)[DPL], int (&s_old)[DPL],
                  int& img, unsigned& on) {
    const char* slot = ring + (t & (kStages - 1)) * kSlot;
    const int c_shift =
        PARTIAL ? (int)(reinterpret_cast<uintptr_t>(cost + off) & 3) : 0;
    read_lane<DPL, PARTIAL>(
        reinterpret_cast<const CostT*>(slot + c_shift) + lane * DPL, c, live,
        kDeadCost);
    if (acc) {
      const int s_shift =
          PARTIAL ? (int)(reinterpret_cast<uintptr_t>(sum + off) & 3) : 0;
      read_lane<DPL, PARTIAL>(
          reinterpret_cast<const int16_t*>(slot + kC + s_shift) + lane * DPL,
          s_old, live, 0);
    } else {
#pragma unroll
      for (int j = 0; j < DPL; ++j) s_old[j] = 0;
    }
    img = ADAPTIVE ? *reinterpret_cast<const int*>(slot + kC + kS) : 0;
    if (RUN == kMask) {
      const ptrdiff_t pix = pix0 + (ptrdiff_t)t * pix_step;
      on = slot[kC + kS + 4 + (int)(pix & 3)] != 0;
    }
  };

  // L = 0 before the first pixel: the recurrence then gives L = C there
  // (P1, P2 >= 0, so every candidate is >= 0 and min_k L = 0).
  int L[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) L[j] = 0;
  int img_prev = 0;  // I(p - r)
  unsigned on_prev = 0;  // the mask byte of p - r (none before t = 0)
#pragma unroll 1
  for (int phase = 0; phase < block_warps(RUN); ++phase) {
    if (RUN == kPair) {
      const int half = warp == 0 ? (w + 1) / 2 : w / 2;
      if (phase == 0) {
        t_hi = half;
      } else {
        // Phase 0 staged nothing past the midpoint (stage stops at t_hi),
        // so no copy of the other half's S was made before its store.
        cp_async_wait<0>();
        __threadfence_block();
        __syncthreads();  // both halves' S stored and visible
        t_lo = half;
        t_hi = n;
        acc = 1;
      }
    }
    // A round handles kRound pixels: it refills the kRound slots of the
    // round before, waits once for its own pixels (the kStages - kRound
    // newest groups may stay in flight), reads their C, S and I(p) into
    // registers, and then runs their kRound steps back to back, so waits
    // and shared-memory latency stay off the chain of dependent steps.
    ptrdiff_t ahead_pix = pix0 + (ptrdiff_t)t_lo * pix_step;  // staged next
    ptrdiff_t ahead = ahead_pix * D;
#pragma unroll 1
    for (int t = t_lo; t < t_lo + kStages - kRound; ++t) {
      stage(t, ahead_pix, ahead);
      ahead_pix += pix_step;
      ahead += voxel_step;
    }
    ptrdiff_t off = off0 + (ptrdiff_t)t_lo * voxel_step;
#pragma unroll 1
    for (int t0 = t_lo; t0 < t_hi; t0 += kRound) {
      __syncwarp();  // every lane has read the slots refilled below
#pragma unroll
      for (int g = 0; g < kRound; ++g) {
        stage(t0 + kStages - kRound + g, ahead_pix, ahead);
        ahead_pix += pix_step;
        ahead += voxel_step;
      }
      cp_async_wait<kStages - kRound>();
      __syncwarp();
      int c[kRound][DPL], s_old[kRound][DPL], img[kRound] = {};
      // MASK: bit g is the mask byte of step g's predecessor.
      unsigned pred_on = on_prev;
#pragma unroll
      for (int g = 0; g < kRound; ++g) {
        if (t0 + g < t_hi) {
          unsigned on = 0;
          read(t0 + g, off + g * voxel_step, c[g], s_old[g], img[g], on);
          pred_on |= on << (g + 1);
        }
      }
      // ADAPTIVE: lane g < kRound divides for step g, so the warp issues
      // one divide a round, not one a step; step g takes its P2 by a
      // shuffle, off the chain. (Lanes past the round's last step divide
      // for nothing.)
      int p2_lane = p2;
      if (ADAPTIVE) {
        int cur = img[0], pred = img_prev;
#pragma unroll
        for (int g = 1; g < kRound; ++g) {
          if (lane == g) {
            cur = img[g];
            pred = img[g - 1];
          }
        }
        const int grad = abs(cur - pred) - grad_floor;
        if (grad > 0) p2_lane = max(p2_min, p2 / grad);  // floor: both >= 0
      }

#pragma unroll
      for (int g = 0; g < kRound; ++g) {
        if (t0 + g >= t_hi) break;  // uniform over the warp
        if (RUN == kMask ? !((pred_on >> g) & 1u)
                         : (RUN == kRect || RUN == kShear) &&
                               !(t0 + g > t_in && t0 + g <= t_out)) {
#pragma unroll
          for (int j = 0; j < DPL; ++j) L[j] = 0;  // a fresh start: L = C
        }
        int p2e = p2;
        if (ADAPTIVE) {
          p2e = __shfl_sync(kFull, p2_lane, g);
          img_prev = img[g];  // the last step run, also across a phase
        }
        int m = L[0];
#pragma unroll
        for (int j = 1; j < DPL; ++j) m = min(m, L[j]);
        m = __reduce_min_sync(kFull, m);
        const int below = __shfl_up_sync(kFull, L[DPL - 1], 1);  // d - 1
        const int above = __shfl_down_sync(kFull, L[0], 1);      // d + 1
        int out[DPL];
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
          out[j] = c[g][j] + cand - m;
        }
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          L[j] = out[j];
          out[j] += s_old[g][j];
        }
        store_sum<DPL, PARTIAL>(sum + off + g * voxel_step + lane * DPL, out,
                                live);
      }
      on_prev = (pred_on >> kRound) & 1u;
      off += kRound * voxel_step;
    }
  }
  cp_async_wait<0>();
}

template <int DPL, bool PARTIAL, typename CostT>
cudaError_t launch(const void* cost, const int* image, const uint8_t* mask,
                   int16_t* sum, int h, int w, int d, int step_y, int step_x,
                   int p1, int p2, int p2_min, int grad_floor, int accumulate,
                   int run, const Rect& r, cudaStream_t s) {
  const auto* c = static_cast<const CostT*>(cost);
  if (run == kGroup) {
    if constexpr (group_built<DPL, PARTIAL, CostT>()) {
      const int k = group_warps(d);
      const int smem = group_smem(DPL, (int)sizeof(CostT), k);
      const auto kernel =
          image != nullptr
              ? &sgm_path_kernel<DPL, PARTIAL, true, kGroup, CostT>
              : &sgm_path_kernel<DPL, PARTIAL, false, kGroup, CostT>;
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
      }
      kernel<<<(w + h - 1 + k - 1) / k, 32 * k, smem, s>>>(
          c, image, mask, sum, h, w, d, step_y, step_x, p1, p2, p2_min,
          grad_floor, accumulate, r);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;  // no instance: launch_plan gives none
  }
  int n_lines;
  if (step_y == 0) {  // the horizontals and kPair (step 0, 0): the rows
    n_lines = h;
  } else if (step_x == 0) {
    n_lines = w;
  } else {
    n_lines = w + h - 1;
  }
  const int warps = block_warps(run);
  const int smem = warps * ring_smem(DPL, (int)sizeof(CostT));
  using Kernel = decltype(&sgm_path_kernel<DPL, PARTIAL, true, kWhole, CostT>);
  const Kernel adaptive[5] = {
      sgm_path_kernel<DPL, PARTIAL, true, kWhole, CostT>,
      sgm_path_kernel<DPL, PARTIAL, true, kRect, CostT>,
      sgm_path_kernel<DPL, PARTIAL, true, kShear, CostT>,
      sgm_path_kernel<DPL, PARTIAL, true, kMask, CostT>,
      sgm_path_kernel<DPL, PARTIAL, true, kPair, CostT>};
  const Kernel fixed[5] = {
      sgm_path_kernel<DPL, PARTIAL, false, kWhole, CostT>,
      sgm_path_kernel<DPL, PARTIAL, false, kRect, CostT>,
      sgm_path_kernel<DPL, PARTIAL, false, kShear, CostT>,
      sgm_path_kernel<DPL, PARTIAL, false, kMask, CostT>,
      sgm_path_kernel<DPL, PARTIAL, false, kPair, CostT>};
  const Kernel kernel = image != nullptr ? adaptive[run] : fixed[run];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<n_lines, 32 * warps, smem, s>>>(c, image, mask, sum, h, w, d,
                                          step_y, step_x, p1, p2, p2_min,
                                          grad_floor, accumulate, r);
  return cudaGetLastError();
}

// The instance for d disparities of CostT costs: DPL = ceil(d / 32),
// PARTIAL unless d = 32 * DPL.
template <typename CostT>
int launch_costs(const void* cost, const int* image, const uint8_t* mask,
                 int16_t* sum, int h, int w, int d, int step_y, int step_x,
                 int p1, int p2, int p2_min, int grad_floor, int accumulate,
                 int run, const Rect& r, cudaStream_t s) {
#define STPU_PATH(DPL)                                                      \
  if (d == 32 * DPL) {                                                      \
    return (int)launch<DPL, false, CostT>(cost, image, mask, sum, h, w, d,  \
                                          step_y, step_x, p1, p2, p2_min,   \
                                          grad_floor, accumulate, run, r,   \
                                          s);                               \
  }                                                                         \
  return (int)launch<DPL, true, CostT>(cost, image, mask, sum, h, w, d,     \
                                       step_y, step_x, p1, p2, p2_min,      \
                                       grad_floor, accumulate, run, r, s)
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
  return (int)cudaErrorInvalidValue;  // not reached
}

}  // namespace

#ifdef STPU_K2_INT16

int stpu_k2::launch_int16(const void* cost, const int* image,
                          const uint8_t* mask, int16_t* sum, int h, int w,
                          int d, int step_y, int step_x, int p1, int p2,
                          int p2_min, int grad_floor, int accumulate, int run,
                          const Rect& r, cudaStream_t s) {
  return launch_costs<int16_t>(cost, image, mask, sum, h, w, d, step_y,
                               step_x, p1, p2, p2_min, grad_floor,
                               accumulate, run, r, s);
}

#else

// The ring of the K2 form for d disparities: pixels staged per warp, and
// (for cost_bytes-byte costs) its dynamic shared memory, per warp: a block
// of the horizontal pair holds two rings.
extern "C" int stpu_sgm_path_stages(int d) {
  return ring_stages((d + 31) / 32);
}

extern "C" int stpu_sgm_path_smem(int d, int cost_bytes) {
  return ring_smem((d + 31) / 32, cost_bytes);
}

// The blocks of a sweep group over an h x w x d frame: its edge buffer is
// that many times h x 3 x 16 * ceil(d / 32) tagged 64-bit words.
extern "C" int stpu_sgm_group_blocks(int h, int w, int d) {
  const int k = group_warps(d);
  return (w + h - 1 + k - 1) / k;
}

// A sweep group's warps per block (the strip's width) and its block's
// dynamic shared memory for d disparities of int8 costs.
extern "C" int stpu_sgm_group_warps(int d) { return group_warps(d); }

extern "C" int stpu_sgm_group_smem(int d) {
  return group_smem((d + 31) / 32, 1, group_warps(d));
}

// cost: [H, W, D] int8 (cost_bytes 1) or int16 (cost_bytes 2); image: [H, W]
// int32 reference view for adaptive P2, or NULL for fixed P2. cost and sum
// are 16-byte aligned. rect != 0 selects the rectangle form with the
// in-frame rectangle [y_lo, y_hi) x [x_lo, x_hi) of the block (0 <= y_lo <=
// y_hi <= h, 0 <= x_lo <= x_hi <= w). shear = +1 or -1 selects the sheared
// form (a vertical step, no rectangle): the block is the sheared columns
// [x0, x0 + w) of an h x frame_w frame, 0 <= x0, x0 + w <= frame_w + h - 1.
// mask != NULL selects the mask form: [h, w] bytes (0 or 1), contiguous,
// 4-byte aligned; it takes neither a rectangle nor a shear. step_y = step_x
// = 0 selects the horizontal pair: both horizontals, (0, 1) and (0, -1),
// in one launch of the whole form (no rectangle, shear or mask). step_y =
// +2 or -2 with step_x = 0 selects a sweep group of the whole form: the
// three down directions, (1, 0), (1, 1) and (1, -1), or the three up ones,
// for int8 costs at D = 128 or 256 (the instances built); sync: 3 ints,
// its counters and the tag of the last launch, zero when first used; edge:
// its edge buffer (stpu_sgm_group_blocks), 16-byte aligned, zero when
// first used with sync and used with no other. Launches that share them
// run in sequence on one stream.
extern "C" int stpu_sgm_path(const void* cost, int cost_bytes,
                             const void* image, void* sum, int h, int w,
                             int d, int step_y, int step_x, int p1, int p2,
                             int p2_min, int grad_floor, int accumulate,
                             int rect, int y_lo, int y_hi, int x_lo, int x_hi,
                             int shear, int x0, int frame_w, const void* mask,
                             void* sync, void* edge, void* stream) {
  const bool pair = step_y == 0 && step_x == 0;
  const bool group = step_y == 2 || step_y == -2;
  if (h <= 0 || w <= 0 || d <= 0 || d > 256 || step_y < -2 || step_y > 2 ||
      step_x < -1 || step_x > 1 ||
      ((pair || group) && (rect != 0 || shear != 0 || mask != nullptr)) ||
      (group && (step_x != 0 || sync == nullptr || edge == nullptr ||
                 (reinterpret_cast<uintptr_t>(edge) & 15) != 0 ||
                 (reinterpret_cast<uintptr_t>(sync) & 3) != 0)) ||
      (cost_bytes != 1 && cost_bytes != 2) || p1 < 0 || p2 < 0 ||
      p2_min < 0 || y_lo < 0 || y_lo > y_hi || y_hi > h || x_lo < 0 ||
      x_lo > x_hi || x_hi > w || shear < -1 || shear > 1 ||
      (shear != 0 && (rect != 0 || step_x != 0 || frame_w < 1 || x0 < 0 ||
                      (long long)x0 + w > (long long)frame_w + h - 1)) ||
      (mask != nullptr && (rect != 0 || shear != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const Rect r{y_lo, y_hi, x_lo, x_hi, shear, x0, frame_w,
               static_cast<int*>(sync), static_cast<uint64_t*>(edge)};
  const int run = mask != nullptr ? kMask
                  : shear != 0    ? kShear
                  : rect != 0     ? kRect
                  : pair          ? kPair
                  : group         ? kGroup
                                  : kWhole;
  if (group) step_y /= 2;  // the kernel's sweep: +1 down, -1 up
  if (((reinterpret_cast<uintptr_t>(cost) | reinterpret_cast<uintptr_t>(sum)) &
       15) != 0 ||
      ((reinterpret_cast<uintptr_t>(image) |
        reinterpret_cast<uintptr_t>(mask)) & 3) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  const auto* im = static_cast<const int*>(image);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* s = static_cast<int16_t*>(sum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cost_bytes == 1) {
    return launch_costs<int8_t>(cost, im, mk, s, h, w, d, step_y, step_x, p1,
                                p2, p2_min, grad_floor, accumulate, run, r,
                                st);
  }
  return stpu_k2::launch_int16(cost, im, mk, s, h, w, d, step_y, step_x, p1,
                               p2, p2_min, grad_floor, accumulate, run, r,
                               st);
}

#endif  // STPU_K2_INT16

// Speckle filter: invalidate small connected components of similar
// disparity (SURVEY.md §2.1 C10/C11 — the reference family runs this as a
// post-kernel on the disparity map; it is an irregular union-find
// computation that maps poorly onto XLA, so it is the one pipeline stage
// implemented as native host code, mirroring how the reference keeps its
// post-filters on the device-adjacent fast path).
//
// Semantics match OpenCV's filterSpeckles: 4-connected components where
// neighboring disparities differ by at most `tau`; components with fewer
// than `max_size` pixels are marked invalid.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this toolchain).

#include <cstdint>
#include <cstdlib>
#include <vector>

extern "C" {

// disp:  [h*w] float32 disparity (row-major), modified in place where
//        newval replacement is requested (set_invalid != 0 -> disp=newval).
// valid: [h*w] uint8, 1 = valid; speckles are zeroed here.
// Returns the number of invalidated pixels.
int64_t stpu_filter_speckles(
    float* disp, uint8_t* valid, int64_t h, int64_t w,
    double tau, int64_t max_size, float newval, int32_t set_invalid) {
  const int64_t n = h * w;
  std::vector<int32_t> label(n, -1);
  std::vector<int32_t> stack;
  std::vector<int32_t> component;
  stack.reserve(1024);
  component.reserve(1024);
  int64_t removed = 0;

  for (int64_t seed = 0; seed < n; ++seed) {
    if (label[seed] >= 0 || !valid[seed]) continue;
    // Flood-fill the component containing `seed`.
    stack.clear();
    component.clear();
    stack.push_back((int32_t)seed);
    label[seed] = 1;
    while (!stack.empty()) {
      const int32_t p = stack.back();
      stack.pop_back();
      component.push_back(p);
      const int64_t y = p / w, x = p % w;
      const float dp = disp[p];
      const int64_t nbs[4] = {
          x > 0 ? p - 1 : -1,
          x + 1 < w ? p + 1 : -1,
          y > 0 ? p - w : -1,
          y + 1 < h ? p + w : -1,
      };
      for (int k = 0; k < 4; ++k) {
        const int64_t q = nbs[k];
        if (q < 0 || label[q] >= 0 || !valid[q]) continue;
        const float dq = disp[q];
        const float diff = dp > dq ? dp - dq : dq - dp;
        if (diff <= (float)tau) {
          label[q] = 1;
          stack.push_back((int32_t)q);
        }
      }
    }
    if ((int64_t)component.size() < max_size) {
      for (const int32_t p : component) {
        valid[p] = 0;
        if (set_invalid) disp[p] = newval;
        ++removed;
      }
    }
  }
  return removed;
}

// Occlusion fill (Hirschmueller): each invalid pixel takes the SMALLER of
// the nearest valid disparity to its left and right on the same row
// (occlusions belong to the background). Pixels in rows with no valid
// disparity at all are left unchanged. Operates in place on `disp`.
void stpu_fill_invalid_lr(
    float* disp, const uint8_t* valid, int64_t h, int64_t w) {
  std::vector<float> left(w), right(w);
  for (int64_t y = 0; y < h; ++y) {
    float* row = disp + y * w;
    const uint8_t* vr = valid + y * w;
    float last = -1.0f;
    for (int64_t x = 0; x < w; ++x) {
      if (vr[x]) last = row[x];
      left[x] = last;
    }
    last = -1.0f;
    for (int64_t x = w - 1; x >= 0; --x) {
      if (vr[x]) last = row[x];
      right[x] = last;
    }
    for (int64_t x = 0; x < w; ++x) {
      if (vr[x]) continue;
      const float l = left[x], r = right[x];
      if (l >= 0.0f && r >= 0.0f) row[x] = l < r ? l : r;
      else if (l >= 0.0f) row[x] = l;
      else if (r >= 0.0f) row[x] = r;
    }
  }
}

}  // extern "C"

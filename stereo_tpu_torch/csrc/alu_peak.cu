// K6 alu_peak: a measured anchor for the card's elementwise ALU rate.
//
// Replaces the local kernel of
// stereo_tpu/eval/roofline.py:_measure_vpu_peak_one (roofline.py:141, reached
// through pl.pallas_call at :154). Per element x it computes
//
//   a_c = x + c * q               for c in [0, CHAINS)  (q = 1/4, or 1 for int)
//   a_c = min(a_c + step, BIG)    K / CHAINS times, step = 1
//   out = sum_c a_c
//
// in float32 (BIG = 3e38, as the reference) and in int32 (BIG = 2^30), the
// type the cost, path and selection kernels issue. That is 2 * K operations
// per element for one 4-byte load and one 4-byte store, so the rate is the
// ALUs', not memory's: the reference explains (roofline.py:127-135) why a
// chain of separate elementwise passes measures device memory instead.
//
// Bound on the H100: operations. The data sheet's 67 T/s float32 counts a
// fused multiply-add as two; an add or a min is one instruction per lane
// and clock. Design: one thread per element, the CHAINS accumulators and
// the whole chain in registers, fully unrolled (K and CHAINS are template
// parameters over the reference's program set); CHAINS independent chains
// cover the ALU latency as the kernels' own instruction-level parallelism
// does. The compiler must not fold the chain: the seeds come from the loaded
// value and the step is a kernel argument, so neither the sum nor the
// saturating min has a constant operand it could combine.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Peak;
template <>
struct Peak<float> {
  static __device__ __forceinline__ float big() { return 3e38f; }
  static __device__ __forceinline__ float seed(int c) { return 0.25f * c; }
  static __device__ __forceinline__ float lower(float a, float b) {
    return fminf(a, b);
  }
};
template <>
struct Peak<int> {
  static __device__ __forceinline__ int big() { return 1 << 30; }
  static __device__ __forceinline__ int seed(int c) { return c; }
  static __device__ __forceinline__ int lower(int a, int b) {
    return min(a, b);
  }
};

template <typename T, int K, int CHAINS>
__global__ void alu_peak_kernel(const T* __restrict__ x, T* __restrict__ out,
                                long long n, T step) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T v = x[i];
  T acc[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = v + Peak<T>::seed(c);
#pragma unroll
  for (int s = 0; s < K / CHAINS; ++s) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      acc[c] = Peak<T>::lower(acc[c] + step, Peak<T>::big());
    }
  }
  T total = acc[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) total += acc[c];
  out[i] = total;
}

template <typename T, int K, int CHAINS>
void launch(const void* x, void* out, long long n, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  alu_peak_kernel<T, K, CHAINS><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, (T)1);
}

template <typename T>
bool dispatch(const void* x, void* out, long long n, int k, int chains,
              cudaStream_t s) {
#define STPU_PEAK(K, CHAINS)               \
  if (k == K && chains == CHAINS) {        \
    launch<T, K, CHAINS>(x, out, n, s);    \
    return true;                           \
  }
  STPU_PEAK(256, 4)
  STPU_PEAK(512, 4)
  STPU_PEAK(256, 8)
  STPU_PEAK(512, 8)
  STPU_PEAK(256, 16)
  STPU_PEAK(256, 2)
#undef STPU_PEAK
  return false;
}

}  // namespace

// x, out: [n] float32 (is_int 0) or int32 (is_int 1); (k, chains) one of the
// reference's programs: (256, 4), (512, 4), (256, 8), (512, 8), (256, 16),
// (256, 2).
extern "C" int stpu_alu_peak(const void* x, void* out, long long n, int k,
                             int chains, int is_int, void* stream) {
  if (n <= 0 || n > (1LL << 31) * kThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = is_int ? dispatch<int>(x, out, n, k, chains, s)
                            : dispatch<float>(x, out, n, k, chains, s);
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

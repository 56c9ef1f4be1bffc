// K2's instances for int16 costs (SAD): sgm_paths.cu built a second time,
// so that its two halves compile in parallel, one nvcc each. The kernel,
// its design and its C entry points are in sgm_paths.cu.
#define STPU_K2_INT16
#include "sgm_paths.cu"

// An empty kernel: the launch-latency floor of the card, measured beside the
// real kernels. Every kernel of the port moves a few MB at most, microseconds
// at HBM rate, so what a launch costs with no work at all is the yardstick
// their times are read against (chip_smoke.py reports it as the floor).

#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

// Launches one empty block on the given stream. Returns a cudaError_t.
extern "C" int vo_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Spans on the card's own clock: a one-thread kernel that the captured step
// (models/graphed.py) launches at every boundary of its schedule
// (pipeline.run_step), so that each mark is a kernel node of the frame's graph
// or of the recovery's or keyframe's conditional body.
//
// A mark reads %globaltimer (nanoseconds, the card's clock) and writes it
// into a device ring of rows, one row a step: the row of the step counter
// `seq`. The frame-start mark (boundary 0) advances the counter and zeroes
// its row first, so a branch that did not run leaves its columns at 0. A mark
// may also copy `n` counters from `src` into its row from column `dst`, the
// step's counts of the work done, summed over lanes on the device.
//
// The boundary is the template argument, so a profiler trace names each mark
// (vo_span_mark<0> ... vo_span_mark<10>). Row layout, set by the caller:
// column 0 the step's sequence number, column 1 + B the stamp of boundary B,
// the counters after that. Nothing here is one of the port's counted kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kBoundaries = 11;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

template <int B>
__global__ void vo_span_mark(long long* ring, long long* seq, int rows, int cols,
                             const long long* src, int n, int dst) {
  const long long t = global_ns();
  long long s = *seq;
  if (B == 0) {
    s += 1;
    *seq = s;
  }
  long long* row = ring + (s % rows) * static_cast<long long>(cols);
  if (B == 0) {
    for (int c = 1; c < cols; ++c) row[c] = 0;
    row[0] = s;
  }
  row[1 + B] = t;
  for (int i = 0; i < n; ++i) row[dst + i] = src[i];
}

// Two readings of the clock: the first, and the first that differs from it
// (its tick). The spin gives up after 2^20 readings.
__global__ void vo_span_clock_kernel(long long* out) {
  const long long t0 = global_ns();
  long long t1 = t0;
  for (int i = 0; i < (1 << 20) && t1 == t0; ++i) t1 = global_ns();
  out[0] = t0;
  out[1] = t1;
}

using Launch = void (*)(long long*, long long*, int, int, const long long*, int, int,
                        cudaStream_t);

template <int B>
void launch(long long* ring, long long* seq, int rows, int cols, const long long* src, int n,
            int dst, cudaStream_t stream) {
  vo_span_mark<B><<<1, 1, 0, stream>>>(ring, seq, rows, cols, src, n, dst);
}

constexpr Launch kLaunch[kBoundaries] = {launch<0>, launch<1>, launch<2>, launch<3>,
                                         launch<4>, launch<5>, launch<6>, launch<7>,
                                         launch<8>, launch<9>, launch<10>};

}  // namespace

// The mark of `boundary` (0 = frame start) on `stream`: ring (rows, cols)
// int64, seq one int64, src `n` int64 counters (may be null with n = 0)
// copied to columns dst... Returns a cudaError_t, or -1 for a boundary out of
// range.
extern "C" int vo_span_mark_launch(int boundary, void* ring, void* seq, int rows, int cols,
                                   const void* src, int n, int dst, void* stream) {
  if (boundary < 0 || boundary >= kBoundaries) return -1;
  kLaunch[boundary](static_cast<long long*>(ring), static_cast<long long*>(seq), rows, cols,
                    static_cast<const long long*>(src), n, dst,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Two readings of %globaltimer into out[0], out[1] (int64) on `stream`: the
// calibration's device side. Returns a cudaError_t.
extern "C" int vo_span_clock(void* out, void* stream) {
  vo_span_clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

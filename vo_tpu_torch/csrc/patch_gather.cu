// K2 — patch gather at integer corners, batched.
//
// Replaces vo_tpu/ops/pallas_kernels.py::extract_patches_aligned (and its
// (B, blocks) twin extract_patches_aligned_batched): out[b, k] is the
// size x size window of imgs[b] whose top-left corner is corners[b, k] =
// (x, y), with the start normalized and clamped exactly as lax.dynamic_slice
// does it (a negative start counts from the end; then clamped into
// [0, W - size] x [0, H - size]), so the result is bit-identical to the oracle
// (a vmapped dynamic_slice; vo_tpu_torch/ops/kernels.py extract_patches_plain)
// for every corner, in range or not.
//
// Design: one 128-thread block per (image, keypoint); the threads stride over
// the size^2 outputs row-major, so a warp reads runs of adjacent pixels of a
// patch row and writes contiguous output. The TPU kernel's machinery — (8,128)-
// aligned DMA regions, cyclic-roll realignment, split SMEM corner arrays, the
// 48/256 over-pad of the levels — has no counterpart here: a GPU thread
// addresses any float directly.
//
// What bounds it on an H100: at the LK shapes (K = 1024, size 21 or 35) it
// moves 1.8-5 MB, microseconds at HBM rate, so launch latency and the tail of
// 1024 short blocks dominate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
patch_gather_kernel(const float* __restrict__ imgs, const int* __restrict__ corners,
                    float* __restrict__ out, int H, int W, int K, int size) {
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int* c = corners + ((size_t)b * K + k) * 2;
  // lax.dynamic_slice: a negative start counts from the end, then the start
  // is clamped so the window fits.
  const int cx = c[0] < 0 ? c[0] + W : c[0];
  const int cy = c[1] < 0 ? c[1] + H : c[1];
  const int x0 = min(max(cx, 0), W - size);
  const int y0 = min(max(cy, 0), H - size);
  const float* src = imgs + (size_t)b * H * W + (size_t)y0 * W + x0;
  float* dst = out + ((size_t)b * K + k) * size * size;
  for (int e = threadIdx.x; e < size * size; e += kThreads) {
    dst[e] = src[(size_t)(e / size) * W + e % size];
  }
}

}  // namespace

// imgs (B, H, W) f32, corners (B, K, 2) int32 (x, y), out (B, K, size, size)
// f32, all contiguous on the current device; size <= H and size <= W.
// Returns a cudaError_t (0 = launched).
extern "C" int vo_extract_patches(const void* imgs, const void* corners, void* out,
                                  int B, int H, int W, int K, int size,
                                  void* stream) {
  if (K == 0 || B == 0) return 0;
  const dim3 grid(K, B);
  patch_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)imgs, (const int*)corners, (float*)out, H, W, K, size);
  return (int)cudaGetLastError();
}

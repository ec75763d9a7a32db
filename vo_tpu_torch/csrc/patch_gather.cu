// K2 / K2b — patch gather at integer corners, batched, one or two gathers a
// launch.
//
// Replaces vo_tpu/ops/pallas_kernels.py::extract_patches_aligned (and its
// (B, blocks) twin extract_patches_aligned_batched). One __global__ kernel
// serves both entries of vo_tpu_torch/ops/kernels.py:
//
//  * extract_patches (pad = 0, one job): out[b, k] is the size x size window
//    of imgs[b] whose top-left corner is corners[b, k] = (x, y), the start
//    normalized and clamped exactly as lax.dynamic_slice does it (a negative
//    start counts from the end; then clamped into [0, W - size] x
//    [0, H - size]): the function the TPU kernel computes.
//  * extract_patch_pairs (pad > 0, two jobs): both gathers of one Lucas-Kanade
//    level, the template windows of the previous image and the search windows
//    of the next, in ONE launch and with no padded copy of either level. The
//    corners are in the coordinates of the level edge-replicated by `pad` on
//    every side; that image is never built: pixel (y, x) of it is pixel
//    (clamp(y - pad, 0, H-1), clamp(x - pad, 0, W-1)) of the level, and every
//    thread clamps its own address. The start follows dynamic_slice on the
//    padded extent (H + 2 pad, W + 2 pad), so the result is bit-identical to
//    a gather on the padded copy for EVERY corner. (The LK caller's corners
//    always lie inside the padded extent, so no start is ever clamped there.)
//
// The reference pads because lax.dynamic_slice clamps a start that is out of
// range, and over-pads and realigns because a TPU DMA wants (8, 128)-aligned
// regions; a GPU thread addresses any float directly, so none of that is here.
//
// Design: one 128-thread block per (keypoint, lane, job); K = 1024 keypoints
// with two jobs are 2,048 blocks, one wave at 16 blocks an SM. The threads
// stride over the size^2 outputs row-major: a thread splits its first index
// into (row, col) with one division and then steps both by constants, so the
// loop has no division. A warp reads runs of adjacent pixels of a patch row
// (rows start at arbitrary offsets and sizes are odd, so neither side has a
// 16-byte alignment to use) and writes contiguous output. The corner is one
// broadcast load a warp.
//
// What bounds it on an H100: it moves 7 MB a level at K = 1024 (0.003 ms at
// HBM rate, and the level itself stays in L2), so the launch and the tail of
// short blocks dominate the device time, and the host's enqueue dominates
// both: one launch a level instead of two, and no padded copies, is what the
// design buys. Measured by chip_smoke.py and tools/time_kernels_torch.py on an
// NVIDIA H100 80GB HBM3 at 700 W, one level of 480x640 with K = 1024: 0.006 ms
// on the device (a replayed CUDA graph) and 0.035-0.059 ms from the host,
// where two padded copies and two launches took 0.014 ms and 0.14-0.16 ms;
// six lanes with K = 512: 0.015-0.016 ms against 0.040 ms on the device.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct GatherJob {
  const float* imgs;   // (B, H, W)
  const int* corners;  // (B, K, 2) (x, y), in padded coordinates
  float* out;          // (B, K, size, size)
  int size;
};

__global__ void __launch_bounds__(kThreads)
patch_gather_kernel(GatherJob job0, GatherJob job1, int H, int W, int K, int pad) {
  const GatherJob job = blockIdx.z == 0 ? job0 : job1;
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int size = job.size;
  const int hp = H + 2 * pad, wp = W + 2 * pad;
  const int* c = job.corners + ((size_t)b * K + k) * 2;
  // lax.dynamic_slice on the padded extent: a negative start counts from the
  // end, then the start is clamped so the window fits. Then into the level's
  // own coordinates, where a window may hang over the edge by up to `pad`.
  const int cx = c[0] < 0 ? c[0] + wp : c[0];
  const int cy = c[1] < 0 ? c[1] + hp : c[1];
  const int x0 = min(max(cx, 0), wp - size) - pad;
  const int y0 = min(max(cy, 0), hp - size) - pad;
  const float* img = job.imgs + (size_t)b * H * W;
  float* dst = job.out + ((size_t)b * K + k) * size * size;
  const int n = size * size;
  // e = row * size + col, split once; e += kThreads steps (row, col) by
  // (d_row, d_col) with at most one carry.
  int row = threadIdx.x / size;
  int col = threadIdx.x - row * size;
  const int d_row = kThreads / size;
  const int d_col = kThreads - d_row * size;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int y = min(max(y0 + row, 0), H - 1);
    const int x = min(max(x0 + col, 0), W - 1);
    dst[e] = img[(size_t)y * W + x];
    row += d_row;
    col += d_col;
    if (col >= size) {
      col -= size;
      row += 1;
    }
  }
}

}  // namespace

// imgs (B, H, W) f32, corners (B, K, 2) int32 (x, y), out (B, K, size, size)
// f32, all contiguous on the current device; 0 < size <= H and size <= W.
// Returns a cudaError_t (0 = launched).
extern "C" int vo_extract_patches(const void* imgs, const void* corners, void* out,
                                  int B, int H, int W, int K, int size,
                                  void* stream) {
  if (K == 0 || B == 0) return 0;
  const GatherJob job = {(const float*)imgs, (const int*)corners, (float*)out, size};
  const dim3 grid(K, B, 1);
  patch_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(job, job, H, W, K, 0);
  return (int)cudaGetLastError();
}

// Both gathers of one LK level in one launch. prev, next (B, H, W) f32;
// tcorners, scorners (B, K, 2) int32 in the coordinates of the level
// edge-replicated by `pad`; tout (B, K, tsize, tsize), sout (B, K, ssize,
// ssize) f32; all contiguous on the current device; each size fits the padded
// extent. Returns a cudaError_t (0 = launched).
extern "C" int vo_extract_patch_pairs(const void* prev, const void* next,
                                      const void* tcorners, const void* scorners,
                                      void* tout, void* sout, int B, int H, int W,
                                      int K, int tsize, int ssize, int pad,
                                      void* stream) {
  if (K == 0 || B == 0) return 0;
  const GatherJob tjob = {(const float*)prev, (const int*)tcorners, (float*)tout, tsize};
  const GatherJob sjob = {(const float*)next, (const int*)scorners, (float*)sout, ssize};
  const dim3 grid(K, B, 2);
  patch_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(tjob, sjob, H, W, K, pad);
  return (int)cudaGetLastError();
}

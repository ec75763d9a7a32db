// LK solve / LK solve batched — one pyramid level of Bouguet's Lucas-Kanade
// for every point, from the patch pair that K2 (patch_gather.cu) has just
// written: the template resample and its gradients, the 2x2 system G, the
// Gauss-Newton iterations up to `max_iters` and the window's mean error, one
// launch a level over all points of all lanes.
//
// Replaces no TPU kernel: vo_tpu/ops/klt.py runs this part of a level as XLA
// ops around the Pallas gathers. The port ran it as plain PyTorch
// (ops/klt.py::lk_solve_plain, which stays the CPU path and this kernel's
// oracle): about 530 small launches a level, two dense tent-matrix products
// per resample, and every point through every iteration.
//
// What it computes is lk_solve_plain's arithmetic, in float32, from what
// `_lk_level` computes beside the pair's corners (each template centre's
// sub-pixel offset, each search window's origin inside its patch):
//  * every resample is W_y(p) @ patch @ W_x(p)^T with W[i, j] = max(0,
//    1 - |j - (p + i)|): a row of W has two non-zero taps, so each sample
//    reads two pixels of two rows, rows first, then columns, as the two
//    products do. A tap is added to the other's product with one fused
//    multiply-add, as a GEMM accumulates; the zero taps add exactly 0;
//  * the stop test is the reference's while_loop: a point stops when its
//    update is below eps (or it is not conditioned) and adds nothing after,
//    which is what the plain version's fixed trip count with a masked update
//    gives. The number of iterations a point made is what the plain
//    version's `active` masks count for it.
// The sums over a window are taken in another order than PyTorch's reductions
// (a lane's share, then a butterfly over the warp), so results agree to a few
// ulps, not bit for bit. The library is built with -fmad=false: no other
// multiply-add is contracted.
//
// Design for Hopper: one warp a point and four points a 128-thread block. A
// warp copies its template (21x21 at radius 8) and search patch (35x35) into
// shared memory once, resamples the (win+2)^2 template, keeps Ix and Iy of
// the window beside it and reduces G with shuffles. Each iteration samples
// the window (17x17), ten samples a lane, and reduces bx and by with
// shuffles; every lane of the warp holds the same sums, so the stop test is
// the warp's and nothing diverges. A warp whose point is not conditioned
// skips the loop; one that converged leaves it. The radius, the sizes and
// the iteration count are launch arguments; the shared memory follows the
// radius (10.4 KB a point at radius 8).
//
// What bounds it on an H100: it reads the patches once (6.8 MB a level at
// K = 1024, about 2 us at HBM rate, mostly from L2 where K2 left them) and
// writes 17 bytes a point; the arithmetic is some 3.5 kFLOP a point and live
// iteration. At these sizes a launch is latency: a warp's iterations run one
// after another.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 4;                   // points a block
constexpr int kPlainSmemBytes = 48 * 1024;     // usable without the attribute
constexpr int kMaxSmemBytes = 227 * 1024;      // Hopper's opt-in limit a block

struct LkLevel {
  const float* tpatch;  // (B, K, ts, ts): template windows of the previous level
  const float* spatch;  // (B, K, ss, ss): search windows of the next level
  const float* tfrac;   // (B, K, 2): the template centres' sub-pixel offsets
  const float* sbase;   // (B, K, 2): the search windows' origins in their patches
  const float* guess;   // (B, K, 2): flow guess at this level
  float* flow;          // (B, K, 2): guess + d
  unsigned char* cond;  // (B, K): bool, G well conditioned
  float* err;           // (B, K): mean |I_next - I_prev| over the window
  int* live;            // (B, K): iterations that moved the point, or null
  int K, radius, ts, ss, max_iters;
  float eps2, min_eig_threshold, pos_hi;
};

// Floats of shared memory a warp holds: both patches, the template's
// (win + 2)^2 resample, and Ix and Iy of the window.
__host__ __device__ inline int warp_floats(int radius, int ts, int ss) {
  const int win = 2 * radius + 1, ext = win + 2;
  return ts * ts + ss * ss + ext * ext + 2 * win * win;
}

// torch.clamp: a NaN stays NaN.
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Every lane gets the same sum: at each step the two partners add the same
// two values.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sample that W_y(py - i) @ patch @ W_x(px - j)^T gives at row i, column
// j, with py = p_y + i and px = p_x + j: the two taps 1 - |j0 - p| at
// j0 = floor(p) and j0 + 1 of each tent. The index clamp only keeps a
// non-finite position inside the patch (its weights are NaN then, as in the
// dense product).
__device__ __forceinline__ float tent_sample(const float* patch, int P, float py, float px) {
  const float fy = floorf(py), fx = floorf(px);
  const float wy0 = 1.0f - fabsf(fy - py), wy1 = 1.0f - fabsf((fy + 1.0f) - py);
  const float wx0 = 1.0f - fabsf(fx - px), wx1 = 1.0f - fabsf((fx + 1.0f) - px);
  const int r = min(max((int)fy, 0), P - 2);
  const int c = min(max((int)fx, 0), P - 2);
  const float* p0 = patch + r * P + c;
  const float* p1 = p0 + P;
  const float a0 = __fmaf_rn(wy1, p1[0], wy0 * p0[0]);
  const float a1 = __fmaf_rn(wy1, p1[1], wy0 * p0[1]);
  return __fmaf_rn(wx1, a1, wx0 * a0);
}

// The elements lane, lane + 32, ... of an n x n window, row-major, as (row,
// col) without a division in the loop: `count` of them.
struct Walk {
  int row, col, d_row, d_col, n, count;
  __device__ Walk(int lane, int n_) : n(n_) {
    row = lane / n;
    col = lane - row * n;
    d_row = 32 / n;
    d_col = 32 - d_row * n;
    count = (n * n - lane + 31) >> 5;
  }
  __device__ void next() {
    row += d_row;
    col += d_col;
    if (col >= n) {
      col -= n;
      row += 1;
    }
  }
};

__global__ void __launch_bounds__(32 * kMaxWarps) lk_solve_kernel(LkLevel a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * (blockDim.x >> 5) + warp;
  if (k >= a.K) return;  // no block-wide barrier below
  const size_t n = (size_t)blockIdx.y * a.K + k;
  const int win = 2 * a.radius + 1, ext = win + 2, nwin = win * win;
  const int tsq = a.ts * a.ts, ssq = a.ss * a.ss;
  float* tp = smem + (size_t)warp * warp_floats(a.radius, a.ts, a.ss);
  float* sp = tp + tsq;
  float* text = sp + ssq;
  float* gx = text + ext * ext;
  float* gy = gx + nwin;

  // Unrolled so that a lane has several loads in flight: one at a time, the
  // copy would wait out the memory's latency some 50 times (radius 8).
  const float* tsrc = a.tpatch + n * tsq;
#pragma unroll 8
  for (int e = lane; e < tsq; e += 32) tp[e] = tsrc[e];
  const float* ssrc = a.spatch + n * ssq;
#pragma unroll 8
  for (int e = lane; e < ssq; e += 32) sp[e] = ssrc[e];

  // The template resample starts one pixel in, for the gradients' border.
  const float tx = a.tfrac[2 * n] + 1.0f, ty = a.tfrac[2 * n + 1] + 1.0f;
  const float sx = a.sbase[2 * n], sy = a.sbase[2 * n + 1];
  const float gux = a.guess[2 * n], guy = a.guess[2 * n + 1];
  __syncwarp();

  // The template's (win + 2)^2 resample.
  {
    Walk w(lane, ext);
#pragma unroll 4
    for (int m = 0; m < w.count; ++m, w.next())
      text[w.row * ext + w.col] = tent_sample(tp, a.ts, ty + (float)w.row, tx + (float)w.col);
  }
  __syncwarp();

  // Ix and Iy by central differences, and G.
  float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
  const Walk window(lane, win);
  for (Walk w = window; w.row < win; w.next()) {
    const float* mid = text + (w.row + 1) * ext + w.col;
    const float ix = 0.5f * (mid[2] - mid[0]);
    const float iy = 0.5f * (mid[ext + 1] - mid[1 - ext]);
    const int e = w.row * win + w.col;
    gx[e] = ix;
    gy[e] = iy;
    sxx += ix * ix;
    sxy += ix * iy;
    syy += iy * iy;
  }
  const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const float dg = gxx - gyy;
  const float disc = 0.25f * (dg * dg) + gxy * gxy;
  const float min_eig = 0.5f * (gxx + gyy) - sqrtf(disc != disc ? disc : fmaxf(disc, 0.0f));
  const bool invertible = fabsf(det) > 1e-8f;
  const bool conditioned = (min_eig / (float)nwin > a.min_eig_threshold) && invertible;
  const float inv_det = invertible ? 1.0f / det : 0.0f;

  // Gauss-Newton: each lane walks its own elements of the window, so T, Ix
  // and Iy are read where this lane wrote them.
  float dx = 0.0f, dy = 0.0f;
  int it = 0;
  bool active = conditioned;
  while (active && it < a.max_iters) {
    const float px = clamp_keep_nan(sx + dx, 0.0f, a.pos_hi);
    const float py = clamp_keep_nan(sy + dy, 0.0f, a.pos_hi);
    float sbx = 0.0f, sby = 0.0f;
    Walk w = window;
#pragma unroll 4
    for (int m = 0; m < w.count; ++m, w.next()) {
      const int e = w.row * win + w.col;
      const float diff = text[(w.row + 1) * ext + w.col + 1] -
                         tent_sample(sp, a.ss, py + (float)w.row, px + (float)w.col);
      sbx += diff * gx[e];
      sby += diff * gy[e];
    }
    const float b_x = warp_sum(sbx), b_y = warp_sum(sby);
    const float ddx = inv_det * (gyy * b_x - gxy * b_y);
    const float ddy = inv_det * (-gxy * b_x + gxx * b_y);
    dx = dx + ddx;
    dy = dy + ddy;
    active = ddx * ddx + ddy * ddy > a.eps2;
    ++it;
  }

  // The window's mean error where the point ended.
  const float px = clamp_keep_nan(sx + dx, 0.0f, a.pos_hi);
  const float py = clamp_keep_nan(sy + dy, 0.0f, a.pos_hi);
  float se = 0.0f;
  Walk w = window;
#pragma unroll 4
  for (int m = 0; m < w.count; ++m, w.next())
    se += fabsf(tent_sample(sp, a.ss, py + (float)w.row, px + (float)w.col) -
                text[(w.row + 1) * ext + w.col + 1]);
  const float err = warp_sum(se) * (1.0f / (float)nwin);
  if (lane == 0) {
    a.flow[2 * n] = gux + dx;
    a.flow[2 * n + 1] = guy + dy;
    a.cond[n] = conditioned ? 1 : 0;
    a.err[n] = err;
    if (a.live != nullptr) a.live[n] = it;
  }
}

// More than 48 KB of dynamic shared memory (a radius above 21) needs the
// attribute; once per device is enough, at the most a block may have.
cudaError_t configure(size_t smem) {
  static bool done[64] = {};
  if (smem <= (size_t)kPlainSmemBytes) return cudaSuccess;
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < 64;
  if (cached && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute((const void*)lk_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err == cudaSuccess && cached) done[dev] = true;
  return err;
}

}  // namespace

// One LK level's solve. tpatch (B, K, ts, ts), spatch (B, K, ss, ss), tfrac,
// sbase and guess (B, K, 2) f32; out: flow (B, K, 2) f32, cond (B, K) bool,
// err (B, K) f32, live (B, K) int32 or null; all contiguous on the current
// device. ts = 2 radius + 5, ss >= 2 radius + 3; eps2 = eps^2, pos_hi the
// search window's last origin inside its patch. Returns a cudaError_t (0 =
// launched; cudaErrorInvalidValue where a point's shared memory exceeds a
// block's).
extern "C" int vo_lk_solve(const void* tpatch, const void* spatch, const void* tfrac,
                           const void* sbase, const void* guess, void* flow, void* cond,
                           void* err, void* live, int B, int K, int radius, int ts, int ss,
                           int max_iters, float eps2, float min_eig_threshold, float pos_hi,
                           void* stream) {
  if (K == 0 || B == 0) return 0;
  const size_t per_warp = sizeof(float) * (size_t)warp_floats(radius, ts, ss);
  int warps = (int)(kPlainSmemBytes / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps;
  cudaError_t e = configure(smem);
  if (e != cudaSuccess) return (int)e;
  const LkLevel a = {(const float*)tpatch, (const float*)spatch, (const float*)tfrac,
                     (const float*)sbase, (const float*)guess, (float*)flow,
                     (unsigned char*)cond, (float*)err, (int*)live,
                     K, radius, ts, ss, max_iters, eps2, min_eig_threshold, pos_hi};
  const dim3 grid((K + warps - 1) / warps, B, 1);
  lk_solve_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

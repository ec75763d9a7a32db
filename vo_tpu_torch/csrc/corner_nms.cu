// K1 — fused corner response + non-maximum suppression, batched.
//
// Replaces vo_tpu/ops/pallas_kernels.py::corner_response_nms (and its (B, strips)
// twin corner_response_nms_batched). Computes, for each image of a (B, H, W) f32
// stack, the (H, W) map that holds the Shi-Tomasi (min eigenvalue) or Harris
// (det - kappa tr^2) response, clamped at 0, at strict local maxima of a
// (2r+1)^2 window and -inf everywhere else; ties between equal maxima go to
// the largest flat index. The oracle is the plain PyTorch chain in
// vo_tpu_torch/ops/harris.py (== vo_tpu/ops/harris.py).
//
// Design: one 256-thread block per 32x32 output tile of one image. The block
// loads the tile plus its halo (2r + patch/2 + 1 pixels, zero outside the
// image) into shared memory once and runs the whole stencil chain there:
// Sobel gx/gy (zeroed outside the image, as the oracle zero-pads between
// stages) -> vertical then horizontal box sums of gx^2, gy^2, gx*gy ->
// response (-inf outside the image) -> separable max pool -> flat-index
// tie-break pool -> one write. Five shared buffers are reused across the
// phases (~94 KB for r=8, patch 7, so the launcher opts in to >48 KB of
// dynamic shared memory). Every sum is taken in the oracle's tap order and
// the file is built with -fmad=false, so no contracted FMA can flip a
// near-tie between NMS neighbours.
//
// What bounds it on an H100: not HBM (one read and one write of the image,
// 2.5 MB at 640x480) but the shared-memory passes over a halo region ~5x
// the tile and the 11 block-wide barriers between phases; at 640x480 the
// grid is 300 blocks, about one wave at two blocks per SM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

struct Geometry {
  int r;       // NMS radius
  int p;       // box (structure tensor) window
  int rb;      // box taps span offsets [-rb, p - 1 - rb]
  int n_tied;  // kTile + 2r
  int n_resp;  // kTile + 4r
  int n_g;     // n_resp + p - 1
  int n_img;   // n_g + 2
  __host__ __device__ Geometry(int r_, int p_)
      : r(r_), p(p_), rb(p_ / 2), n_tied(kTile + 2 * r_),
        n_resp(kTile + 4 * r_), n_g(kTile + 4 * r_ + p_ - 1),
        n_img(kTile + 4 * r_ + p_ + 1) {}
  // Buffer sizes in floats: B0 n_img^2, B1 = B2 = n_g^2, B3 = B4 = n_resp*n_g.
  __host__ __device__ size_t floats() const {
    return (size_t)n_img * n_img + 2 * (size_t)n_g * n_g +
           2 * (size_t)n_resp * n_g;
  }
};

__global__ void __launch_bounds__(kThreads)
corner_nms_kernel(const float* __restrict__ imgs, float* __restrict__ out,
                  int H, int W, int mode, int patch, float kappa, int r) {
  extern __shared__ float smem[];
  const Geometry g(r, patch);
  float* B0 = smem;
  float* B1 = B0 + (size_t)g.n_img * g.n_img;
  float* B2 = B1 + (size_t)g.n_g * g.n_g;
  float* B3 = B2 + (size_t)g.n_g * g.n_g;
  float* B4 = B3 + (size_t)g.n_resp * g.n_g;

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kTile;
  const int tx0 = blockIdx.x * kTile;
  const float* img = imgs + (size_t)blockIdx.z * H * W;
  float* dst = out + (size_t)blockIdx.z * H * W;
  // Global offsets of each region's (0, 0) relative to the tile origin.
  const int off_g = -2 * r - g.rb;
  const int off_img = off_g - 1;
  const int off_resp = -2 * r;
  const int off_tied = -r;
  auto inside = [&](int y, int x) { return y >= 0 && y < H && x >= 0 && x < W; };

  // 1. Image tile + halo, zero outside the image.          -> B0 (n_img^2)
  for (int e = tid; e < g.n_img * g.n_img; e += kThreads) {
    const int y = ty0 + off_img + e / g.n_img;
    const int x = tx0 + off_img + e % g.n_img;
    B0[e] = inside(y, x) ? img[(size_t)y * W + x] : 0.0f;
  }
  __syncthreads();

  // 2. Sobel gx, gy on the gradient region, zero outside.  -> B1, B2 (n_g^2)
  //    gx = [-1,0,1]_x of ([1,2,1]_y img); gy = [-1,0,1]_y of ([1,2,1]_x img).
  for (int e = tid; e < g.n_g * g.n_g; e += kThreads) {
    const int ly = e / g.n_g, lx = e % g.n_g;
    const int y = ty0 + off_g + ly, x = tx0 + off_g + lx;
    float gxv = 0.0f, gyv = 0.0f;
    if (inside(y, x)) {
      const float* I = B0 + (size_t)(ly + 1) * g.n_img + (lx + 1);
      const int s = g.n_img;
      const float sl = (I[-s - 1] + 2.0f * I[-1]) + I[s - 1];
      const float sr = (I[-s + 1] + 2.0f * I[1]) + I[s + 1];
      const float tu = (I[-s - 1] + 2.0f * I[-s]) + I[-s + 1];
      const float td = (I[s - 1] + 2.0f * I[s]) + I[s + 1];
      gxv = -sl + sr;
      gyv = -tu + td;
    }
    B1[e] = gxv;
    B2[e] = gyv;
  }
  __syncthreads();

  // 3. Vertical box sums of the products (rows n_resp, cols n_g).
  //    vxx -> B0, vyy -> B3, vxy -> B4.
  for (int e = tid; e < g.n_resp * g.n_g; e += kThreads) {
    const int vr = e / g.n_g, vc = e % g.n_g;
    float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
    for (int i = 0; i < g.p; ++i) {
      const float a = B1[(size_t)(vr + i) * g.n_g + vc];
      const float b = B2[(size_t)(vr + i) * g.n_g + vc];
      const float xx = a * a, yy = b * b, xy = a * b;
      if (i == 0) {
        sxx = xx; syy = yy; sxy = xy;
      } else {
        sxx = sxx + xx; syy = syy + yy; sxy = sxy + xy;
      }
    }
    B0[e] = sxx;
    B3[e] = syy;
    B4[e] = sxy;
  }
  __syncthreads();

  // 4. Horizontal box sums (n_resp^2): sxx -> B1, syy -> B2.
  for (int e = tid; e < g.n_resp * g.n_resp; e += kThreads) {
    const int sr = e / g.n_resp, sc = e % g.n_resp;
    const float* vxx = B0 + (size_t)sr * g.n_g + sc;
    const float* vyy = B3 + (size_t)sr * g.n_g + sc;
    float a = vxx[0], b = vyy[0];
    for (int i = 1; i < g.p; ++i) {
      a = a + vxx[i];
      b = b + vyy[i];
    }
    B1[e] = a;
    B2[e] = b;
  }
  __syncthreads();
  //    sxy -> B0 (vxx is consumed).
  for (int e = tid; e < g.n_resp * g.n_resp; e += kThreads) {
    const int sr = e / g.n_resp, sc = e % g.n_resp;
    const float* vxy = B4 + (size_t)sr * g.n_g + sc;
    float a = vxy[0];
    for (int i = 1; i < g.p; ++i) a = a + vxy[i];
    B0[e] = a;
  }
  __syncthreads();

  // 5. Response, -inf outside the image.                    -> B3 (n_resp^2)
  for (int e = tid; e < g.n_resp * g.n_resp; e += kThreads) {
    const int ly = e / g.n_resp, lx = e % g.n_resp;
    const int y = ty0 + off_resp + ly, x = tx0 + off_resp + lx;
    const float sxx = B1[e], syy = B2[e], sxy = B0[e];
    float resp;
    if (mode == 1) {
      const float det = sxx * syy - sxy * sxy;
      const float tr = sxx + syy;
      resp = fmaxf(det - kappa * tr * tr, 0.0f);
    } else {
      const float half_tr = 0.5f * (sxx + syy);
      const float d = sxx - syy;
      const float rad = sqrtf(fmaxf(0.25f * (d * d) + sxy * sxy, 0.0f));
      resp = fmaxf(half_tr - rad, 0.0f);
    }
    B3[e] = inside(y, x) ? resp : -INFINITY;
  }
  __syncthreads();

  const int win = 2 * r + 1;
  // 6. Vertical max of the response (rows n_tied, cols n_resp) -> B4.
  for (int e = tid; e < g.n_tied * g.n_resp; e += kThreads) {
    const int mr = e / g.n_resp, mc = e % g.n_resp;
    float m = -INFINITY;
    for (int j = 0; j < win; ++j) m = fmaxf(m, B3[(size_t)(mr + j) * g.n_resp + mc]);
    B4[e] = m;
  }
  __syncthreads();
  // 7. Horizontal max -> pooled (n_tied^2)                   -> B0.
  for (int e = tid; e < g.n_tied * g.n_tied; e += kThreads) {
    const int pr = e / g.n_tied, pc = e % g.n_tied;
    const float* row = B4 + (size_t)pr * g.n_resp + pc;
    float m = -INFINITY;
    for (int j = 0; j < win; ++j) m = fmaxf(m, row[j]);
    B0[e] = m;
  }
  __syncthreads();
  // 8. Tie-break candidates: flat index where resp >= pooled, else -1 -> B1.
  for (int e = tid; e < g.n_tied * g.n_tied; e += kThreads) {
    const int ly = e / g.n_tied, lx = e % g.n_tied;
    const int y = ty0 + off_tied + ly, x = tx0 + off_tied + lx;
    const float resp = B3[(size_t)(ly + r) * g.n_resp + (lx + r)];
    const bool cand = inside(y, x) && resp >= B0[e];
    B1[e] = cand ? (float)(y * W + x) : -1.0f;
  }
  __syncthreads();
  // 9. Vertical max of the candidates (rows kTile, cols n_tied) -> B2.
  for (int e = tid; e < kTile * g.n_tied; e += kThreads) {
    const int a = e / g.n_tied, b = e % g.n_tied;
    float m = -INFINITY;
    for (int j = 0; j < win; ++j) m = fmaxf(m, B1[(size_t)(a + j) * g.n_tied + b]);
    B2[e] = m;
  }
  __syncthreads();
  // 10. Horizontal max, the strict-maximum test, one global write.
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int oy = e / kTile, ox = e % kTile;
    const int y = ty0 + oy, x = tx0 + ox;
    if (!inside(y, x)) continue;
    const float* row = B2 + (size_t)oy * g.n_tied + ox;
    float pidx = -INFINITY;
    for (int j = 0; j < win; ++j) pidx = fmaxf(pidx, row[j]);
    const float resp = B3[(size_t)(oy + 2 * r) * g.n_resp + (ox + 2 * r)];
    const float pooled = B0[(size_t)(oy + r) * g.n_tied + (ox + r)];
    const bool is_max = resp >= pooled && (float)(y * W + x) == pidx;
    dst[(size_t)y * W + x] = is_max ? resp : -INFINITY;
  }
}

}  // namespace

// imgs, out: (B, H, W) f32 contiguous on the current device. mode 0 =
// Shi-Tomasi, 1 = Harris. Returns a cudaError_t (0 = launched).
extern "C" int vo_corner_response_nms(const void* imgs, void* out, int B, int H,
                                      int W, int mode, int patch, float kappa,
                                      int nms_radius, void* stream) {
  const Geometry g(nms_radius, patch);
  const size_t smem = g.floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      corner_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  corner_nms_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)imgs, (float*)out, H, W, mode, patch, kappa, nms_radius);
  return (int)cudaGetLastError();
}

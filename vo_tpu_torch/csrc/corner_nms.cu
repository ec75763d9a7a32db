// K1 / K1b — fused corner response + non-maximum suppression, batched.
//
// Replaces vo_tpu/ops/pallas_kernels.py::corner_response_nms (and its
// (B, strips) twin corner_response_nms_batched). Computes, for each image of a
// (B, H, W) f32 stack, the (H, W) map that holds the Shi-Tomasi (min
// eigenvalue) or Harris (det - kappa tr^2) response, clamped at 0, at strict
// local maxima of a (2r+1)^2 window and -inf everywhere else; ties between
// equal maxima go to the largest flat index. The oracle is the plain PyTorch
// chain in vo_tpu_torch/ops/harris.py (== vo_tpu/ops/harris.py).
//
// What bounds it on an H100: not HBM (one read and one write of the image,
// 2.5 MB at 640x480, under a microsecond) but shared-memory traffic and the
// barriers between the stencil passes over a halo of 2r + patch/2 + 1 pixels
// on every side of the tile. The design cuts both:
//
//  * One 512-thread block per 64x40 tile (VO_K1_TILE_W x VO_K1_TILE_H): a
//    640x480 image is 10 x 12 = 120 blocks, ONE wave on the card's 132 SMs at
//    one block per SM, and the halo region is 3.3x the tile (a 32x32 tile
//    paid 5.1x and needed a second, almost empty wave). A batch of B lanes is
//    the same kernel over blockIdx.z: 120 B blocks, B * 120 / 132 waves.
//  * `patch` and `r` are template parameters for the values the package's
//    configuration uses (patch 7 with r 8 or 5; VO_K1_SPECIALISED below), so
//    every tap loop unrolls, every index split is by a constant and every
//    window lives in registers. Any other (patch, r) runs the generic
//    instance <0, 0> of the SAME code: run-time bounds as predicates and
//    uniform branches over fixed-size arrays (box windows up to 15 wide, max
//    windows by doubling and a barrel shifter). It is right for every patch
//    up to 15 and every radius whose halo fits the shared memory, and several
//    times slower than a specialised instance: a pair that a configuration
//    comes to use gets an instance of its own.
//  * Seven passes and six barriers (were ten and eleven):
//      1 load the tile + halo, zero outside the image;
//      2 Sobel fused with the vertical box sums: a thread walks down a column
//        segment with the 3x3 neighbourhood and the last `patch` gradient
//        products in registers (no gx/gy buffers);
//      3 horizontal box sums fused with the response: a thread walks along a
//        row segment with the last `patch` column sums in registers;
//      4 vertical window max of the response;
//      5 horizontal window max fused with the tie-break candidates (the flat
//        index where response >= pooled, else -1). `pooled` is not stored: a
//        pixel is a maximum iff its candidate is >= 0 and equals the pooled
//        candidate, which is the oracle's test (response >= pooled and
//        index == pooled index) since a candidate is the index or -1;
//      6 horizontal, then 7 vertical window max of the candidates (max is
//        exact in any order; vertical last puts a warp's lanes on adjacent
//        columns, so the one global write is coalesced), the test, the write.
//    Each window max loads its segment (+2r) into registers once and reduces
//    it by doubling (1, 2, 4, ... wide windows, then one overlapping pair):
//    5 max operations an output at r = 8 instead of 16, one shared-memory
//    load an input instead of 17 an output.
//  * Row strides are odd, so passes whose lanes sit on different rows (3, 5,
//    6) and passes whose lanes sit on adjacent columns (2, 4, 7) are both free
//    of bank conflicts. Two regions are reused: A = tile+halo, then response;
//    B = the three column-sum planes, then the max planes (~123 KB at
//    patch 7, r 8, so the launcher opts in to > 48 KB for every instance).
//
// Every sum keeps the oracle's tap order (no running sums: they would reorder
// the additions) and the file is built with -fmad=false, so no contracted FMA
// can flip a near-tie between NMS neighbours: the map is bit-identical to the
// plain version's.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, shi_tomasi,
// patch 7, r 8, device time from a replayed CUDA graph: (480, 640) 0.020 ms
// (the ten-pass 32x32-tile kernel before it: 0.071 ms), (6, 480, 640) 0.111 ms
// for 5.45 waves (before: 0.274 ms); the byte bound is 0.0007 / 0.0044 ms.
// What is left is the latency of seven dependent passes on 16 warps an SM.
// Other tiles read (tools/time_kernels_torch.py --tiles): 64x32 with two
// blocks an SM 0.028 / 0.090 ms, 64x64 0.024 / 0.094 ms, 128x40 with 1,024
// threads 0.026 / 0.076 ms: a larger tile pays less halo and wins once the
// grid is several waves, a 64x40 tile wins at one image.

#include <cuda_runtime.h>
#include <math.h>

#ifndef VO_K1_TILE_W
#define VO_K1_TILE_W 64
#endif
#ifndef VO_K1_TILE_H
#define VO_K1_TILE_H 40
#endif
#ifndef VO_K1_THREADS
#define VO_K1_THREADS 512
#endif

namespace {

constexpr int kTW = VO_K1_TILE_W;
constexpr int kTH = VO_K1_TILE_H;
constexpr int kThreads = VO_K1_THREADS;
constexpr int kWarps = kThreads / 32;
// The generic instance: box windows up to kMaxPatch, and window-max segments
// (outputs + 2r inputs) of at most kGenericCap registers.
constexpr int kMaxPatch = 15;
constexpr int kGenericCap = 40;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may ask for

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// How a pass is cut into work items: `lines` rows (or columns) times
// `n_seg` segments of `seg` outputs along the line; item -> (item % lines,
// item / lines), so a warp's lanes sit on adjacent lines.
struct Split {
  int lines, seg, items;
  __host__ __device__ constexpr Split(int lines_, int n_out, int max_seg)
      : lines(lines_),
        seg(imin(ceil_div(n_out, imax(1, kThreads / lines_)), max_seg)),
        items(lines_ * ceil_div(n_out, seg)) {}
};

struct Geom {
  int p, r, rb, win;
  // Extents (rows x cols) of the regions around a tile.
  int img_h, img_w;    // tile + halo
  int g_w;             // gradient columns (rows are walked, never stored)
  int resp_h, resp_w;  // response: tile + 2r on every side
  int tied_h, tied_w;  // candidates: tile + r on every side
  // Odd row strides.
  int img_s, v_s, resp_s, vmax_s, cand_s, hmax_s;
  // Offsets of each region's (0, 0) from the tile origin.
  int off_img, off_g, off_resp, off_tied;
  Split vbox, hbox, vmax, hmax, hmax2, vmax2;
  int region_a, region_b;  // floats

  // `cap`: the most inputs (outputs + 2r) a window-max item may hold.
  __host__ __device__ constexpr Geom(int p_, int r_, int cap)
      : p(p_), r(r_), rb(p_ / 2), win(2 * r_ + 1),
        img_h(kTH + 4 * r_ + p_ + 1), img_w(kTW + 4 * r_ + p_ + 1),
        g_w(kTW + 4 * r_ + p_ - 1),
        resp_h(kTH + 4 * r_), resp_w(kTW + 4 * r_),
        tied_h(kTH + 2 * r_), tied_w(kTW + 2 * r_),
        img_s(img_w | 1), v_s(g_w | 1), resp_s(resp_w | 1), vmax_s(resp_w | 1),
        cand_s(tied_w | 1), hmax_s(kTW | 1),
        off_img(-2 * r_ - p_ / 2 - 1), off_g(-2 * r_ - p_ / 2),
        off_resp(-2 * r_), off_tied(-r_),
        vbox(g_w, resp_h, 1 << 20), hbox(resp_h, resp_w, 1 << 20),
        vmax(resp_w, tied_h, cap - 2 * r_), hmax(tied_h, tied_w, cap - 2 * r_),
        hmax2(tied_h, kTW, cap - 2 * r_), vmax2(kTW, kTH, cap - 2 * r_),
        region_a(imax(img_h * img_s, resp_h * resp_s)),
        region_b(imax(3 * resp_h * v_s, tied_h * (vmax_s + cand_s + hmax_s))) {}
  __host__ __device__ constexpr size_t smem_bytes() const {
    return (size_t)(region_a + region_b) * sizeof(float);
  }
  // The widest window-max item, in inputs.
  __host__ __device__ constexpr int max_inputs() const {
    return imax(imax(vmax.seg, hmax.seg), imax(hmax2.seg, vmax2.seg)) + 2 * r;
  }
};

// x[i] <- max(x[i], x[i + C]) wherever both lie inside the n_in inputs; C is
// a constant, so every index is static and x stays in registers.
template <int CAP, int C>
__device__ __forceinline__ void max_step(float (&x)[CAP], int n_in) {
#pragma unroll
  for (int i = 0; i + C < CAP; ++i) {
    if (i + C < n_in) x[i] = fmaxf(x[i], x[i + C]);
  }
}

// z[i] <- z[i + K] (K a constant; the top K entries keep stale values).
template <int CAP, int K>
__device__ __forceinline__ void shift_down(float (&z)[CAP]) {
#pragma unroll
  for (int i = 0; i + K < CAP; ++i) z[i] = z[i + K];
}

// x[i] <- max(x[i .. i + win - 1]) for every i < n_in - win + 1, in place, by
// doubling: windows 1, 2, 4, ... wide, then one overlapping pair at distance
// win - (the widest power of two). WIN > 0: the window is a constant. WIN = 0
// (the generic instance): the window is win_rt < 64; the doubling steps run
// under uniform branches and the last pair's distance is applied to a copy
// by a barrel shifter (one constant shift per bit), so that here too every
// index is static and nothing is indexed at run time.
template <int CAP, int WIN>
__device__ __forceinline__ void window_max(float (&x)[CAP], int n_in, int win_rt) {
  if constexpr (WIN > 0) {
    static_assert(WIN < 64, "window_max doubles up to 32");
    if constexpr (WIN >= 2) max_step<CAP, 1>(x, n_in);
    if constexpr (WIN >= 4) max_step<CAP, 2>(x, n_in);
    if constexpr (WIN >= 8) max_step<CAP, 4>(x, n_in);
    if constexpr (WIN >= 16) max_step<CAP, 8>(x, n_in);
    if constexpr (WIN >= 32) max_step<CAP, 16>(x, n_in);
    constexpr int kDone = WIN >= 32 ? 32 : WIN >= 16 ? 16 : WIN >= 8 ? 8 : WIN >= 4 ? 4
                          : WIN >= 2 ? 2 : 1;
    if constexpr (WIN > kDone) max_step<CAP, WIN - kDone>(x, n_in);
  } else {
    int done = 1;
    if (win_rt >= 2) { max_step<CAP, 1>(x, n_in); done = 2; }
    if (win_rt >= 4) { max_step<CAP, 2>(x, n_in); done = 4; }
    if (win_rt >= 8) { max_step<CAP, 4>(x, n_in); done = 8; }
    if (win_rt >= 16) { max_step<CAP, 8>(x, n_in); done = 16; }
    if (win_rt >= 32) { max_step<CAP, 16>(x, n_in); done = 32; }
    const int s = win_rt - done;  // 0 <= s < done <= 32
    if (s > 0) {
      float z[CAP];
#pragma unroll
      for (int i = 0; i < CAP; ++i) z[i] = x[i];
      if (s & 1) shift_down<CAP, 1>(z);
      if (s & 2) shift_down<CAP, 2>(z);
      if (s & 4) shift_down<CAP, 4>(z);
      if (s & 8) shift_down<CAP, 8>(z);
      if (s & 16) shift_down<CAP, 16>(z);
#pragma unroll
      for (int i = 0; i < CAP; ++i) {
        if (i + s < n_in) x[i] = fmaxf(x[i], z[i]);
      }
    }
  }
}

// The last `p` values of a walk, oldest first, in registers.
template <int PC>
struct Ring {
  float v[PC];
  __device__ __forceinline__ void push(float x, int p) {
#pragma unroll
    for (int i = 0; i < PC - 1; ++i) {
      if (i < p - 1) v[i] = v[i + 1];
    }
#pragma unroll
    for (int i = 0; i < PC; ++i) {
      if (i == p - 1) v[i] = x;
    }
  }
  // ((v0 + v1) + v2) + ... : the oracle's shifted adds in tap order.
  __device__ __forceinline__ float sum(int p) const {
    float s = v[0];
#pragma unroll
    for (int i = 1; i < PC; ++i) {
      if (i < p) s = s + v[i];
    }
    return s;
  }
};

// P, R > 0: the instance for that patch and radius, everything a constant.
// P = R = 0: the generic instance, patch and r from the arguments.
template <int P, int R>
__global__ void __launch_bounds__(kThreads, 1)
corner_nms_kernel(const float* __restrict__ imgs, float* __restrict__ out,
                  int H, int W, int mode, float kappa, int patch_rt, int r_rt) {
  extern __shared__ float smem[];
  constexpr bool kStatic = P > 0;
  constexpr Geom kGs(kStatic ? P : 1, kStatic ? R : 1, 1 << 20);
  constexpr int PC = kStatic ? P : kMaxPatch;
  constexpr int CAP = kStatic ? kGs.max_inputs() : kGenericCap;
  constexpr int WIN = kStatic ? 2 * R + 1 : 0;
  const Geom g = kStatic ? kGs : Geom(patch_rt, r_rt, kGenericCap);
  const int p = g.p, r = g.r;

  float* A = smem;               // tile + halo, then the response
  float* Bq = smem + g.region_a;  // column sums, then the max planes
  float* IMG = A;
  float* RESP = A;
  float* VXX = Bq;
  float* VYY = VXX + g.resp_h * g.v_s;
  float* VXY = VYY + g.resp_h * g.v_s;
  float* VMAX = Bq;
  float* CAND = VMAX + g.tied_h * g.vmax_s;
  float* HMAX = CAND + g.tied_h * g.cand_s;

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kTH;
  const int tx0 = blockIdx.x * kTW;
  const float* img = imgs + (size_t)blockIdx.z * H * W;
  float* dst = out + (size_t)blockIdx.z * H * W;

  // 1. Tile + halo, zero outside the image.                 -> IMG
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int row = warp; row < g.img_h; row += kWarps) {
      const int y = ty0 + g.off_img + row;
      const bool y_in = y >= 0 && y < H;
      for (int col = lane; col < g.img_w; col += 32) {
        const int x = tx0 + g.off_img + col;
        IMG[row * g.img_s + col] =
            (y_in && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.0f;
      }
    }
  }
  __syncthreads();

  // 2. Sobel (zero outside the image, as the oracle zero-pads between
  //    stages) and the vertical box sums of gx^2, gy^2, gx*gy, walking down a
  //    column segment.                                       -> VXX, VYY, VXY
  //    gx = [-1,0,1]_x of ([1,2,1]_y img); gy = [-1,0,1]_y of ([1,2,1]_x img).
  for (int item = tid; item < g.vbox.items; item += kThreads) {
    const int c = item % g.g_w;
    const int v0 = (item / g.g_w) * g.vbox.seg;
    const int v1 = imin(v0 + g.vbox.seg, g.resp_h);
    const int x = tx0 + g.off_g + c;
    const bool x_in = x >= 0 && x < W;
    // Gradient row j reads image rows j, j+1, j+2 at columns c, c+1, c+2.
    const float* I = IMG + c;
    float t0 = I[v0 * g.img_s], t1 = I[v0 * g.img_s + 1], t2 = I[v0 * g.img_s + 2];
    float m0 = I[(v0 + 1) * g.img_s], m1 = I[(v0 + 1) * g.img_s + 1],
          m2 = I[(v0 + 1) * g.img_s + 2];
    Ring<PC> rxx, ryy, rxy;
    for (int j = v0; j < v1 + p - 1; ++j) {
      const float* row = I + (j + 2) * g.img_s;
      const float b0 = row[0], b1 = row[1], b2 = row[2];
      const int y = ty0 + g.off_g + j;
      float gx = 0.0f, gy = 0.0f;
      if (x_in && y >= 0 && y < H) {
        const float sl = (t0 + 2.0f * m0) + b0;
        const float sr = (t2 + 2.0f * m2) + b2;
        const float tu = (t0 + 2.0f * t1) + t2;
        const float td = (b0 + 2.0f * b1) + b2;
        gx = -sl + sr;
        gy = -tu + td;
      }
      rxx.push(gx * gx, p);
      ryy.push(gy * gy, p);
      rxy.push(gx * gy, p);
      if (j - v0 >= p - 1) {
        const int o = (j - (p - 1)) * g.v_s + c;
        VXX[o] = rxx.sum(p);
        VYY[o] = ryy.sum(p);
        VXY[o] = rxy.sum(p);
      }
      t0 = m0; t1 = m1; t2 = m2;
      m0 = b0; m1 = b1; m2 = b2;
    }
  }
  __syncthreads();

  // 3. Horizontal box sums and the response (-inf outside the image),
  //    walking along a row segment.                          -> RESP
  for (int item = tid; item < g.hbox.items; item += kThreads) {
    const int sr = item % g.resp_h;
    const int c0 = (item / g.resp_h) * g.hbox.seg;
    const int c1 = imin(c0 + g.hbox.seg, g.resp_w);
    const int y = ty0 + g.off_resp + sr;
    const bool y_in = y >= 0 && y < H;
    Ring<PC> rxx, ryy, rxy;
    for (int c = c0; c < c1 + p - 1; ++c) {
      rxx.push(VXX[sr * g.v_s + c], p);
      ryy.push(VYY[sr * g.v_s + c], p);
      rxy.push(VXY[sr * g.v_s + c], p);
      if (c - c0 >= p - 1) {
        const int sc = c - (p - 1);
        const float sxx = rxx.sum(p), syy = ryy.sum(p), sxy = rxy.sum(p);
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
        const int x = tx0 + g.off_resp + sc;
        RESP[sr * g.resp_s + sc] = (y_in && x >= 0 && x < W) ? resp : -INFINITY;
      }
    }
  }
  __syncthreads();

  // 4. Vertical window max of the response.                  -> VMAX
  for (int item = tid; item < g.vmax.items; item += kThreads) {
    const int c = item % g.resp_w;
    const int o0 = (item / g.resp_w) * g.vmax.seg;
    const int n_out = imin(g.vmax.seg, g.tied_h - o0);
    const int n_in = n_out + 2 * r;
    float x[CAP];
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i < n_in) x[i] = RESP[(o0 + i) * g.resp_s + c];
    }
    window_max<CAP, WIN>(x, n_in, g.win);
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i < n_out) VMAX[(o0 + i) * g.vmax_s + c] = x[i];
    }
  }
  __syncthreads();

  // 5. Horizontal window max = pooled; the tie-break candidate: the flat
  //    index where the response reaches pooled, else -1.      -> CAND
  for (int item = tid; item < g.hmax.items; item += kThreads) {
    const int row = item % g.tied_h;
    const int o0 = (item / g.tied_h) * g.hmax.seg;
    const int n_out = imin(g.hmax.seg, g.tied_w - o0);
    const int n_in = n_out + 2 * r;
    float x[CAP];
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i < n_in) x[i] = VMAX[row * g.vmax_s + o0 + i];
    }
    window_max<CAP, WIN>(x, n_in, g.win);
    const int y = ty0 + g.off_tied + row;
    const bool y_in = y >= 0 && y < H;
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i < n_out) {
        const int xg = tx0 + g.off_tied + o0 + i;
        const float resp = RESP[(row + r) * g.resp_s + (o0 + i + r)];
        const bool cand = y_in && xg >= 0 && xg < W && resp >= x[i];
        CAND[row * g.cand_s + o0 + i] = cand ? (float)(y * W + xg) : -1.0f;
      }
    }
  }
  __syncthreads();

  // 6. Horizontal window max of the candidates, tile columns. -> HMAX
  for (int item = tid; item < g.hmax2.items; item += kThreads) {
    const int row = item % g.tied_h;
    const int o0 = (item / g.tied_h) * g.hmax2.seg;
    const int n_out = imin(g.hmax2.seg, kTW - o0);
    const int n_in = n_out + 2 * r;
    float x[CAP];
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i < n_in) x[i] = CAND[row * g.cand_s + o0 + i];
    }
    window_max<CAP, WIN>(x, n_in, g.win);
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i < n_out) HMAX[row * g.hmax_s + o0 + i] = x[i];
    }
  }
  __syncthreads();

  // 7. Vertical window max of the candidates, the strict-maximum test, one
  //    coalesced global write.
  for (int item = tid; item < g.vmax2.items; item += kThreads) {
    const int c = item % kTW;
    const int o0 = (item / kTW) * g.vmax2.seg;
    const int n_out = imin(g.vmax2.seg, kTH - o0);
    const int n_in = n_out + 2 * r;
    const int xg = tx0 + c;
    if (xg >= W) continue;
    float x[CAP];
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i < n_in) x[i] = HMAX[(o0 + i) * g.hmax_s + c];
    }
    window_max<CAP, WIN>(x, n_in, g.win);
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      const int y = ty0 + o0 + i;
      if (i < n_out && y < H) {
        const float cand = CAND[(o0 + i + r) * g.cand_s + (c + r)];
        const float resp = RESP[(o0 + i + 2 * r) * g.resp_s + (c + 2 * r)];
        const bool is_max = cand >= 0.0f && cand == x[i];
        dst[(size_t)y * W + xg] = is_max ? resp : -INFINITY;
      }
    }
  }
}

typedef void (*KernelFn)(const float*, float*, int, int, int, float, int, int);

// The (patch, r) pairs with an instance of their own: the package's
// configuration (patch 7 with r 8 for Shi-Tomasi, r 5 for Harris) and the
// defaults of harris_response / detect_keypoints (patch 9, r 5). One more
// pair is one more X(patch, r) here.
#define VO_K1_SPECIALISED(X) X(7, 8) X(7, 5) X(9, 5)

#define VO_K1_COUNT(P, R) +1
constexpr int kSpecialised = 0 VO_K1_SPECIALISED(VO_K1_COUNT);

struct Instance {
  KernelFn fn;  // nullptr: no instance takes this patch and radius
  size_t smem;
  int slot;  // < kSpecialised: a specialised instance; kSpecialised: the generic one
};

Instance pick(int patch, int r) {
  int slot = 0;
#define VO_K1_PICK(P, R)                                                        \
  if (patch == P && r == R)                                                     \
    return {corner_nms_kernel<P, R>, Geom(P, R, 1 << 20).smem_bytes(), slot};   \
  ++slot;
  VO_K1_SPECIALISED(VO_K1_PICK)
  if (patch < 1 || patch > kMaxPatch || r < 0 || kGenericCap - 2 * r < 1)
    return {nullptr, 0, slot};
  const size_t smem = Geom(patch, r, kGenericCap).smem_bytes();
  if (smem > (size_t)kMaxSmemBytes) return {nullptr, 0, slot};
  return {corner_nms_kernel<0, 0>, smem, slot};
}

// More than 48 KB of dynamic shared memory needs the attribute set on every
// instance that is launched; once per instance and device is enough.
cudaError_t configure(const Instance& inst) {
  static bool done[kSpecialised + 1][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < 64;
  if (cached && done[inst.slot][dev]) return cudaSuccess;
  // The generic instance's footprint grows with patch and r: allow the most.
  const size_t want = inst.slot == kSpecialised ? (size_t)kMaxSmemBytes : inst.smem;
  err = cudaFuncSetAttribute((const void*)inst.fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)want);
  if (err == cudaSuccess && cached) done[inst.slot][dev] = true;
  return err;
}

}  // namespace

// imgs, out: (B, H, W) f32 contiguous on the current device. mode 0 =
// Shi-Tomasi, 1 = Harris. Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue where no instance takes this patch and radius).
extern "C" int vo_corner_response_nms(const void* imgs, void* out, int B, int H,
                                      int W, int mode, int patch, float kappa,
                                      int nms_radius, void* stream) {
  const Instance inst = pick(patch, nms_radius);
  if (inst.fn == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaError_t err = configure(inst);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(W, kTW), ceil_div(H, kTH), B);
  inst.fn<<<grid, kThreads, inst.smem, (cudaStream_t)stream>>>(
      (const float*)imgs, (float*)out, H, W, mode, kappa, patch, nms_radius);
  return (int)cudaGetLastError();
}

// What a launch of (patch, nms_radius) looks like on the current device:
// info = {specialised (1/0), tile_w, tile_h, threads, smem bytes a block,
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), SMs}.
extern "C" int vo_corner_nms_launch_info(int patch, int nms_radius, int* info) {
  const Instance inst = pick(patch, nms_radius);
  if (inst.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure(inst);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)inst.fn,
                                                      kThreads, inst.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  info[0] = inst.slot < kSpecialised ? 1 : 0;
  info[1] = kTW;
  info[2] = kTH;
  info[3] = kThreads;
  info[4] = (int)inst.smem;
  info[5] = blocks;
  info[6] = sms;
  return 0;
}

// BA solve — the reduced camera system of one Gauss-Newton iteration of
// windowed bundle adjustment, sum_j S[i, j] x_j = b_i, for every lane of a
// batch in one launch: S (B, W, W, nb, nb), b (B, W, nb), x (B, W, nb), f32.
//
// Replaces no TPU kernel: the JAX package solves this system with XLA ops
// (vo_tpu/ops/linalg.py's blocked Cholesky, unrolled). The port ran the same
// unrolled loops as plain PyTorch (ops/linalg.py::spd_solve_blocked, which
// stays the CPU path and this kernel's oracle): about 1,570 small launches a
// solve at W = 6, five solves a BA run.
//
// What it computes is the Cholesky factor L of the dense n x n matrix A, n =
// W * nb, element (nb * i + a, nb * j + c) = S[i, j, a, c], read from its
// lower triangle through S's strides (the Schur product leaves S laid out as
// that dense matrix, row-major, so no copy is made), then L y = b and
// L^T x = y. The rounding follows ops/linalg.py::chol_small, the factor's
// per-block routine, and its triangular solves, over the whole matrix:
//  * the pivot s is floored at 1e-20 as torch.clamp floors it (a NaN stays
//    NaN, so a non-finite system gives a non-finite x, which BA's `solve_ok`
//    turns into a no-op step), d = sqrt(s), and a column below its pivot is
//    multiplied by 1 / d;
//  * every element's subtractions run in ascending k, in the factor and in
//    both substitutions, each a product then a subtraction (the library is
//    built with -fmad=false: nothing is contracted into an FMA);
//  * the substitutions divide by the pivot d.
// The blocked solve sums a block's terms in its matmuls' order, so the two
// agree to the system's condition in f32, not bit for bit. The order depends
// on n alone, never on the lane count: a lane of a batch is its single run
// bit for bit.
//
// What bounds it: the dependency chain, not bytes. A lane reads the lower
// triangle of S (about 2.7 KB at W = 6) and b, and writes 4n bytes,
// nanoseconds at HBM rate. The factor is n pivots, each a square root and a
// division that the next column waits for; the back substitution's sum for
// x_i starts from x_{i+1}, the one solved last, so its n (n - 1) / 2 terms
// run one after another. The design keeps those chains free of anything
// else:
//  * one block a lane. Thread t < n holds the diagonal element (t, t) and
//    b_t in registers for the whole factor; the threads from kMaxN on hold
//    the strict lower triangle, a fixed share each (`Slots` elements), so
//    the pivot's warp does nothing but the diagonal;
//  * right-looking, one barrier a column: at pivot j every thread subtracts
//    L[i, j] L[c, j] from its elements (i, c) right of column j, reading
//    column j from shared memory, and stores an element of column j + 1
//    that is then final for the next pivot;
//  * L y = b on the way: thread t subtracts L[t, j] y_j from b_t at pivot j,
//    the forward substitution's terms in its order;
//  * thread j + 1 then holds the next pivot's final element and b's: it
//    takes d, 1 / d and y = b / d at once, so the next column is ready at
//    the barrier, and only its warp waits on them;
//  * no load waits behind a branch: every read is of a valid address, and
//    what is not wanted is left unused;
//  * the back substitution runs on one thread over L in shared memory, the
//    products of each group of eight loaded and multiplied while the group
//    before it is subtracted, with no test in the loop (each column is
//    padded with zeros).
// n is at most kMaxN (W = 16 at nb = 6); the wrapper raises above it.
//
// Each launch adds one to `count` (one thread, one atomic): the device-side
// launch count, which holds inside a CUDA graph's conditional body, where
// the host cannot count without a read.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 96;
// Threads 0..kMaxN - 1 hold the diagonal and b; the rest of the block holds
// the strict lower triangle, so the pivot's warps do nothing else.
constexpr int kPivotThreads = kMaxN;
constexpr int kThreads = kPivotThreads + 288;
constexpr int kSlotThreads = kThreads - kPivotThreads;
constexpr int kGroup = 8;  // the back substitution's products loaded at once
constexpr float kPivotFloor = 1e-20f;

// The strict lower triangle packed column by column: column c holds rows
// c + 1..n - 1.
__host__ __device__ constexpr int strict(int n) { return n * (n - 1) / 2; }
__host__ __device__ inline int column_start(int c, int n) { return c * (n - 1) - c * (c - 1) / 2; }

// Strict-lower elements a thread holds for n up to 36 (W = 6), 72 (W = 12)
// and kMaxN.
constexpr int slots_for(int n) { return (strict(n) + kSlotThreads - 1) / kSlotThreads; }

struct BaSystem {
  const float* S;
  const float* b;
  float* x;  // (B, W, nb) contiguous
  unsigned long long* count;
  long long s_lane, s_i, s_j, s_a, s_c;  // S's strides, in elements
  long long b_lane, b_i, b_a;            // b's strides
  int W, nb;
};

// The pivot's d, 1 / d and y = b / d from its final element s and b's.
__device__ __forceinline__ void pivot(float s, float bs, float* d, float* inv, float* y) {
  const float dd = sqrtf(s < kPivotFloor ? kPivotFloor : s);  // NaN < floor is false: NaN stays
  *d = dd;
  *inv = 1.0f / dd;
  *y = bs / dd;
}

template <int Slots>
__global__ void __launch_bounds__(kThreads) ba_solve_kernel(const BaSystem a) {
  // L's strict lower part column by column, L[r, c] at c * ld + r, with
  // rows n..n + 2 kGroup - 1 of every column 0: the back substitution's
  // groups read that far, and the zeros it reads there change no sum.
  __shared__ float L[kMaxN * (kMaxN + 2 * kGroup)];
  __shared__ float column[2][kMaxN];  // the pivot's column, final values
  __shared__ float piv[kMaxN], inv_piv[kMaxN], y[kMaxN];
  __shared__ float x[kMaxN + 2 * kGroup];  // 0 past n

  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int nb = a.nb, n = a.W * nb;
  const int total = strict(n), ld = n + 2 * kGroup;
  if (lane == 0 && tid == 0 && a.count != nullptr) atomicAdd(a.count, 1ull);

  const float* S = a.S + lane * a.s_lane;
  const float* b = a.b + lane * a.b_lane;
  auto at_S = [&](int r, int c) {
    return S[(r / nb) * a.s_i + (c / nb) * a.s_j + (r % nb) * a.s_a + (c % nb) * a.s_c];
  };
  // This thread's strict-lower elements: row, column (n for a slot past the
  // end: never updated, never stored) and value.
  int row[Slots], col[Slots];
  float v[Slots];
  const float m = 2.0f * n - 1.0f;
#pragma unroll
  for (int s = 0; s < Slots; ++s) {
    const int e = tid - kPivotThreads + s * kSlotThreads;
    int c = n, r = 0;
    if (e >= 0 && e < total) {
      // column_start(c) <= e < column_start(c + 1), from the quadratic's root
      c = (int)((m - sqrtf(m * m - 8.0f * (float)e)) * 0.5f);
      c = c < 0 ? 0 : (c > n - 2 ? n - 2 : c);
      while (c > 0 && column_start(c, n) > e) --c;
      while (c < n - 2 && column_start(c + 1, n) <= e) ++c;
      r = c + 1 + (e - column_start(c, n));
    }
    row[s] = r;
    col[s] = c;
    v[s] = c < n ? at_S(r, c) : 0.0f;
  }
  float vd = 0.0f, vb = 0.0f;  // the diagonal element (tid, tid) and b_tid
  if (tid < n) {
    vd = at_S(tid, tid);
    vb = b[(tid / nb) * a.b_i + (tid % nb) * a.b_a];
  }
  for (int k = tid; k < 2 * kGroup; k += kThreads) x[n + k] = 0.0f;
  for (int k = tid; k < 2 * kGroup * n; k += kThreads) {
    L[(k / (2 * kGroup)) * ld + n + k % (2 * kGroup)] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < Slots; ++s) {
    if (col[s] == 0) column[0][row[s]] = v[s];
  }
  if (tid == 0) pivot(vd, vb, &piv[0], &inv_piv[0], &y[0]);

  // The factor. Before pivot j, column j holds its final elements (i, j):
  // A's minus every L[i, k] L[j, k], k < j, in ascending k.
  for (int j = 0; j < n; ++j) {
    __syncthreads();
    const float* cj = column[j & 1];
    float* next = column[(j + 1) & 1];
    const float inv = inv_piv[j], yj = y[j];
    // The next pivot first: its chain is the step's longest.
    if (tid > j && tid < n) {
      const float ltj = cj[tid] * inv;
      vd = vd - ltj * ltj;
      vb = vb - ltj * yj;
      if (tid == j + 1) pivot(vd, vb, &piv[tid], &inv_piv[tid], &y[tid]);
    }
    if (tid >= kPivotThreads) {  // whole warps
#pragma unroll
      for (int s = 0; s < Slots; ++s) {
        const int r = row[s], c = col[s];
        const float lrj = cj[r] * inv, lcj = cj[c < n ? c : 0] * inv;
        if (c == j) L[c * ld + r] = v[s] * inv;  // column j is final: L[r, j]
        const float updated = v[s] - lrj * lcj;
        v[s] = c > j && c < n ? updated : v[s];
        if (c == j + 1) next[r] = v[s];
      }
    }
  }
  __syncthreads();

  // L^T x = y by one thread: x_i = (y_i - sum over k > i of L[k, i] x_k) / d_i,
  // the terms in ascending k. A group that runs past row n - 1 subtracts
  // products of zeros, +0, which leave every sum as it is.
  // Each group's products are loaded while the group before is subtracted.
  if (tid == 0) {
    for (int i = n - 1; i >= 0; --i) {
      const float* li = L + i * ld;  // li[k] = L[k, i]
      float sum = y[i];
      float p[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) p[u] = li[i + 1 + u] * x[i + 1 + u];
      for (int k0 = i + 1; k0 < n; k0 += kGroup) {
        float q[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) q[u] = li[k0 + kGroup + u] * x[k0 + kGroup + u];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) sum = sum - p[u];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) p[u] = q[u];
      }
      x[i] = sum / piv[i];
    }
  }
  __syncthreads();
  for (int r = tid; r < n; r += kThreads) a.x[(long long)lane * n + r] = x[r];
}

}  // namespace

// x = the solution of every lane's system (see above) on `stream`; `count`
// (one uint64 on the device, or null) gains one. Strides are in elements.
// Returns a cudaError_t, or -1 where W * nb is outside 1..kMaxN.
extern "C" int vo_ba_solve(const void* S, const void* b, void* x, int B, int W, int nb,
                           long long s_lane, long long s_i, long long s_j, long long s_a,
                           long long s_c, long long b_lane, long long b_i, long long b_a,
                           void* count, void* stream) {
  const int n = W * nb;
  if (W < 1 || nb < 1 || n > kMaxN) return -1;
  if (B == 0) return 0;
  const BaSystem a = {(const float*)S, (const float*)b, (float*)x,
                      (unsigned long long*)count, s_lane, s_i, s_j, s_a, s_c,
                      b_lane, b_i, b_a, W, nb};
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= 36) {
    ba_solve_kernel<slots_for(36)><<<B, kThreads, 0, st>>>(a);
  } else if (n <= 72) {
    ba_solve_kernel<slots_for(72)><<<B, kThreads, 0, st>>>(a);
  } else {
    ba_solve_kernel<slots_for(kMaxN)><<<B, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

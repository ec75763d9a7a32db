"""BA's camera-system solve (`ops/kernels.py::ba_solve`) on the CPU.

  * the wrapper on a CPU tensor is `spd_solve_blocked`, bit for bit, with
    and without a lane axis, and launches nothing; BA's step takes it as its
    default solve;
  * the device count's slot: the one `counting_on_device` sets, else none;
  * the kernel's source (csrc/ba_solve.cu) compiled as C++ with a stand-in
    for the bit of CUDA it uses (a block's threads as std::threads,
    `__syncthreads` a std::barrier, a warp's shuffle an exchange between
    barriers of its 32 threads): its x bit for bit as a float32 numpy
    run of the same algorithm in the same order, near the float64 solve, a
    lane of a batch equal to its single run, the strides of the Schur
    layout read in place, a non-finite system non-finite, one count a
    launch. These skip where g++ is missing; the card runs the kernel itself
    (tests/test_torch_ba_solve_cuda.py).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from vo_tpu_torch.models import ba as tba
from vo_tpu_torch.ops import kernels
from vo_tpu_torch.ops.linalg import spd_solve_blocked
from vo_tpu_torch.parallel.dist_ba import demo_window

torch.set_num_threads(1)

SOURCE = Path(kernels.__file__).resolve().parent.parent / "csrc" / "ba_solve.cu"
K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)

STUB = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* g_barrier = nullptr;
inline std::vector<std::barrier<>*> g_warp_barrier;
inline float g_shuffled[64][32];
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src) {
  const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
  g_shuffled[w][lane] = v;
  g_warp_barrier[w]->arrive_and_wait();
  const float got = g_shuffled[w][src & 31];
  g_warp_barrier[w]->arrive_and_wait();
  return got;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p; *p += v; return old; }
inline void stand_in_launch(int blocks, int threads, const std::function<void()>& body) {
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> barrier(threads);
    g_barrier = &barrier;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    g_warp_barrier.clear();
    for (int w = 0; w < threads / 32; ++w) {
      warps.push_back(std::make_unique<std::barrier<>>(32));
      g_warp_barrier.push_back(warps.back().get());
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] { blockIdx.x = b; threadIdx.x = t; body(); });
    for (auto& t : ts) t.join();
  }
}
"""
# A launch of one instance: `ba_solve_kernel<Slots><<<B, kThreads, 0, st>>>(a);`
LAUNCH = re.compile(r"ba_solve_kernel<([^<>]+(?:<[^<>]*>[^<>]*)?)><<<B, kThreads, 0, st>>>\(a\);")


def _systems(lanes, W, seed, cond=1e3, nb=6):
    """`lanes` random SPD block systems (lanes, W, W, nb, nb) of condition
    `cond`, and right-hand sides (lanes, W, nb), float32."""
    rng = np.random.default_rng(seed)
    n = W * nb
    S = []
    for _ in range(lanes):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        A = (Q * np.geomspace(1.0, cond, n)) @ Q.T
        S.append(A.reshape(W, nb, W, nb).transpose(0, 2, 1, 3))
    return (torch.tensor(np.stack(S), dtype=torch.float32),
            torch.tensor(rng.normal(size=(lanes, W, nb)), dtype=torch.float32))


@pytest.mark.parametrize("W", [1, 6, 12])
@pytest.mark.parametrize("lanes", [None, 1, 3])
def test_wrapper_on_the_cpu_is_the_blocked_cholesky(W, lanes):
    S, b = _systems(lanes or 1, W, seed=W)
    if lanes is None:
        S, b = S[0], b[0]
    calls, counts = dict(kernels.device_calls), dict(kernels.launch_counts)
    got = kernels.ba_solve(S, b)
    assert torch.equal(got, spd_solve_blocked(S, b))
    assert kernels.device_calls == calls and kernels.launch_counts == counts


def test_gn_step_solves_through_the_wrapper():
    """BA's step takes `kernels.ba_solve` by default: on the CPU, the
    blocked Cholesky's step bit for bit."""
    win = demo_window(128, num_keyframes=6, seed=3)
    win = tba.BAWindow(*(f[None] for f in win))
    Kt = torch.as_tensor(K).reshape(1, 3, 3)
    default = tba._gn_step(win, Kt, 1e-3, 2.0)
    plain = tba._gn_step(win, Kt, 1e-3, 2.0, solve=spd_solve_blocked)
    assert all(torch.equal(a, b) for a, b in zip(default, plain))


def test_counting_on_device_sets_the_slot():
    """Inside `counting_on_device` a launch on the slots' device is handed
    its kernel's slot; elsewhere, and on another device, none."""
    cpu = torch.device("cpu")
    assert kernels._count_slot(cpu, "ba_solve") is None
    taken = torch.zeros(2 + len(kernels.DEVICE_COUNTED), dtype=torch.int64)
    with kernels.counting_on_device(taken[2:]):
        assert kernels._count_slot(cpu, "ba_solve") == taken[2:].data_ptr()
        assert kernels._count_slot(torch.device("meta"), "ba_solve") is None
        inner = torch.zeros(len(kernels.DEVICE_COUNTED), dtype=torch.int64)
        with kernels.counting_on_device(inner):
            assert kernels._count_slot(cpu, "ba_solve") == inner.data_ptr()
        assert kernels._count_slot(cpu, "ba_solve") == taken[2:].data_ptr()
    assert kernels._count_slot(cpu, "ba_solve") is None


# ---------------------------------------------------------------------------
# The kernel's source on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    """The kernel's C entry, built as C++ against the stand-in."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    src, launches = LAUNCH.subn(
        r"stand_in_launch(B, kThreads, [&] { ba_solve_kernel<\1>(a); });", SOURCE.read_text())
    assert launches == 3  # one instance a size class: n up to 36, 72 and 96
    d = tmp_path_factory.mktemp("ba_solve")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "ba_solve.cc").write_text(src)
    lib = d / "libba_solve.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    f"-I{d}", "-o", str(lib), str(d / "ba_solve.cc"), "-lpthread"],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).vo_ba_solve
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, I, I, I, L, L, L, L, L, L, L, L, P, P]
    fn.restype = ctypes.c_int

    def solve(S, b, count=None):
        lead = S.shape[:-4]
        W, nb = S.shape[-4], S.shape[-1]
        ss, bs = S.stride(), b.stride()
        x = torch.empty(b.shape, dtype=torch.float32)
        err = fn(S.data_ptr(), b.data_ptr(), x.data_ptr(), lead[0] if lead else 1, W, nb,
                 ss[0] if lead else 0, *ss[-4:], bs[0] if lead else 0, *bs[-2:],
                 None if count is None else count.data_ptr(), None)
        assert err == 0
        return x

    return solve


def _numpy_order(S, b):
    """The kernel's algorithm in float32 numpy, element by element: the
    right-looking factor (pivot floored at 1e-20, column scaled by 1 / d,
    each element's terms in ascending k), then both substitutions in
    ascending k, dividing by the pivot."""
    W, nb = S.shape[-4], S.shape[-1]
    n = W * nb
    f = np.float32
    A = S.permute(0, 2, 1, 3).reshape(n, n).numpy().astype(f)
    Lm = np.zeros((n, n), f)
    for j in range(n):
        d = np.sqrt(max(A[j, j], f(1e-20)), dtype=f)
        inv = f(1) / d
        Lm[j, j] = d
        Lm[j + 1:, j] = A[j + 1:, j] * inv
        for c in range(j + 1, n):
            A[c:, c] = A[c:, c] - Lm[c:, j] * Lm[c, j]
    v = b.reshape(n).numpy().astype(f)
    for i in range(n):
        s = v[i]
        for k in range(i):
            s = s - Lm[i, k] * v[k]
        v[i] = s / Lm[i, i]
    for i in reversed(range(n)):
        s = v[i]
        for k in range(i + 1, n):
            s = s - Lm[k, i] * v[k]
        v[i] = s / Lm[i, i]
    return torch.from_numpy(v.reshape(W, nb))


def _f64_error(x, S, b):
    lanes, W, _, nb, _ = S.shape
    dense = S.double().permute(0, 1, 3, 2, 4).reshape(lanes, W * nb, W * nb)
    want = torch.linalg.solve(dense, b.double().reshape(lanes, W * nb, 1)).reshape(b.shape)
    return float((x.double() - want).abs().max())


@pytest.mark.parametrize("W", [1, 3, 6])
def test_kernel_source_is_its_algorithm_in_order(stand_in, W):
    S, b = _systems(2, W, seed=10 + W)
    x = stand_in(S, b)
    for lane in range(2):
        assert torch.equal(x[lane], _numpy_order(S[lane], b[lane]))
    if W == 1:  # one block: chol_small and the two triangular solves
        assert torch.equal(x, spd_solve_blocked(S, b))


@pytest.mark.parametrize("W", [2, 6, 12, 16])
def test_kernel_source_near_float64_and_lane_invariant(stand_in, W):
    S, b = _systems(3, W, seed=20 + W)
    x = stand_in(S, b)
    plain = spd_solve_blocked(S, b)
    assert _f64_error(x, S, b) <= 2 * _f64_error(plain, S, b) + 1e-6
    for lane in range(3):
        assert torch.equal(stand_in(S[lane:lane + 1], b[lane:lane + 1])[0], x[lane])
        assert torch.equal(stand_in(S[lane], b[lane]), x[lane])  # no lane axis


def test_kernel_source_reads_the_schur_layout_in_place(stand_in):
    """BA's S is the dense matrix row-major under a (B, W, W, 6, 6) view:
    the kernel reads it through its strides, as it reads a contiguous S."""
    S, b = _systems(2, 6, seed=3)
    dense_rows = S.permute(0, 1, 3, 2, 4).contiguous().permute(0, 1, 3, 2, 4)
    assert not dense_rows.is_contiguous() and torch.equal(dense_rows, S)
    assert torch.equal(stand_in(dense_rows, b), stand_in(S.contiguous(), b))


def test_kernel_source_on_caught_gn_systems(stand_in):
    """Systems caught from BA's step on the demo window, with the 1e8 gauge
    and with dead keyframes: near the float64 solve as the blocked Cholesky
    is."""
    caught = []

    def keep(S, b):
        caught.append((S, b))
        return spd_solve_blocked(S, b)

    Kt = torch.as_tensor(K).reshape(1, 3, 3)
    for dead in ((), (4, 5)):
        win = demo_window(256, num_keyframes=6, seed=3)
        win = tba.BAWindow(*(f[None] for f in win))
        if dead:
            valid = win.kf_valid.clone()
            valid[0, list(dead)] = False
            win = win._replace(kf_valid=valid)
        tba._gn_step(win, Kt, 1e-3, 2.0, solve=keep)
    for S, b in caught:
        x = stand_in(S, b)
        assert _f64_error(x, S, b) <= 2 * _f64_error(spd_solve_blocked(S, b), S, b) + 1e-6


def test_kernel_source_non_finite_and_singular_systems(stand_in):
    """A NaN in S gives a non-finite x, so `solve_ok` makes the step a
    no-op; a keyframe's rows and columns zeroed (floored pivots) give the
    blocked Cholesky's finiteness, lane by lane."""
    S, b = _systems(4, 6, seed=5)
    S[1, 2, 2, 0, 0] = float("nan")
    S[2, 3], S[2, :, 3] = 0.0, 0.0
    b[2, 3] = 1e19  # 1e19 / 1e-10 / 1e-10 overflows
    S[3, 1], S[3, :, 1], b[3, 1] = 0.0, 0.0, 0.0  # floored pivots, finite x
    ok = torch.isfinite(stand_in(S, b)).flatten(-2).all(-1)
    assert ok.tolist() == [True, False, False, True]
    assert torch.equal(ok, torch.isfinite(spd_solve_blocked(S, b)).flatten(-2).all(-1))


def test_kernel_source_counts_one_a_launch(stand_in):
    S, b = _systems(6, 6, seed=1)
    count = torch.zeros(1, dtype=torch.int64)
    for _ in range(5):
        stand_in(S, b, count)
    assert int(count) == 5

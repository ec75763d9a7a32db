"""The JAX package's last three public helpers in the port, against the JAX
functions on shared numpy inputs (ops/image.py `to_grayscale` and
`gaussian_kernel1d`, ops/triangulate.py `depths_in_frame`), and the rule
that every public top-level function and class of vo_tpu has a counterpart
of the same name at the same module path in vo_tpu_torch, but for a named
list of exceptions, each with its reason."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vo_tpu.ops import image as jimg
from vo_tpu.ops import triangulate as jtri

from vo_tpu_torch.ops import image as timg
from vo_tpu_torch.ops import triangulate as ttri

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _image(kind: str, dtype: str, seed: int = 0) -> np.ndarray:
    shape = (48, 64) if kind == "2d" else (48, 64, 3)
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0, 255, shape).astype(np.float32)


@pytest.mark.parametrize("order", ["rgb", "bgr"])
@pytest.mark.parametrize("kind", ["2d", "3d"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_to_grayscale_equals_the_reference(dtype, kind, order):
    img = _image(kind, dtype)
    got = timg.to_grayscale(torch.from_numpy(img), order)
    want = jimg.to_grayscale(jnp.asarray(img), order)
    assert got.dtype == torch.float32 and got.shape == want.shape == (48, 64)
    # atol 1e-4 on the 0-255 scale: the two dot products sum in other orders.
    np.testing.assert_allclose(N(got), N(want), rtol=0, atol=1e-4)


def test_to_grayscale_weighs_the_channels_by_their_order():
    img = np.zeros((2, 2, 3), np.uint8)
    img[..., 0] = 100  # red in "rgb", blue in "bgr"
    assert float(timg.to_grayscale(torch.from_numpy(img), "rgb")[0, 0]) == pytest.approx(29.9)
    assert float(timg.to_grayscale(torch.from_numpy(img), "bgr")[0, 0]) == pytest.approx(11.4)


@pytest.mark.parametrize("radius", [None, 2])
@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.6, 3.0])
def test_gaussian_kernel1d_equals_the_reference(sigma, radius):
    got = timg.gaussian_kernel1d(sigma, radius, device=CPU)
    want = jimg.gaussian_kernel1d(sigma, radius)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(N(got), N(want), rtol=1e-6, atol=0)


def _poses(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = q, rng.uniform(-10, 10, (n, 3))
    return T.astype(np.float32)


# (T_cw shape, X_w shape): one pose over N points; a batch of poses, each
# over its own N points (the pose axis broadcast over the points' as the
# JAX function does: (B, 4, 4) against (B, N, 3) would pair the B rows with
# the N points); one point a pose.
DEPTH_CASES = {
    "one_pose": ((4, 4), (257, 3)),
    "batch_of_poses": ((3, 1, 4, 4), (3, 257, 3)),
    "point_a_pose": ((5, 4, 4), (5, 3)),
}


@pytest.mark.parametrize("case", list(DEPTH_CASES))
def test_depths_in_frame_equals_the_reference(case):
    t_shape, x_shape = DEPTH_CASES[case]
    n = int(np.prod(t_shape[:-2]))
    T = _poses(n, seed=len(case)).reshape(t_shape)
    X = np.random.default_rng(5).uniform(-50, 50, x_shape).astype(np.float32)
    got = ttri.depths_in_frame(torch.from_numpy(T), torch.from_numpy(X))
    want = jtri.depths_in_frame(jnp.asarray(T), jnp.asarray(X))
    assert got.shape == want.shape
    np.testing.assert_allclose(N(got), N(want), rtol=1e-6, atol=1e-5)


# vo_tpu's public names with no counterpart of the same name at the same
# module path in vo_tpu_torch: (module, name) -> where it went, or why not.
# A name None stands for the whole module.
LEFT_OUT = {
    ("ops/pallas_kernels.py", None):
        "the Pallas kernels are CUDA C++ in csrc/, their wrappers in ops/kernels.py",
    ("parallel/mesh.py", "data_sharding"):
        "a jax.sharding placement; a torch rank holds its shard (mesh.local_rows)",
    ("parallel/mesh.py", "replicated"):
        "a jax.sharding placement; replicated fields are broadcast by the mesh",
    ("utils/cache.py", "enable_compilation_cache"):
        "XLA's compile cache on disk; a CUDA graph cannot be written to disk",
    ("data/synthetic.py", "Rects"):
        "a numpy builder of the city: vo_tpu_torch/data/city.py",
    ("data/synthetic.py", "render_frames_accel"):
        "renamed render_frames_torch (vo_tpu_torch/data/synthetic.py)",
}
# Where a left-out name lives in the port instead: (module, name).
MOVED = {
    ("data/synthetic.py", "Rects"): ("data/city.py", "Rects"),
    ("data/synthetic.py", "render_frames_accel"): ("data/synthetic.py", "render_frames_torch"),
}


def _public(path: Path) -> set:
    """Top-level public functions and classes a module defines."""
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _bound(path: Path) -> set:
    """Every name a module binds at its top level: defined, assigned or
    imported (a re-export counts)."""
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return names


def test_every_public_function_of_the_jax_package_has_a_counterpart():
    """Read with ast, so nothing of vo_tpu is imported for it."""
    missing, left_out = [], set()
    for src in sorted((ROOT / "vo_tpu").rglob("*.py")):
        rel = src.relative_to(ROOT / "vo_tpu").as_posix()
        twin = ROOT / "vo_tpu_torch" / rel
        names = _public(src)
        if not twin.exists():
            if (rel, None) in LEFT_OUT:
                left_out.add((rel, None))
            elif names:
                missing.append(f"{rel} (no such module)")
            continue
        have = _bound(twin)
        for name in sorted(names - have):
            if (rel, name) in LEFT_OUT:
                left_out.add((rel, name))
            else:
                missing.append(f"{rel}::{name}")
    assert not missing, f"no counterpart in vo_tpu_torch: {missing}"
    # Every exception is still needed: a name ported since leaves the list.
    assert left_out == set(LEFT_OUT), sorted(set(LEFT_OUT) - left_out)
    for (rel, name), (where, new) in MOVED.items():
        assert new in _bound(ROOT / "vo_tpu_torch" / where), (rel, name, where, new)

"""The procedural city in numpy: path and scene specs, exact ground-truth
paths, facade geometry, mip-mapped textures and the one-frame reference
renderer — the port's own copy of the numpy half of
vo_tpu/data/synthetic.py (tests/test_torch_no_jax.py holds every generator
equal to the reference's for the same spec).

The ray-casting core (`_hit`, `_shade`, ...) takes its array namespace as
`xp`; here it only ever runs with numpy. The device renderer
(data/synthetic.py) re-expresses the same float32 expression trees in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PathSpec:
    """Driven path: a tuple of segments, each ("straight", length_m) or
    ("turn", degrees, radius_m). Sampled at a constant `step_m` per frame;
    beyond the last segment the path extrapolates straight."""

    segments: Tuple[tuple, ...] = (("straight", 50.0),)
    step_m: float = 0.3
    wiggle_amp: float = 0.008  # rad of smooth yaw wiggle (realism; tiny)
    wiggle_wavelength_m: float = 23.0
    # Stop-and-go: ((start_frame, n_frames), ...) — the camera holds its
    # pose for n_frames starting at start_frame (traffic-light stops; the
    # reference's Malaga drive has them). GT stays exact: stopped frames
    # simply repeat the arc-length sample.
    stops: Tuple[Tuple[int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_frames: int = 600
    width: int = 640
    height: int = 480
    focal: float = 415.0
    path: PathSpec = dataclasses.field(default_factory=PathSpec)
    seed: int = 0
    cam_height_m: float = 1.6
    dist: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0)  # k1 k2 p1 p2 k3
    # Photometric nuisance (the reference's documented Malaga failure is
    # lighting-correlated, Report.pdf 3.1.2 — exposure/shadow variation):
    # "constant" (default) or "varying" = per-frame exposure gain/bias random
    # walk + a heading-anchored lateral brightness gradient (sun-facing
    # side of the street brighter; the gradient pans across the image as
    # the camera turns, like real low-sun exposure).
    lighting: str = "constant"

    def K(self) -> np.ndarray:
        return np.array(
            [
                [self.focal, 0.0, self.width / 2.0],
                [0.0, self.focal, self.height / 2.0],
                [0.0, 0.0, 1.0],
            ],
            np.float32,
        )


#: The default full-length sequence rendered by `Sequence("synthetic")` —
#: two opposite quarter-turns (the reference's Malaga failure mode is the
#: first 90-degree turn, Report.pdf 3.1.2) over ~180 m.
DEFAULT_SPEC = SyntheticSpec(
    num_frames=600,
    path=PathSpec(
        segments=(
            ("straight", 50.0),
            ("turn", 90.0, 8.0),
            ("straight", 45.0),
            ("turn", -90.0, 8.0),
            ("straight", 60.0),
        )
    ),
)

#: Closed circuit with a revisit: a rounded rectangle (four same-sign 90-degree
#: turns, opposite straights equal, so the path closes exactly) plus a 40 m
#: tail retracing the first segment — the loop-closure testbed for the
#: pose-graph back-end (models/pose_graph.py). ~350 m, 1169 frames.
LOOP_SPEC = SyntheticSpec(
    num_frames=1169,
    path=PathSpec(
        segments=(
            ("straight", 80.0),
            ("turn", 90.0, 8.0),
            ("straight", 50.0),
            ("turn", 90.0, 8.0),
            ("straight", 80.0),
            ("turn", 90.0, 8.0),
            ("straight", 50.0),
            ("turn", 90.0, 8.0),
            ("straight", 40.0),
        )
    ),
)


# ---------------------------------------------------------------------------
# Path (exact ground truth)
# ---------------------------------------------------------------------------


def _heading_at(path: PathSpec, s: np.ndarray) -> np.ndarray:
    """Yaw (rad) as a function of arc length, piecewise linear over the
    segments; constant beyond the end (straight extrapolation)."""
    theta = np.zeros_like(s, dtype=np.float64)
    s0 = 0.0
    for seg in path.segments:
        if seg[0] == "straight":
            length, dyaw = float(seg[1]), 0.0
        elif seg[0] == "turn":
            deg, radius = float(seg[1]), float(seg[2])
            dyaw = float(np.deg2rad(deg))
            length = abs(dyaw) * radius
        else:  # pragma: no cover - spec error
            raise ValueError(f"unknown segment {seg!r}")
        frac = np.clip((s - s0) / max(length, 1e-9), 0.0, 1.0)
        theta = theta + frac * dyaw
        s0 += length
    if path.wiggle_amp:
        theta = theta + path.wiggle_amp * np.sin(
            2.0 * np.pi * s / path.wiggle_wavelength_m
        )
    return theta


def make_path(path: PathSpec, num_frames: int) -> np.ndarray:
    """(N, 4, 4) float32 camera-to-world poses on the driven path.

    World frame: x right, y DOWN, z forward at frame 0 (matches the image
    convention used across vo_tpu; the ground plane sits at +cam_height).
    Per-frame translation is exactly `step_m` (midpoint-heading
    integration), so speed is constant by construction — the exact-GT
    property every accuracy test leans on."""
    step = path.step_m
    # Frame -> moving-step mapping: a stopped frame advances 0 arc length.
    moving = np.ones(num_frames, dtype=np.float64)
    for start, n in path.stops:
        moving[start:start + n] = 0.0
    steps_done = np.concatenate([[0.0], np.cumsum(moving)])[:num_frames]
    s = steps_done * step
    theta = _heading_at(path, s)
    theta_mid = _heading_at(path, (steps_done + 0.5 * moving) * step)
    dirs = np.stack(
        [np.sin(theta_mid), np.zeros_like(theta_mid), np.cos(theta_mid)], -1
    )
    pos = np.concatenate(
        [np.zeros((1, 3)), np.cumsum(step * moving[:-1, None] * dirs[:-1], axis=0)],
        axis=0,
    )
    c, sn = np.cos(theta), np.sin(theta)
    # Columns: right = (cos, 0, -sin), down = (0, 1, 0), fwd = (sin, 0, cos).
    R = np.zeros((num_frames, 3, 3))
    R[:, 0, 0] = c
    R[:, 2, 0] = -sn
    R[:, 1, 1] = 1.0
    R[:, 0, 2] = sn
    R[:, 2, 2] = c
    poses = np.tile(np.eye(4), (num_frames, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = pos
    return poses.astype(np.float32)


# ---------------------------------------------------------------------------
# City geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Rects:
    """A batch of textured 3D rectangles: point `p0` plus edge vectors
    `e1`, `e2` (the rect is p0 + a*e1 + b*e2, a,b in [0,1]). The LAST rect
    is always the ground plane."""

    p0: np.ndarray  # (R, 3)
    e1: np.ndarray  # (R, 3)
    e2: np.ndarray  # (R, 3)
    uv_off: np.ndarray  # (R, 2) texture-tile offset (decorrelates facades)
    tile_m: np.ndarray  # (R,) meters per texture repeat
    gain: np.ndarray  # (R,) per-rect brightness
    count: int


def build_city(path: PathSpec, seed: int = 0, clearance_m: float = 4.0) -> Rects:
    """Facades with random setbacks along both sides of the path, connector
    walls at setback changes, and a ground plane. Any wall whose ground line
    comes within `clearance_m` of the (extended) driven path is dropped —
    the carve-out that keeps turns drivable (without it the camera would
    clip through the inner corner of every intersection)."""
    rng = np.random.default_rng(seed)
    total_len = 0.0
    for seg in path.segments:
        if seg[0] == "straight":
            total_len += float(seg[1])
        else:
            total_len += abs(np.deg2rad(float(seg[1]))) * float(seg[2])
    # Dense positions along path + 40 m of extrapolation for clearance tests.
    n_dense = int((total_len + 40.0) / path.step_m) + 2
    dense = make_path(path, n_dense)[:, [0, 2], 3].astype(np.float64)  # (N,2) x,z

    seg_len = 4.0
    n_samples = int(np.ceil((total_len + 30.0) / seg_len)) + 1
    fine = make_path(dataclasses.replace(path, step_m=seg_len), n_samples)
    pts = fine[:, :3, 3].astype(np.float64)
    theta = _heading_at(path, np.arange(n_samples, dtype=np.float64) * seg_len)
    right = np.stack([np.cos(theta), np.zeros_like(theta), -np.sin(theta)], -1)

    p0s, e1s, e2s, uvo, tiles, gains = [], [], [], [], [], []

    def add_wall(a: np.ndarray, b: np.ndarray, height: float, tile: float):
        ground = np.array([a[0], 0.0, a[2]])
        e1 = np.array([b[0] - a[0], 0.0, b[2] - a[2]])
        if np.linalg.norm(e1) < 0.5:
            return
        # Clearance: 16 samples of the ground line vs every dense path point.
        line = ground[None, [0, 2]] + np.linspace(0, 1, 16)[:, None] * e1[None, [0, 2]]
        d2 = ((line[:, None, :] - dense[None, :, :]) ** 2).sum(-1)
        if d2.min() < clearance_m**2:
            return
        p0s.append(ground)
        e1s.append(e1)
        e2s.append(np.array([0.0, -height, 0.0]))  # up is -y
        uvo.append(rng.uniform(0.0, 7.0, 2))
        tiles.append(tile)
        gains.append(rng.uniform(0.72, 1.0))

    block = 3  # setback changes every `block` path samples
    for side in (-1.0, 1.0):
        n_blocks = (n_samples - 1) // block + 1
        offs = rng.uniform(4.6, 8.0, n_blocks)
        heights = rng.uniform(3.5, 7.5, n_blocks)
        for j in range(n_samples - 1):
            bj = j // block
            a = pts[j] + side * offs[bj] * right[j]
            b = pts[j + 1] + side * offs[bj] * right[j + 1]
            add_wall(a, b, heights[bj], tile=3.0)
            bj1 = (j + 1) // block
            if bj1 != bj and bj1 < n_blocks:
                c0 = pts[j + 1] + side * offs[bj] * right[j + 1]
                c1 = pts[j + 1] + side * offs[bj1] * right[j + 1]
                add_wall(c0, c1, min(heights[bj], heights[bj1]), tile=3.0)

    # Ground plane last (by contract).
    lo = dense.min(0) - 60.0
    hi = dense.max(0) + 60.0
    p0s.append(np.array([lo[0], 0.0, lo[1]]))
    e1s.append(np.array([hi[0] - lo[0], 0.0, 0.0]))
    e2s.append(np.array([0.0, 0.0, hi[1] - lo[1]]))
    uvo.append(rng.uniform(0.0, 7.0, 2))
    tiles.append(1.7)
    gains.append(0.62)

    return Rects(
        p0=np.asarray(p0s, np.float32),
        e1=np.asarray(e1s, np.float32),
        e2=np.asarray(e2s, np.float32),
        uv_off=np.asarray(uvo, np.float32),
        tile_m=np.asarray(tiles, np.float32),
        gain=np.asarray(gains, np.float32),
        count=len(p0s),
    )


# ---------------------------------------------------------------------------
# Texture (mip-mapped value noise + stamped rects)
# ---------------------------------------------------------------------------


def _value_noise(rng: np.random.Generator, size: int, cells: int) -> np.ndarray:
    """Periodic smoothstep-bilinear value noise: a cells x cells random grid
    upsampled to size x size with wraparound."""
    grid = rng.uniform(0.0, 1.0, (cells, cells)).astype(np.float32)
    t = np.arange(size, dtype=np.float32) * (cells / size)
    i0 = np.floor(t).astype(np.int64) % cells
    i1 = (i0 + 1) % cells
    f = (t - np.floor(t)).astype(np.float32)
    f = f * f * (3.0 - 2.0 * f)
    g00 = grid[np.ix_(i0, i0)]
    g01 = grid[np.ix_(i0, i1)]
    g10 = grid[np.ix_(i1, i0)]
    g11 = grid[np.ix_(i1, i1)]
    fy, fx = f[:, None], f[None, :]
    return (
        g00 * (1 - fy) * (1 - fx)
        + g01 * (1 - fy) * fx
        + g10 * fy * (1 - fx)
        + g11 * fy * fx
    )


def make_texture(seed: int, size: int = 256, levels: int = 4):
    """Tuple of `levels` mip levels (float32, values in ~[25, 230]); level 0
    is size x size, each next level a 2x2 box downsample. Value-noise
    octaves give broadband gradient energy (Harris/KLT need corners
    everywhere); stamped rectangles add window/door-like structure with
    strong edges."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size), np.float32)
    for cells, w in ((6, 1.0), (12, 0.55), (24, 0.3), (48, 0.16), (96, 0.09)):
        img += w * _value_noise(rng, size, cells)
    img = (img - img.min()) / max(float(np.ptp(img)), 1e-6)
    for _ in range(48):  # stamped rects: windows / doors / signs
        w = int(rng.integers(8, 44))
        h = int(rng.integers(8, 44))
        x = int(rng.integers(0, size))
        y = int(rng.integers(0, size))
        val = float(rng.uniform(0.0, 1.0))
        xs = np.arange(x, x + w) % size
        ys = np.arange(y, y + h) % size
        img[np.ix_(ys, xs)] = 0.35 * img[np.ix_(ys, xs)] + 0.65 * val
    img = (25.0 + 205.0 * img).astype(np.float32)
    mips = [img]
    for _ in range(levels - 1):
        m = mips[-1]
        m = 0.25 * (m[0::2, 0::2] + m[0::2, 1::2] + m[1::2, 0::2] + m[1::2, 1::2])
        mips.append(m.astype(np.float32))
    return tuple(mips)


# ---------------------------------------------------------------------------
# Renderer core — ONE implementation, two array namespaces
# ---------------------------------------------------------------------------


def _undistort_normalized(xp, x_d, y_d, dist, iters: int = 8):
    """Fixed-point inverse of the Brown-Conrady model — identical math to
    vo_tpu.geom.camera._distort_normalized so rendered lenses and the
    pipeline's undistortion agree exactly."""
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    x, y = x_d, y_d
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xt = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yt = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x_d - xt) / radial
        y = (y_d - yt) / radial
    return x, y


def _camera_frame_rects(xp, arrays, pose):
    """Transform stacked rect arrays into the camera frame of `pose`
    (componentwise, fixed operation order — both namespaces run the exact
    same float32 expression tree). X_c = R^T (X_w - t); directions rotate
    only."""
    p0, e1, e2, nrm, inv_l1, inv_l2, uv_off, tile, gain = arrays
    R = pose[:3, :3]
    t = pose[:3, 3]

    def rot(v):  # v: (R, 3) -> R^T v
        x = v[:, 0] * R[0, 0] + v[:, 1] * R[1, 0] + v[:, 2] * R[2, 0]
        y = v[:, 0] * R[0, 1] + v[:, 1] * R[1, 1] + v[:, 2] * R[2, 1]
        z = v[:, 0] * R[0, 2] + v[:, 1] * R[1, 2] + v[:, 2] * R[2, 2]
        return xp.stack([x, y, z], axis=-1)

    p0c = rot(p0 - t[None, :])
    return (p0c, rot(e1), rot(e2), rot(nrm), inv_l1, inv_l2, uv_off, tile, gain)


def _rays(xp, K, width, height, dist):
    """Per-pixel camera-frame ray directions (dx, dy, dz=1), through the
    inverse lens when distortion is active. Pixel (ix, iy) maps to image
    coordinate (u=ix, v=iy) — the array-index convention used by the
    detectors and projections across vo_tpu."""
    f32 = xp.float32
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    xs = (xp.arange(width, dtype=f32) - f32(cx)) / f32(fx)
    ys = (xp.arange(height, dtype=f32) - f32(cy)) / f32(fy)
    nx = xp.broadcast_to(xs[None, :], (height, width))
    ny = xp.broadcast_to(ys[:, None], (height, width))
    if any(abs(float(d)) > 0 for d in dist):
        nx, ny = _undistort_normalized(xp, nx, ny, dist)
    return nx, ny, xp.ones_like(nx)


def _hit(xp, dx, dy, dz, rp0, re1, re2, rnrm, ril1, ril2, inf):
    """Ray/rect intersection for ONE rect (camera at the origin): returns
    the ray parameter with misses mapped to +inf. Shared verbatim by the
    numpy loop and a scanned batch renderer."""
    denom = dx * rnrm[0] + dy * rnrm[1] + dz * rnrm[2]
    num = rp0[0] * rnrm[0] + rp0[1] * rnrm[1] + rp0[2] * rnrm[2]
    t = num / xp.where(xp.abs(denom) < 1e-9, xp.float32(1e-9), denom)
    hx = t * dx - rp0[0]
    hy = t * dy - rp0[1]
    hz = t * dz - rp0[2]
    a = (hx * re1[0] + hy * re1[1] + hz * re1[2]) * ril1
    b = (hx * re2[0] + hy * re2[1] + hz * re2[2]) * ril2
    valid = (t > 0.05) & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    return xp.where(valid, t, inf)


def _sample_bilinear(xp, tex, u, v):
    """Bilinear sample of one mip level with wraparound; u/v in texels."""
    size = tex.shape[0]
    u0 = xp.floor(u)
    v0 = xp.floor(v)
    fu = u - u0
    fv = v - v0
    iu0 = u0.astype(xp.int32) % size
    iv0 = v0.astype(xp.int32) % size
    iu1 = (iu0 + 1) % size
    iv1 = (iv0 + 1) % size
    t00 = tex[iv0, iu0]
    t01 = tex[iv0, iu1]
    t10 = tex[iv1, iu0]
    t11 = tex[iv1, iu1]
    return (
        t00 * (1 - fv) * (1 - fu)
        + t01 * (1 - fv) * fu
        + t10 * fv * (1 - fu)
        + t11 * fv * fu
    )


def _shade(xp, arrays, tex, K, t_best, idx_best, dx, dy, dz, inf):
    """Everything after nearest-hit selection: gathered-rect uv recompute,
    trilinear mip sampling, per-rect gain, sky. Shared by both renderers."""
    p0, e1, e2, nrm, inv_l1, inv_l2, uv_off, tile, gain = arrays
    f32 = xp.float32
    fx = float(K[0, 0])

    hit = t_best < inf
    t_h = xp.where(hit, t_best, f32(1.0))
    g_p0 = p0[idx_best]
    g_e1 = e1[idx_best]
    g_e2 = e2[idx_best]
    g_il1 = inv_l1[idx_best]
    g_il2 = inv_l2[idx_best]
    g_nrm = nrm[idx_best]
    hx = t_h * dx - g_p0[..., 0]
    hy = t_h * dy - g_p0[..., 1]
    hz = t_h * dz - g_p0[..., 2]
    a = (hx * g_e1[..., 0] + hy * g_e1[..., 1] + hz * g_e1[..., 2]) * g_il1
    b = (hx * g_e2[..., 0] + hy * g_e2[..., 1] + hz * g_e2[..., 2]) * g_il2

    g_tile = tile[idx_best]
    g_len1 = 1.0 / xp.sqrt(g_il1)  # |e1|  (inv_l1 = 1/|e1|^2)
    g_len2 = 1.0 / xp.sqrt(g_il2)
    u_tiles = a * g_len1 / g_tile + uv_off[idx_best][..., 0]
    v_tiles = b * g_len2 / g_tile + uv_off[idx_best][..., 1]

    # Continuous mip level from the screen-space footprint, boosted at
    # grazing incidence so the ground doesn't alias near the horizon.
    dnorm = xp.sqrt(dx * dx + dy * dy + dz * dz)
    g_nl = xp.sqrt(
        g_nrm[..., 0] * g_nrm[..., 0]
        + g_nrm[..., 1] * g_nrm[..., 1]
        + g_nrm[..., 2] * g_nrm[..., 2]
    )
    cosang = xp.abs(
        dx * g_nrm[..., 0] + dy * g_nrm[..., 1] + dz * g_nrm[..., 2]
    ) / (dnorm * g_nl + f32(1e-9))
    size0 = tex[0].shape[0]
    texel_m = g_tile / f32(size0)
    footprint_m = (t_h * dnorm / f32(fx)) / xp.maximum(cosang, f32(0.25))
    tpp = footprint_m / texel_m
    levels = len(tex)
    lvl = xp.clip(xp.log2(xp.maximum(tpp, f32(1e-6))), f32(0.0), f32(levels - 1))
    val = xp.zeros(t_best.shape, f32)
    for l in range(levels):
        w_l = xp.clip(1.0 - xp.abs(lvl - f32(l)), 0.0, 1.0)
        size_l = tex[l].shape[0]
        s = _sample_bilinear(xp, tex[l], u_tiles * f32(size_l), v_tiles * f32(size_l))
        val = val + w_l * s

    shaded = val * gain[idx_best]
    upness = xp.clip(-dy / dnorm, 0.0, 1.0)  # up = -y
    sky = f32(205.0) + f32(38.0) * upness
    out = xp.where(hit, shaded, sky)
    return xp.clip(xp.rint(out), 0.0, 255.0).astype(xp.uint8)


def _rect_arrays(rects: Rects):
    p0 = rects.p0.astype(np.float32)
    e1 = rects.e1.astype(np.float32)
    e2 = rects.e2.astype(np.float32)
    nrm = np.cross(e1.astype(np.float64), e2.astype(np.float64)).astype(np.float32)
    inv_l1 = (1.0 / (e1.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    inv_l2 = (1.0 / (e2.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    return (
        p0,
        e1,
        e2,
        nrm,
        inv_l1,
        inv_l2,
        rects.uv_off.astype(np.float32),
        rects.tile_m.astype(np.float32),
        rects.gain.astype(np.float32),
    )


def render_frame(rects: Rects, tex, pose, K, width: int, height: int,
                 dist=(0.0,) * 5) -> np.ndarray:
    """Reference renderer: plain numpy, one frame -> (H, W) uint8."""
    width, height = int(width), int(height)
    dist = tuple(float(d) for d in dist)
    arrays = _camera_frame_rects(
        np, _rect_arrays(rects), np.asarray(pose, np.float32)
    )
    dx, dy, dz = _rays(np, np.asarray(K, np.float64), width, height, dist)
    p0, e1, e2, nrm, inv_l1, inv_l2 = arrays[:6]
    inf = np.float32(np.inf)
    t_best = np.full((height, width), inf, np.float32)
    idx_best = np.zeros((height, width), np.int32)
    for i in range(p0.shape[0]):
        t_eff = _hit(
            np, dx, dy, dz, p0[i], e1[i], e2[i], nrm[i],
            inv_l1[i], inv_l2[i], inf,
        )
        upd = t_eff < t_best
        t_best = np.where(upd, t_eff, t_best)
        idx_best = np.where(upd, np.int32(i), idx_best)
    return _shade(np, arrays, tex, np.asarray(K, np.float64),
                  t_best, idx_best, dx, dy, dz, inf)


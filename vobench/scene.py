"""The benchmark's own city: a frozen copy of the port's scene generator
(vo_tpu_torch/data/city.py: specs, exact ground-truth paths, facades,
textures) and of its device renderer (vo_tpu_torch/data/synthetic.py
`render_frames_torch`, `scene`).

The frames are the benchmark's input and the ground truth is its
yardstick, so neither may move when the program changes: a later change
to the port's generator shows as drift in `vobench/tests`, not here.
Edited from the originals only where they import each other.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

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



# ---------------------------------------------------------------------------
# The device renderer
# ---------------------------------------------------------------------------

_INF = float("inf")
# Rects intersected per pass: bounds the (chunk, H, W) temporaries at 640x480.
_RECT_CHUNK = 32


def _camera_frame_rects(arrays, pose: torch.Tensor):
    """Rect arrays in the camera frame of `pose` (X_c = R^T (X_w - t)),
    componentwise in the reference's operation order."""
    p0, e1, e2, nrm, inv_l1, inv_l2, uv_off, tile, gain = arrays
    R = pose[:3, :3]
    t = pose[:3, 3]

    def rot(v):
        x = v[:, 0] * R[0, 0] + v[:, 1] * R[1, 0] + v[:, 2] * R[2, 0]
        y = v[:, 0] * R[0, 1] + v[:, 1] * R[1, 1] + v[:, 2] * R[2, 1]
        z = v[:, 0] * R[0, 2] + v[:, 1] * R[1, 2] + v[:, 2] * R[2, 2]
        return torch.stack([x, y, z], dim=-1)

    return (rot(p0 - t[None, :]), rot(e1), rot(e2), rot(nrm),
            inv_l1, inv_l2, uv_off, tile, gain)


def _rays(K, width: int, height: int, dist, device):
    """Per-pixel camera-frame ray directions (dx, dy, dz=1)."""
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    f32 = torch.float32
    xs = (torch.arange(width, dtype=f32, device=device) - cx) / fx
    ys = (torch.arange(height, dtype=f32, device=device) - cy) / fy
    nx = xs[None, :].expand(height, width)
    ny = ys[:, None].expand(height, width)
    if any(abs(float(d)) > 0 for d in dist):
        nx, ny = _undistort_normalized(None, nx, ny, dist)
    return nx, ny, torch.ones_like(nx)


def _hit(dx, dy, dz, rp0, re1, re2, rnrm, ril1, ril2):
    """Ray/rect intersection for a CHUNK of rects (leading axis C): the ray
    parameter (C, H, W), misses mapped to +inf."""
    def c(v):  # per-rect scalar (C,) -> (C, 1, 1)
        return v[:, None, None]

    denom = dx * c(rnrm[:, 0]) + dy * c(rnrm[:, 1]) + dz * c(rnrm[:, 2])
    num = rp0[:, 0] * rnrm[:, 0] + rp0[:, 1] * rnrm[:, 1] + rp0[:, 2] * rnrm[:, 2]
    t = c(num) / torch.where(denom.abs() < 1e-9, 1e-9, denom)
    hx = t * dx - c(rp0[:, 0])
    hy = t * dy - c(rp0[:, 1])
    hz = t * dz - c(rp0[:, 2])
    a = (hx * c(re1[:, 0]) + hy * c(re1[:, 1]) + hz * c(re1[:, 2])) * c(ril1)
    b = (hx * c(re2[:, 0]) + hy * c(re2[:, 1]) + hz * c(re2[:, 2])) * c(ril2)
    valid = (t > 0.05) & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    return torch.where(valid, t, _INF)


def _sample_bilinear(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of one mip level with wraparound; u/v in texels."""
    size = tex.shape[0]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    iu0 = u0.to(torch.int32) % size
    iv0 = v0.to(torch.int32) % size
    iu1 = ((iu0 + 1) % size).long()
    iv1 = ((iv0 + 1) % size).long()
    iu0, iv0 = iu0.long(), iv0.long()
    return (
        tex[iv0, iu0] * (1 - fv) * (1 - fu)
        + tex[iv0, iu1] * (1 - fv) * fu
        + tex[iv1, iu0] * fv * (1 - fu)
        + tex[iv1, iu1] * fv * fu
    )


def _shade(arrays, tex, K, t_best, idx_best, dx, dy, dz) -> torch.Tensor:
    """Everything after nearest-hit selection: uv recompute on the gathered
    rect, trilinear mip sampling, per-rect gain, sky. -> (H, W) uint8."""
    p0, e1, e2, nrm, inv_l1, inv_l2, uv_off, tile, gain = arrays
    # Python floats act as f32 scalars in torch arithmetic, as np.float32
    # scalars do in the reference.
    fx = float(K[0, 0])

    hit = t_best < _INF
    t_h = torch.where(hit, t_best, 1.0)
    g_p0, g_e1, g_e2 = p0[idx_best], e1[idx_best], e2[idx_best]
    g_il1, g_il2, g_nrm = inv_l1[idx_best], inv_l2[idx_best], nrm[idx_best]
    hx = t_h * dx - g_p0[..., 0]
    hy = t_h * dy - g_p0[..., 1]
    hz = t_h * dz - g_p0[..., 2]
    a = (hx * g_e1[..., 0] + hy * g_e1[..., 1] + hz * g_e1[..., 2]) * g_il1
    b = (hx * g_e2[..., 0] + hy * g_e2[..., 1] + hz * g_e2[..., 2]) * g_il2

    g_tile = tile[idx_best]
    g_len1 = 1.0 / torch.sqrt(g_il1)
    g_len2 = 1.0 / torch.sqrt(g_il2)
    u_tiles = a * g_len1 / g_tile + uv_off[idx_best][..., 0]
    v_tiles = b * g_len2 / g_tile + uv_off[idx_best][..., 1]

    dnorm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    g_nl = torch.sqrt(
        g_nrm[..., 0] * g_nrm[..., 0]
        + g_nrm[..., 1] * g_nrm[..., 1]
        + g_nrm[..., 2] * g_nrm[..., 2]
    )
    cosang = torch.abs(
        dx * g_nrm[..., 0] + dy * g_nrm[..., 1] + dz * g_nrm[..., 2]
    ) / (dnorm * g_nl + 1e-9)
    size0 = tex[0].shape[0]
    texel_m = g_tile / float(size0)
    footprint_m = (t_h * dnorm / fx) / torch.clamp(cosang, min=0.25)
    tpp = footprint_m / texel_m
    levels = len(tex)
    lvl = torch.clamp(torch.log2(torch.clamp(tpp, min=1e-6)), 0.0, levels - 1)
    val = torch.zeros(t_best.shape, dtype=torch.float32, device=t_best.device)
    for lv in range(levels):
        w_l = torch.clamp(1.0 - torch.abs(lvl - lv), 0.0, 1.0)
        size_l = tex[lv].shape[0]
        s = _sample_bilinear(tex[lv], u_tiles * float(size_l), v_tiles * float(size_l))
        val = val + w_l * s

    shaded = val * gain[idx_best]
    upness = torch.clamp(-dy / dnorm, 0.0, 1.0)  # up = -y
    sky = 205.0 + 38.0 * upness
    out = torch.where(hit, shaded, sky)
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def render_frames_torch(rects, tex, poses, K, width: int, height: int,
                        dist=(0.0,) * 5, device=None) -> torch.Tensor:
    """Render poses (N, 4, 4) -> (N, H, W) uint8 on `device`, with the
    reference renderer's ray-casting core."""
    width, height = int(width), int(height)
    dist = tuple(float(d) for d in dist)
    K_np = np.asarray(K, np.float64)
    arrays = tuple(torch.as_tensor(a, device=device) for a in _rect_arrays(rects))
    texd = tuple(torch.as_tensor(np.asarray(t, np.float32), device=device) for t in tex)
    dx, dy, dz = _rays(K_np, width, height, dist, device)
    poses_d = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    n_rect = arrays[0].shape[0]
    out = torch.empty((poses_d.shape[0], height, width), dtype=torch.uint8, device=device)
    for f in range(poses_d.shape[0]):
        cam = _camera_frame_rects(arrays, poses_d[f])
        t_best = torch.full((height, width), _INF, dtype=torch.float32, device=device)
        idx_best = torch.zeros((height, width), dtype=torch.long, device=device)
        for lo in range(0, n_rect, _RECT_CHUNK):
            sl = slice(lo, min(lo + _RECT_CHUNK, n_rect))
            t_eff = _hit(dx, dy, dz, *(a[sl] for a in cam[:6]))
            t_min = t_eff.min(dim=0).values
            i_min = (t_eff == t_min).to(torch.int32).argmax(dim=0) + lo
            upd = t_min < t_best
            t_best = torch.where(upd, t_min, t_best)
            idx_best = torch.where(upd, i_min, idx_best)
        out[f] = _shade(cam, texd, K_np, t_best, idx_best, dx, dy, dz)
    return out


def scene(spec):
    """(rects, texture) of `spec` laid out as the reference's `generate`
    lays them out: camera at cam_height above the ground, texture seed + 1."""
    rects = build_city(spec.path, spec.seed)
    rects = dataclasses.replace(
        rects, p0=rects.p0 + np.array([0.0, spec.cam_height_m, 0.0], np.float32)
    )
    return rects, make_texture(spec.seed + 1)


"""The synthetic city sequence, rendered on the device — port of
`render_frames_accel` of vo_tpu/data/synthetic.py.

The city, texture and path generators and the numpy reference renderer
(`render_frame`) live in data/city.py, the port's own numpy copy. The ray
caster is re-expressed for torch with the same float32 expression trees as
the numpy `_hit`/`_shade` (their namespace shim cannot take torch:
`xp.float32(...)` and `.astype` are numpy-only), so the two renderers agree
to quantization noise. The per-rect hit loop runs over chunks of rects at
once; the nearest hit keeps the reference's tie rule (the lowest rect index
wins).

`render_sequence` applies the varying-lighting model (`_lighting_curves`,
`_apply_lighting`: numpy copies of the reference's; `apply_lighting`: the
same arithmetic on the device). `generate` writes a spec to disk in the
parking layout, as the reference's `generate` does (PNG through
`data/png.py`), so `Sequence("parking", ...)` and the reference's
`--dataset synthetic` read the same render; `_spec_digest` is the
reference's, so each package reuses the other's render.

`multiseq_specs` holds the six lanes of the multi-sequence evaluation and
`DISTORTED_DIST` its distorted-lens lane (run_multiseq.py --full).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from vo_tpu_torch.data.city import (  # noqa: F401  (re-exported)
    DEFAULT_SPEC,
    LOOP_SPEC,
    PathSpec,
    SyntheticSpec,
    _rect_arrays,
    _undistort_normalized,
    build_city,
    make_path,
    make_texture,
    render_frame,
)

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


class RenderedSequence(NamedTuple):
    """A spec rendered on the device (the disk loader is `data.Sequence`)."""

    frames: torch.Tensor  # (N, H, W) f32 grey levels on the device
    K: torch.Tensor  # (3, 3) f32 on the device
    gt_poses: np.ndarray  # (N, 4, 4) f32 exact w_T_c
    spec: SyntheticSpec  # what was rendered


def scene(spec):
    """(rects, texture) of `spec` laid out as the reference's `generate`
    lays them out: camera at cam_height above the ground, texture seed + 1."""
    rects = build_city(spec.path, spec.seed)
    rects = dataclasses.replace(
        rects, p0=rects.p0 + np.array([0.0, spec.cam_height_m, 0.0], np.float32)
    )
    return rects, make_texture(spec.seed + 1)


def render_sequence(spec, device, num_frames: int | None = None) -> RenderedSequence:
    """Render a `SyntheticSpec` on `device`, lit as its `lighting` says;
    with `num_frames`, that many frames of its path instead of
    `spec.num_frames`. A path advances a fixed step a frame, so a shorter
    constant-lighting sequence is the prefix of the longer one (varying
    lighting is drawn for the length rendered); the returned `spec` carries
    that length."""
    if num_frames is not None and num_frames != spec.num_frames:
        spec = dataclasses.replace(spec, num_frames=num_frames)
    rects, tex = scene(spec)
    poses = make_path(spec.path, spec.num_frames)
    K = spec.K()
    frames = render_frames_torch(rects, tex, poses, K, spec.width, spec.height,
                                 dist=spec.dist, device=device)
    if spec.lighting == "varying":
        light = _lighting_curves(spec, poses)
        for i in range(spec.num_frames):
            frames[i] = apply_lighting(frames[i], *(c[i] for c in light))
    elif spec.lighting != "constant":
        raise ValueError(f"unknown lighting {spec.lighting!r}")
    return RenderedSequence(frames=frames.to(torch.float32),
                            K=torch.as_tensor(K, dtype=torch.float32, device=device),
                            gt_poses=poses, spec=spec)


def headline_sequence(device, num_frames: int | None = None) -> RenderedSequence:
    """The 640x480 city sequence of the headline run (DEFAULT_SPEC): 600
    frames, (600, 480, 640) f32 on the device (737 MB). `num_frames` renders
    only the first so many, for a short rehearsal."""
    return render_sequence(DEFAULT_SPEC, device, num_frames)


def loop_sequence(device, num_frames: int | None = None) -> RenderedSequence:
    """The closed circuit with a revisit (LOOP_SPEC), the loop-closure
    testbed: 1,169 frames, (1169, 480, 640) f32 on the device (1.44 GB).
    `num_frames` renders only the first so many."""
    return render_sequence(LOOP_SPEC, device, num_frames)


# ---------------------------------------------------------------------------
# Varying lighting
# ---------------------------------------------------------------------------


def _lighting_curves(spec: SyntheticSpec, poses: np.ndarray):
    """Per-frame (gain, bias, heading) for lighting="varying".

    Deterministic from the spec seed: a smooth exposure random walk
    (low-pass-filtered noise + slow sinusoids, gain ~ [0.8, 1.2], bias
    ~ +-12 grey levels) plus the camera heading used for the sun-facing
    lateral gradient."""
    n = spec.num_frames
    rng = np.random.default_rng(spec.seed + 77)
    t = np.arange(n)
    k = np.hanning(31)
    k /= k.sum()
    gain = (
        1.0
        + 0.14 * np.sin(2 * np.pi * t / 101.0)
        + 0.06 * np.convolve(rng.standard_normal(n), k, mode="same")
    )
    bias = 9.0 * np.sin(2 * np.pi * t / 53.0 + 1.3) + 4.0 * np.convolve(
        rng.standard_normal(n), k, mode="same"
    )
    # Camera forward axis in world = R[:, 2]; heading about +y.
    yaw = np.arctan2(poses[:, 0, 2], poses[:, 2, 2])
    return gain.astype(np.float32), bias.astype(np.float32), yaw


def _apply_lighting(img_u8: np.ndarray, gain: float, bias: float,
                    yaw: float, sun_azimuth: float = 0.9) -> np.ndarray:
    """img' = gain*img + bias + lateral sun gradient, clipped to u8."""
    w = img_u8.shape[1]
    ramp = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :]
    sun = np.sin(yaw - sun_azimuth)
    out = gain * img_u8.astype(np.float32) + bias + 12.0 * sun * ramp
    return np.clip(np.rint(out), 0.0, 255.0).astype(np.uint8)


def apply_lighting(img_u8: torch.Tensor, gain, bias, yaw,
                   sun_azimuth: float = 0.9) -> torch.Tensor:
    """`_apply_lighting` on the device, bit for bit: (H, W) uint8 -> uint8.

    The scalars are the numpy ones of `_lighting_curves` (np.float32 from
    `make_path`'s f32 poses): their products are formed here as numpy forms
    them, in f32, and the image arithmetic runs in f32 in the reference's
    order, `(gain*img + bias) + (12*sun)*ramp`, rounded half to even. (A
    float64 yaw would move numpy to f64 and off this by a grey level.)"""
    sun = np.sin(yaw - sun_azimuth)
    slope = float(12.0 * sun)
    w = img_u8.shape[-1]
    ramp = torch.from_numpy(np.linspace(-1.0, 1.0, w, dtype=np.float32)).to(img_u8.device)
    out = float(gain) * img_u8.to(torch.float32) + float(bias)
    out = out + slope * ramp[None, :]
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# Sequence generation (parking layout) + cache
# ---------------------------------------------------------------------------

_FORMAT_VERSION = 2  # the reference's; bump there and here to invalidate renders


def _spec_digest(spec: SyntheticSpec) -> str:
    # The lighting field (added round 3) must not invalidate pre-existing
    # constant-lighting renders: strip it from the repr at its default.
    r = repr(spec).replace(", lighting='constant'", "")
    return hashlib.sha1(f"v{_FORMAT_VERSION}|{r}".encode()).hexdigest()[:16]


def generate(out_dir: str, spec: SyntheticSpec, verbose: bool = True,
             device="cuda") -> str:
    """Render `spec` on `device` into `out_dir` in the parking layout (K.txt,
    images/img_%05d.png, poses.txt), 16 frames a chunk, each lit on the
    device and written as 8-bit grey PNG. Idempotent: a digest marker makes
    the second call a no-op, so tests and entry points can call it
    unconditionally."""
    from vo_tpu_torch.data import png

    marker = os.path.join(out_dir, ".rendered.json")
    img_dir = os.path.join(out_dir, "images")
    digest = _spec_digest(spec)
    if os.path.exists(marker):
        try:
            with open(marker) as f:
                meta = json.load(f)
            if meta.get("digest") == digest and len(os.listdir(img_dir)) == spec.num_frames:
                return out_dir
        except Exception:
            pass

    os.makedirs(img_dir, exist_ok=True)
    rects, tex = scene(spec)
    poses = make_path(spec.path, spec.num_frames)
    K = spec.K()

    if verbose:
        print(
            f"[synthetic] rendering {spec.num_frames} frames "
            f"{spec.width}x{spec.height}, {rects.count} rects -> {out_dir}"
        )
    light = (
        _lighting_curves(spec, poses) if spec.lighting == "varying" else None
    )
    chunk = 16
    for lo in range(0, spec.num_frames, chunk):
        hi = min(lo + chunk, spec.num_frames)
        frames = render_frames_torch(
            rects, tex, poses[lo:hi], K, spec.width, spec.height, dist=spec.dist,
            device=device,
        )
        for i in range(lo, hi):
            frame = frames[i - lo]
            if light is not None:
                gain, bias, yaw = light
                frame = apply_lighting(frame, gain[i], bias[i], yaw[i])
            png.write_png(os.path.join(img_dir, f"img_{i:05d}.png"), frame.cpu().numpy())
        if verbose and (lo // chunk) % 8 == 0:
            print(f"[synthetic] {hi}/{spec.num_frames}")

    with open(os.path.join(out_dir, "K.txt"), "w") as f:
        for r in range(3):
            f.write(" ".join(f"{K[r, c]:.9g}" for c in range(3)) + "\n")
    with open(os.path.join(out_dir, "poses.txt"), "w") as f:
        for P in poses.astype(np.float64):
            f.write(" ".join(f"{v:.9e}" for v in P[:3, :4].reshape(-1)) + "\n")
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump({"spec": repr(spec), "digest": digest}, f, indent=1)
    with open(marker, "w") as f:
        json.dump({"digest": digest, "frames": spec.num_frames}, f)
    return out_dir


def ensure_synthetic(root: str, spec: SyntheticSpec = DEFAULT_SPEC, device="cuda") -> str:
    """Return `<root>/synthetic`, generating the default full-length city
    sequence on `device` on first use. An existing completed render (any
    spec — e.g. a tiny one placed there by a test, or one written by the
    reference's `generate`) is reused as-is."""
    base = os.path.join(root, "synthetic")
    marker = os.path.join(base, ".rendered.json")
    img_dir = os.path.join(base, "images")
    if os.path.exists(marker):
        try:
            with open(marker) as f:
                meta = json.load(f)
            if len(os.listdir(img_dir)) == int(meta.get("frames", -1)):
                return base
        except Exception:
            pass
    return generate(base, spec, verbose=True, device=device)


# ---------------------------------------------------------------------------
# The multi-sequence evaluation set (run_multiseq.py --full)
# ---------------------------------------------------------------------------

#: Lanes that run the motion/covisibility-gated keyframe policy; the
#: constant-speed lanes keep the fixed cadence.
ADAPTIVE_LANES = frozenset({"stopgo", "tight"})

#: Brown-Conrady (k1, k2, p1, p2, k3) of the distorted-lens lane. Distortion
#: is static in the config, so this lane runs on its own, not in the batch.
DISTORTED_DIST = (-0.28, 0.08, 0.0005, -0.0005, 0.0)


def multiseq_specs(frames: int = 600) -> dict:
    """Six distinct full-length drives over six distinct procedural cities
    (the seed varies the scene AND the path noise), by lane name."""
    def spec(seed, segments, stops=()):
        return dataclasses.replace(
            DEFAULT_SPEC, num_frames=frames, seed=seed,
            path=PathSpec(segments=segments, stops=stops),
        )

    return {
        "city_lr": spec(0, (("straight", 50.0), ("turn", 90.0, 8.0),
                            ("straight", 45.0), ("turn", -90.0, 8.0),
                            ("straight", 60.0))),
        "city_rl": spec(1, (("straight", 40.0), ("turn", -90.0, 9.0),
                            ("straight", 55.0), ("turn", 90.0, 7.0),
                            ("straight", 55.0))),
        "scurve": spec(2, (("straight", 30.0), ("turn", 45.0, 20.0),
                           ("turn", -45.0, 20.0), ("straight", 30.0),
                           ("turn", -45.0, 20.0), ("turn", 45.0, 20.0),
                           ("straight", 25.0))),
        "stopgo": spec(3, (("straight", 40.0), ("turn", 90.0, 8.0),
                           ("straight", 35.0), ("turn", -90.0, 8.0),
                           ("straight", 30.0)),
                       stops=((70, 45), (240, 45))),
        "tight": spec(4, (("straight", 35.0), ("turn", 90.0, 6.0),
                          ("straight", 30.0), ("turn", 90.0, 6.0),
                          ("straight", 35.0), ("turn", 90.0, 6.0),
                          ("straight", 30.0))),
        "longrun": spec(5, (("straight", 90.0), ("turn", -60.0, 15.0),
                            ("straight", 70.0))),
    }


def distorted_spec(frames: int = 600) -> SyntheticSpec:
    """The distorted-lens lane: the `city_lr` drive in another city, seen
    through the `DISTORTED_DIST` lens."""
    return dataclasses.replace(
        multiseq_specs(frames)["city_lr"], seed=6, dist=DISTORTED_DIST)


def select_lanes(names, lanes) -> list:
    """The lane names a `--full-lanes` value picks: a count ("3", 0 or empty
    = all), or a comma-separated list of names."""
    names = list(names)
    lanes = "" if lanes is None else str(lanes).strip()
    if not lanes:
        return names
    if lanes.isdigit():
        return names[: int(lanes)] if int(lanes) > 0 else names
    want = [w.strip() for w in lanes.split(",") if w.strip()]
    unknown = [w for w in want if w not in names]
    if unknown:
        raise ValueError(f"unknown lanes {unknown}; have {names}")
    return want


def multiseq_sequences(device, frames: int = 600, lanes=None) -> dict:
    """The lanes of the multi-sequence evaluation rendered on `device`, lane
    by lane: name -> RenderedSequence, each (frames, 480, 640) f32 (737 MB a lane at
    600 frames, 4.4 GB for all six). `lanes` as `select_lanes` takes it."""
    specs = multiseq_specs(frames)
    return {name: render_sequence(specs[name], device)
            for name in select_lanes(specs, lanes)}

"""The port's data layer on the CPU, held against the JAX package on the same
inputs: the varying-lighting model, png.py against PIL, `generate` and its
digest, the kitti / malaga / parking loaders, the native frame loader and its
decode-ahead ring, and the dataset lanes of run_multiseq_torch.py."""

import dataclasses
import filecmp
import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from vo_tpu.data import loaders as jload
from vo_tpu.data import native_loader as jnl
from vo_tpu.data import synthetic as jsyn
from vo_tpu_torch.data import loaders as tload
from vo_tpu_torch.data import native_loader as tnl
from vo_tpu_torch.data import png
from vo_tpu_torch.data import synthetic as tsyn

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent

# A small city: 160x120 (focal 104), the default drive; and a tiny one for
# the renders that both packages make (the lighting curves need at least 31
# frames, in the reference too).
SMALL = dict(width=160, height=120, focal=104.0)
TINY = dict(width=80, height=60, focal=52.0)

needs_native = pytest.mark.skipif(
    not tnl.available(), reason=f"native loader not built: {tnl.build_error()}")


def _pil_gray(path):
    return np.asarray(Image.open(path).convert("L"), dtype=np.float32)


# ---------------------------------------------------------------------------
# Varying lighting
# ---------------------------------------------------------------------------

LIGHT_SPECS = {
    "default": dataclasses.replace(jsyn.DEFAULT_SPEC, lighting="varying"),
    "loop_head": dataclasses.replace(jsyn.LOOP_SPEC, lighting="varying", num_frames=97),
}


@pytest.mark.parametrize("name", list(LIGHT_SPECS))
def test_lighting_copies_equal_the_reference(name):
    """`_lighting_curves` and `_apply_lighting` of the port are the
    reference's, bit for bit (exact: both are numpy on the same inputs)."""
    spec = LIGHT_SPECS[name]
    tspec = dataclasses.replace(tsyn.DEFAULT_SPEC if name == "default" else tsyn.LOOP_SPEC,
                                lighting="varying", num_frames=spec.num_frames)
    poses = jsyn.make_path(spec.path, spec.num_frames)
    want = jsyn._lighting_curves(spec, poses)
    got = tsyn._lighting_curves(tspec, tsyn.make_path(tspec.path, tspec.num_frames))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (24, 640), dtype=np.uint8)
    for i in (0, spec.num_frames // 2, spec.num_frames - 1):
        np.testing.assert_array_equal(
            tsyn._apply_lighting(img, *(c[i] for c in got)),
            jsyn._apply_lighting(img, *(c[i] for c in want)))
    # A copied fault of the reference: under 31 frames the 31-tap smoothing
    # makes curves longer than the sequence, and both raise.
    for mod, sp in ((jsyn, spec), (tsyn, tspec)):
        short = dataclasses.replace(sp, num_frames=6)
        with pytest.raises(ValueError, match="broadcast"):
            mod._lighting_curves(short, mod.make_path(short.path, 6))


def test_apply_lighting_on_the_device_equals_numpy():
    """The torch `apply_lighting` against the numpy `_apply_lighting` on
    `generate`'s own f32 inputs, every frame of the 600-frame city, a
    640-wide image: bit-equal (tolerance 0)."""
    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, lighting="varying")
    gain, bias, yaw = tsyn._lighting_curves(spec, tsyn.make_path(spec.path, spec.num_frames))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 640), dtype=np.uint8)
    img[0, :] = 0
    img[1, :] = 255
    timg = torch.from_numpy(img)
    for i in range(spec.num_frames):
        want = tsyn._apply_lighting(img, gain[i], bias[i], yaw[i])
        got = tsyn.apply_lighting(timg, gain[i], bias[i], yaw[i])
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"frame {i}")


def test_render_sequence_varying_is_within_3_grey_levels_of_the_reference(tmp_path):
    """The device render of a varying-lighting spec against the JAX
    `generate`'s PNGs: within 3 grey levels (the renderer's own bound of 2
    times a gain <= 1.3, plus rounding); GT poses and K as written."""
    n = 32
    spec = dataclasses.replace(jsyn.DEFAULT_SPEC, num_frames=n, lighting="varying", **TINY)
    tspec = dataclasses.replace(tsyn.DEFAULT_SPEC, num_frames=n, lighting="varying", **TINY)
    out = jsyn.generate(str(tmp_path), spec, verbose=False)
    ref = np.stack([_pil_gray(f"{out}/images/img_{i:05d}.png") for i in range(n)])
    seq = tsyn.render_sequence(tspec, torch.device("cpu"))
    got = seq.frames.numpy()
    assert got.shape == ref.shape == (n, 60, 80)
    assert np.abs(got - ref).max() <= 3
    # The lighting really varies: the frames differ from the constant render.
    flat = tsyn.render_sequence(dataclasses.replace(tspec, lighting="constant"),
                                torch.device("cpu"), 8).frames.numpy()
    assert np.abs(got[:8] - flat).mean() > 1.0
    np.testing.assert_allclose(seq.gt_poses[:, :3, :4],
                               np.loadtxt(f"{out}/poses.txt").reshape(n, 3, 4), atol=1e-6)
    with pytest.raises(ValueError, match="lighting"):
        tsyn.render_sequence(dataclasses.replace(tspec, lighting="dusk"), torch.device("cpu"))


# ---------------------------------------------------------------------------
# png.py
# ---------------------------------------------------------------------------

def _encode(raw_rows: np.ndarray, w: int, h: int, depth: int, color: int, filt: int,
            bpp: int, plte: bytes | None = None, interlace: int = 0) -> bytes:
    """A PNG of the given rows, every row filtered with `filt` (0-4)."""
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = raw_rows.astype(np.int64)
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        line = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if filt == 0:
            f = line
        elif filt == 1:
            f = line - left
        elif filt == 2:
            f = line - prior
        elif filt == 3:
            f = line - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
            f = line - pred
        out.append(bytes([filt]) + (f % 256).astype(np.uint8).tobytes())
        prior = line
    blob = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        blob += chunk(b"PLTE", plte)
    return blob + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b"")


# (PIL mode, PNG colour type, samples a pixel)
MODES = [("L", 0, 1), ("LA", 4, 2), ("RGB", 2, 3), ("RGBA", 6, 4), ("P", 3, 1)]


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("mode,color,ch", MODES, ids=[m[0] for m in MODES])
def test_png_reads_what_pil_reads(tmp_path, mode, color, ch, filt):
    """Every colour type with every row filter: png.read_gray equals PIL's
    convert("L") exactly (tolerance 0)."""
    rng = np.random.default_rng(10 * color + filt)
    h, w = 13, 21
    img = rng.integers(0, 256, (h, w * ch), dtype=np.uint8)
    plte = None
    if mode == "P":
        img = rng.integers(0, 40, (h, w), dtype=np.uint8)
        plte = rng.integers(0, 256, (40, 3), dtype=np.uint8).tobytes()
    img[:, :ch] = 39 if mode == "P" else 255  # a wrap in every filter
    path = tmp_path / "x.png"
    path.write_bytes(_encode(img, w, h, 8, color, filt, ch, plte))
    assert Image.open(path).mode == mode
    got = png.read_gray(str(path))
    assert got.dtype == np.float32 and got.shape == (h, w)
    np.testing.assert_array_equal(got, _pil_gray(path))


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("color", [0, 3])
def test_png_reads_packed_grey_and_palette(tmp_path, depth, color):
    rng = np.random.default_rng(depth)
    h, w = 7, 19
    vals = rng.integers(0, 1 << depth, (h, w), dtype=np.uint8)
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = vals
    packed = np.zeros((h, padded.shape[1] // per), np.uint8)
    for k in range(per):
        packed |= padded[:, k::per] << (8 - depth * (k + 1))
    plte = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8).tobytes() if color else None
    path = tmp_path / "p.png"
    path.write_bytes(_encode(packed, w, h, depth, color, 4, 1, plte))
    np.testing.assert_array_equal(png.read_gray(str(path)), _pil_gray(path))


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3)])
def test_png_writes_what_pil_reads(tmp_path, shape):
    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    if len(shape) == 2:
        np.testing.assert_array_equal(png.read_gray(path), img.astype(np.float32))
    with pytest.raises(ValueError):
        png.write_png(path, img.astype(np.float32))


def test_png_declines_16_bit_and_interlaced(tmp_path):
    p16 = tmp_path / "s.png"
    Image.fromarray(np.arange(120, dtype=np.uint16).reshape(10, 12) * 500).save(p16)
    with pytest.raises(IOError, match="16-bit"):
        png.read_gray(str(p16))
    pil = tmp_path / "i.png"
    rows = np.random.default_rng(1).integers(0, 256, (8, 8), dtype=np.uint8)
    pil.write_bytes(_encode(rows, 8, 8, 8, 0, 0, 1, interlace=1))
    with pytest.raises(IOError, match="interlaced"):
        png.read_gray(str(pil))
    bad = tmp_path / "b.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(IOError):
        png.read_gray(str(bad))


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

GEN_SPEC = dict(num_frames=5, **TINY)


@pytest.mark.parametrize("lighting", ["constant", "varying"])
def test_generate_writes_the_reference_layout(tmp_path, lighting):
    """Same digest, K.txt and poses.txt textually equal, spec.json and the
    marker alike, frames within the renderer's bound (3 grey levels lit, 2
    not) and equal to the device render; a second call is a no-op."""
    n = 32 if lighting == "varying" else 5
    jspec = dataclasses.replace(jsyn.DEFAULT_SPEC, lighting=lighting, **{**GEN_SPEC,
                                                                          "num_frames": n})
    tspec = dataclasses.replace(tsyn.DEFAULT_SPEC, lighting=lighting, **{**GEN_SPEC,
                                                                          "num_frames": n})
    assert tsyn._spec_digest(tspec) == jsyn._spec_digest(jspec)
    assert tsyn._FORMAT_VERSION == jsyn._FORMAT_VERSION
    jdir = jsyn.generate(str(tmp_path / "j"), jspec, verbose=False)
    tdir = tsyn.generate(str(tmp_path / "t"), tspec, verbose=False, device="cpu")
    for name in ("K.txt", "poses.txt", "spec.json", ".rendered.json"):
        assert filecmp.cmp(f"{jdir}/{name}", f"{tdir}/{name}", shallow=False), name
    names = sorted(os.listdir(f"{tdir}/images"))
    assert names == sorted(os.listdir(f"{jdir}/images")) == [f"img_{i:05d}.png"
                                                             for i in range(n)]
    for n in names:
        a, b = _pil_gray(f"{tdir}/images/{n}"), _pil_gray(f"{jdir}/images/{n}")
        assert np.abs(a - b).max() <= (3 if lighting == "varying" else 2)
    # The frames are the device render, written losslessly.
    seq = tsyn.render_sequence(tspec, torch.device("cpu"))
    np.testing.assert_array_equal(
        np.stack([png.read_gray(f"{tdir}/images/{n}") for n in names]), seq.frames.numpy())
    stamp = os.stat(f"{tdir}/images/{names[0]}").st_mtime_ns
    assert tsyn.generate(tdir, tspec, verbose=False, device="cpu") == tdir
    assert os.stat(f"{tdir}/images/{names[0]}").st_mtime_ns == stamp


def test_ensure_synthetic_reuses_a_render(tmp_path, capsys):
    """A completed render under <root>/synthetic (any spec, here the JAX
    package's) is reused as is, and Sequence("synthetic") reads it."""
    jspec = dataclasses.replace(jsyn.DEFAULT_SPEC, **GEN_SPEC)
    jsyn.generate(str(tmp_path / "synthetic"), jspec, verbose=False)
    assert tsyn.ensure_synthetic(str(tmp_path), device="cpu") == str(tmp_path / "synthetic")
    seq = tload.Sequence("synthetic", path=str(tmp_path), render_device="cpu")
    ref = jload.Sequence("synthetic", path=str(tmp_path))
    assert len(seq) == len(ref) == 5 and seq.frames == ref.frames
    np.testing.assert_array_equal(seq.K, ref.K)
    np.testing.assert_array_equal(seq.gt_poses, ref.gt_poses)
    assert "[synthetic] rendering" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The loaders: kitti, malaga, parking, written here and read by both packages
# ---------------------------------------------------------------------------

def _frames(rng, n, h=24, w=36):
    return [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(n)]


def _poses_txt(rng, n):
    return "\n".join(" ".join(f"{v:.9e}" for v in rng.normal(size=12)) for _ in range(n)) + "\n"


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """A data root with a KITTI tree (calib P0..P3, 6 frames a camera, GT), a
    Malaga tree (JPEG pairs, the three ini variants with // comments) and a
    parking tree (comma-separated K.txt, 5 frames, GT)."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(2023)
    kitti = root / "kitti" / "05"
    for cam in (0, 1):
        (kitti / f"image_{cam}").mkdir(parents=True)
        for i, img in enumerate(_frames(rng, 6)):
            Image.fromarray(img).save(kitti / f"image_{cam}" / f"{i:06d}.png")
    lines = []
    for cam in range(4):
        P = np.array([[718.856 + cam, 0, 607.1928, -386.1448 * cam],
                      [0, 718.856 + cam, 185.2157, 0], [0, 0, 1, 0]])
        lines.append(f"P{cam}: " + " ".join(f"{v:.12e}" for v in P.reshape(-1)))
    (kitti / "calib.txt").write_text("\n".join(lines) + "\n")
    (root / "kitti" / "poses").mkdir()
    (root / "kitti" / "poses" / "05.txt").write_text(_poses_txt(rng, 6))

    malaga = root / "malaga" / "malaga-urban-dataset-extract-07"
    (malaga / "Images").mkdir(parents=True)
    for i, img in enumerate(_frames(rng, 4)):
        for side in ("left", "right"):
            Image.fromarray(img).save(
                malaga / "Images" / f"img_CAMERA1_126{i:04d}.000_{side}.jpg", quality=92)
    (malaga / "camera_params_raw_1024x768.txt").write_text(
        "[CAMERA_PARAMS_LEFT]\nresolution=[1024 768]\ncx=511.5 // centre\ncy=383.5\n"
        "fx=923.5295 // focal x\nfy=922.2418\n\n[CAMERA_PARAMS_RIGHT]\ncx=512.5\ncy=382.5\n"
        "fx=911.3657\nfy=909.3910\n")
    (malaga / "camera_params_rectified_a=0_1024x768.txt").write_text(
        "[CAMERA_LEFT]\ncx=512.0 //c\ncy=384.0\nfx=795.11588\nfy=795.11588 // f\n"
        "[CAMERA_RIGHT]\ncx=512.0\ncy=384.0\nfx=795.11588\nfy=795.11588\n")
    (malaga / "camera_params_rectified_a=0_800x600.txt").write_text(
        "[CAMERA_LEFT]\ncx=400.0\ncy=300.0\nfx=621.18428 // lowres\nfy=621.18428\n")

    parking = root / "parking"
    (parking / "images").mkdir(parents=True)
    for i, img in enumerate(_frames(rng, 5)):
        png.write_png(str(parking / "images" / f"img_{i:05d}.png"), img)
    (parking / "K.txt").write_text("331.37, 0, 320,\n0, 369.568, 240,\n0, 0, 1\n")
    (parking / "poses.txt").write_text(_poses_txt(rng, 5))
    return root


LOADER_CASES = {
    "kitti": dict(dataset="kitti"),
    "kitti_cam1_every2": dict(dataset="kitti", camera=1, increment=2),
    "malaga_rectified": dict(dataset="malaga"),
    "malaga_raw_right": dict(dataset="malaga", rectified=False, camera=1),
    "malaga_lowres": dict(dataset="malaga", use_lowres=True),
    "parking": dict(dataset="parking"),
    "parking_every2": dict(dataset="parking", increment=2),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loaders_read_what_the_reference_reads(layouts, case):
    """K, the frame list, GT poses and every frame bit-equal to the JAX
    package's Sequence (JPEG: both packages' libjpeg, exact)."""
    kw = LOADER_CASES[case]
    a = tload.Sequence(path=str(layouts), **kw)
    b = jload.Sequence(path=str(layouts), **kw)
    assert len(a) == len(b) > 0 and a.frames == b.frames
    assert a.K.dtype == np.float32
    np.testing.assert_array_equal(a.K, b.K)
    if b.gt_poses is None:
        assert a.gt_poses is None
    else:
        np.testing.assert_array_equal(a.gt_poses, b.gt_poses)
    got = [a.get_frame(i) for i in range(len(a))]
    for i, img in enumerate(got):
        np.testing.assert_array_equal(img, b.get_frame(i))
    assert a.decoder in ("native", "png", "pil")
    assert [x.shape for x in a] == [x.shape for x in got]  # the iterator


def test_loaders_refuse_what_is_not_there(layouts, tmp_path):
    with pytest.raises(ValueError, match="unknown dataset"):
        tload.Sequence("tum", path=str(layouts))
    with pytest.raises(FileNotFoundError):
        tload.Sequence("kitti", path=str(layouts), kitti_sequence="07")
    with pytest.raises(ValueError, match="no P3 line"):
        (tmp_path / "kitti" / "05" / "image_3").mkdir(parents=True)
        (tmp_path / "kitti" / "05" / "calib.txt").write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\n")
        tload.Sequence("kitti", path=str(tmp_path), camera=3)
    with pytest.raises(FileNotFoundError, match="no frames"):
        tload.Sequence("kitti", path=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="intrinsics"):
        tload.Sequence("malaga", path=str(tmp_path))
    with pytest.raises(KeyError, match="CAMERA_RIGHT"):
        tload.Sequence("malaga", path=str(layouts), use_lowres=True, camera=1)
    with pytest.raises(FileNotFoundError):
        tload.Sequence("parking", path=str(tmp_path))


def test_decoders_agree(layouts, monkeypatch):
    """native, png.py and PIL give the same frame (PNG exact); without the
    native library the loader falls to png.py for PNG and PIL for JPEG, and
    with neither PIL nor a native library a JPEG raises and says so."""
    parking = tload.Sequence("parking", path=str(layouts))
    kitti = tload.Sequence("kitti", path=str(layouts))
    malaga = tload.Sequence("malaga", path=str(layouts))
    for path in parking.frames + kitti.frames[:2]:
        np.testing.assert_array_equal(png.read_gray(path), _pil_gray(path))
        if tnl.available():
            np.testing.assert_array_equal(tnl.decode_gray(path), _pil_gray(path))
    monkeypatch.setattr(tnl, "available", lambda: False)
    assert tload._imread_gray(parking.frames[0])[1] == "png"
    img, name = tload._imread_gray(malaga.frames[0])
    assert name == "pil"
    np.testing.assert_array_equal(img, _pil_gray(malaga.frames[0]))
    with parking.prefetch(start=2) as ring:
        np.testing.assert_array_equal(ring.get(0), parking.get_frame(2))
    assert parking.decoder == "png"
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(IOError, match="PIL: not installed"):
        tload._imread_gray(malaga.frames[0])
    assert tload._imread_gray(parking.frames[0])[1] == "png"


# ---------------------------------------------------------------------------
# The native frame loader
# ---------------------------------------------------------------------------

def test_frame_loader_source_is_the_reference_source():
    assert (ROOT / "vo_tpu_torch" / "csrc" / "frame_loader.cc").read_bytes() == (
        ROOT / "native" / "frame_loader.cc").read_bytes()
    assert tnl.build_dir().parent == ROOT / "vo_tpu_torch" / "build"


@needs_native
def test_native_loader_decodes_what_the_reference_decodes(tmp_path):
    """Grey and RGB PNG exact against the JAX native loader and PIL; JPEG
    within 1 grey level of PIL (tests/test_native_loader.py's bound)."""
    rng = np.random.default_rng(7)
    grey, rgb = (rng.integers(0, 256, s, dtype=np.uint8) for s in ((40, 56), (40, 56, 3)))
    for name, img, kw in (("g.png", grey, {}), ("c.png", rgb, {}),
                          ("j.jpg", grey, {"quality": 95})):
        path = str(tmp_path / name)
        Image.fromarray(img).save(path, **kw)
        got = tnl.decode_gray(path)
        assert got.dtype == np.float32 and tnl.image_size(path) == (40, 56)
        if name.endswith(".png"):
            np.testing.assert_array_equal(got, _pil_gray(path))
            if jnl.available():
                np.testing.assert_array_equal(got, jnl.decode_gray(path))
        else:
            assert np.abs(got - _pil_gray(path)).max() <= 1.0
    with pytest.raises(IOError):
        tnl.decode_gray(str(tmp_path / "missing.png"), hw=(4, 4))


@needs_native
def test_prefetcher_yields_get_frame_in_order(layouts):
    seq = tload.Sequence("kitti", path=str(layouts))
    with seq.prefetch(n_threads=3, ring=2, start=1) as ring:
        assert isinstance(ring, tnl.FramePrefetcher) and seq.decoder == "native"
        assert ring.n == len(seq) - 1
        buf = np.empty((ring.h, ring.w), np.float32)
        for i in range(ring.n):
            got = ring.get(i, out=buf) if i % 2 else ring.get(i)
            np.testing.assert_array_equal(got, seq.get_frame(i + 1))
        with pytest.raises(ValueError, match="sequential"):
            ring.get(0)
    with seq.prefetch(ring=2) as ring:
        with pytest.raises(ValueError, match="sequential"):
            ring.get(1)
        with pytest.raises(ValueError, match="contiguous"):
            ring.get(0, out=np.empty((3, 3), np.float32))


# ---------------------------------------------------------------------------
# run_multiseq_torch.py: the dataset lanes and --sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def city_layout(tmp_path_factory):
    """The first 14 frames of the default city at 160x120 in the parking
    layout, written by the port's `generate`."""
    root = tmp_path_factory.mktemp("city")
    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, num_frames=14, **SMALL)
    tsyn.generate(str(root / "parking"), spec, verbose=False, device="cpu")
    return root


def test_dataset_lanes_equal_their_single_runs_and_the_reference(city_layout, capsys):
    """Two lanes, 8 steps: each lane's poses equal that lane's single run
    (bootstrap with seed 2023 + lane, then vo_rollout over the lane's frame
    plan) bit for bit; the JSON line has the reference's keys; and each
    lane's ATE is within 0.05 m + 50% of run_multiseq.py's on the same
    layout (other RANSAC draws, other rounding: the lanes agree on a track,
    not on a bit)."""
    import run_multiseq
    import run_multiseq_torch as runner

    from vo_tpu_torch.models.pipeline import bootstrap, vo_rollout
    from vo_tpu_torch.parallel.multihost import frame_plan
    from vo_tpu_torch.utils.config import VOConfig

    cap = 128
    argv = ["--dataset", "parking", "--data-root", str(city_layout), "--sequences", "a,b",
            "--steps", "8", "--capacity", str(cap)]
    args = runner.parse_args(argv + ["--device", "cpu"])
    cfg = VOConfig(capacity=cap)
    cpu = torch.device("cpu")
    fps, ates, boot, poses = runner.run_batch(args, ["a", "b"], cfg, cpu)
    assert fps > 0 and poses.shape == (8, 2, 4, 4) and np.isfinite(poses).all()
    seq = tload.Sequence("parking", path=str(city_layout))
    frames = torch.stack([torch.from_numpy(seq.get_frame(i)) for i in range(len(seq))])
    plan = frame_plan(len(seq), 8)
    assert plan == list(range(3, 11))
    K = torch.from_numpy(seq.K)
    for lane in range(2):
        st, out0 = bootstrap(frames[0], frames[2], K, cfg,
                             torch.Generator().manual_seed(2023 + lane))
        _, outs = vo_rollout(st, frames[plan], K, cfg)
        np.testing.assert_array_equal(boot[lane], out0.pose.numpy())
        np.testing.assert_array_equal(poses[:, lane], outs.pose.numpy())

    assert runner.main(argv + ["--device", "cpu"]) == 0
    mine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert run_multiseq.main(argv + ["--platform", "cpu"]) is None
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # The JAX package's keys, and what the rollouts ran (eager on the CPU).
    assert set(mine) == set(ref) | {"executor", "graphs"}
    assert mine["metric"] == "multiseq_throughput"
    assert mine["graphs"] is None  # the CPU runs eagerly: no runner
    assert mine["executor"] == "eager"
    assert mine["batch"] == 2 and mine["ate_rmse_m"] == ates
    for got, want in zip(mine["ate_rmse_m"], ref["ate_rmse_m"]):
        assert abs(got - want) <= 0.05 + 0.5 * want, (mine, ref)


def test_sweep_prints_the_scaling_table(city_layout, capsys):
    import run_multiseq_torch as runner

    rc = runner.main(["--dataset", "parking", "--data-root", str(city_layout), "--sweep", "1,2",
                      "--steps", "3", "--capacity", "128", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [r["batch"] for r in lines[:2]] == [1, 2] and lines[0]["scaling"] == 1.0
    assert all(r["executor"] == "eager" for r in lines[:2])  # the CPU runs eagerly
    assert lines[-1] == {"metric": "multiseq_scaling", "rows": lines[:2], "executor": "eager",
                         "graphs": None}

"""Dataset loaders: KITTI odometry, Malaga urban, "parking" — port of
vo_tpu/data/loaders.py, field for field.

The same layouts and calibration parsing (KITTI calib.txt P-line; Malaga's
camera-params ini with its raw/rectified/lowres variants and `//` comments;
parking K.txt), ground-truth poses where the layout has them, lazy per-frame
decode, the iterator protocol and a decode-ahead `prefetch`. Frames are f32
grey numpy arrays on the host; the entry points move them to the card.

Decoders, in order: the native loader (csrc/frame_loader.cc, libpng and
libjpeg, built at first use); for PNG then data/png.py; PIL where it can be
imported. All give the same values for 8-bit input (JPEG within 1 grey level
between libjpeg builds). `Sequence.decoder` says which one served the
frames; a file that none can decode raises and names what is missing.
"""

from __future__ import annotations

import configparser
import os
from dataclasses import dataclass, field
from glob import glob

import numpy as np

from vo_tpu_torch.data import native_loader, png


def _imread_gray_pil(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), dtype=np.float32)


def _imread_gray(path: str) -> tuple[np.ndarray, str]:
    """Decode one frame to f32 grey; returns (image, the decoder used).
    Formats the native loader declines (16-bit PNG, where libpng and PIL
    narrow differently) go on to the next decoder."""
    tried = []
    if native_loader.available():
        try:
            return native_loader.decode_gray(path), "native"
        except IOError as exc:
            tried.append(f"native: {exc}")
    else:
        tried.append(f"native: {native_loader.build_error()}")
    if path.lower().endswith(".png"):
        try:
            return png.read_gray(path), "png"
        except IOError as exc:
            tried.append(f"png.py: {exc}")
    try:
        return _imread_gray_pil(path), "pil"
    except ImportError:
        tried.append("PIL: not installed")
    raise IOError(f"no decoder for {path}: " + "; ".join(tried))


@dataclass
class Sequence:
    """Iterable frame source with intrinsics and optional ground truth.

    Args mirror the reference loader: dataset in {"kitti", "malaga",
    "parking", "synthetic"}, a data root, camera index, frame increment, and
    the Malaga rectified/lowres variants. `render_device` is where the
    "synthetic" dataset renders its city the first time (data/synthetic.py
    `ensure_synthetic`).
    """

    dataset: str
    path: str = "./data"
    camera: int = 0
    increment: int = 1
    rectified: bool = True
    use_lowres: bool = False
    kitti_sequence: str = "05"
    render_device: str = "cuda"

    frames: list = field(default_factory=list, init=False)
    K: np.ndarray = field(default=None, init=False)
    gt_poses: np.ndarray | None = field(default=None, init=False)
    decoder: str | None = field(default=None, init=False)
    _idx: int = field(default=0, init=False)

    def __post_init__(self):
        loaders = {
            "kitti": self._load_kitti,
            "malaga": self._load_malaga,
            "parking": self._load_parking,
            "synthetic": self._load_synthetic,
        }
        if self.dataset not in loaders:
            raise ValueError(f"unknown dataset '{self.dataset}'")
        loaders[self.dataset]()
        if not self.frames:
            raise FileNotFoundError(
                f"no frames found for dataset '{self.dataset}' under {self.path}"
            )

    # -- per-dataset parsing ------------------------------------------------

    def _load_kitti(self):
        """KITTI odometry layout: <root>/kitti/<seq>/image_{0,1}/*.png with
        calib.txt P0..P3 lines; GT at <root>/kitti/poses/<seq>.txt."""
        base = os.path.join(self.path, "kitti", self.kitti_sequence)
        calib = os.path.join(base, "calib.txt")
        with open(calib) as f:
            for line in f:
                if line.startswith(f"P{self.camera}:"):
                    vals = np.fromstring(line.split(":", 1)[1], sep=" ")
                    P = vals.reshape(3, 4)
                    self.K = P[:, :3].astype(np.float32)
                    break
        if self.K is None:
            raise ValueError(f"no P{self.camera} line in {calib}")
        self.frames = sorted(
            glob(os.path.join(base, f"image_{self.camera}", "*.png"))
        )[:: self.increment]
        poses_file = os.path.join(self.path, "kitti", "poses", f"{self.kitti_sequence}.txt")
        if os.path.exists(poses_file):
            raw = np.loadtxt(poses_file).reshape(-1, 3, 4)
            n = len(raw)
            gt = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
            gt[:, :3, :4] = raw  # w_T_c rows (KITTI convention)
            self.gt_poses = gt[:: self.increment].astype(np.float32)

    def _load_malaga(self):
        """Malaga urban extract: images at
        <root>/malaga-urban-dataset-extract-07/Images/*{left,right}.jpg; the
        intrinsics ini is picked by variant —

          raw:                camera_params_raw_1024x768.txt,
                              section CAMERA_PARAMS_{LEFT,RIGHT}
          rectified (lowres): camera_params_rectified_a=0_800x600.txt
          rectified:          camera_params_rectified_a=0_1024x768.txt,
                              section CAMERA_{LEFT,RIGHT}

        and values may carry trailing `// comments`. Raises if the
        intrinsics file or a required section or key is missing."""
        base = os.path.join(self.path, "malaga")
        root = os.path.join(base, "malaga-urban-dataset-extract-07")
        if not os.path.isdir(root):
            # Tolerate the extract dir sitting directly under the data root.
            alt = os.path.join(self.path, "malaga-urban-dataset-extract-07")
            root = alt if os.path.isdir(alt) else root

        side = "left" if self.camera == 0 else "right"
        if not self.rectified:
            ini_name = "camera_params_raw_1024x768.txt"
            section = f"CAMERA_PARAMS_{side.upper()}"
        else:
            res = "800x600" if self.use_lowres else "1024x768"
            ini_name = f"camera_params_rectified_a=0_{res}.txt"
            section = f"CAMERA_{side.upper()}"
        ini = os.path.join(root, ini_name)
        if not os.path.exists(ini):
            raise FileNotFoundError(f"malaga intrinsics file not found: {ini}")
        cp = configparser.ConfigParser()
        cp.read(ini)
        if section not in cp:
            raise KeyError(f"section [{section}] not in {ini}")
        sec = cp[section]

        def val(key: str) -> float:
            return float(sec[key].split("//")[0])

        self.K = np.array(
            [
                [val("fx"), 0.0, val("cx")],
                [0.0, val("fy"), val("cy")],
                [0.0, 0.0, 1.0],
            ],
            np.float32,
        )
        self.frames = sorted(
            glob(os.path.join(root, "Images", f"*{side}.jpg"))
        )[:: self.increment]

    def _read_parking(self, base: str, need_poses: bool) -> None:
        """K.txt (comma/space separated 3x3) + images/*.png (+ poses.txt)."""
        with open(os.path.join(base, "K.txt")) as f:
            txt = f.read().replace(",", " ")
        self.K = np.fromstring(txt, sep=" ").reshape(3, 3).astype(np.float32)
        self.frames = sorted(glob(os.path.join(base, "images", "*.png")))[:: self.increment]
        poses_file = os.path.join(base, "poses.txt")
        if need_poses or os.path.exists(poses_file):
            raw = np.loadtxt(poses_file).reshape(-1, 3, 4)
            gt = np.tile(np.eye(4, dtype=np.float64), (len(raw), 1, 1))
            gt[:, :3, :4] = raw
            self.gt_poses = gt[:: self.increment].astype(np.float32)

    def _load_parking(self):
        """parking dataset: <root>/parking/{K.txt, images/*.png, poses.txt}."""
        self._read_parking(os.path.join(self.path, "parking"), need_poses=False)

    def _load_synthetic(self):
        """The procedural city (data/synthetic.py) rendered once into
        <root>/synthetic in the parking layout, then parsed like parking."""
        from vo_tpu_torch.data import synthetic

        base = synthetic.ensure_synthetic(self.path, device=self.render_device)
        self._read_parking(base, need_poses=True)

    # -- frame access -------------------------------------------------------

    def get_frame(self, idx: int) -> np.ndarray:
        img, self.decoder = _imread_gray(self.frames[idx])
        return img

    def prefetch(self, n_threads: int = 4, ring: int = 8, start: int = 0):
        """Decode-ahead frame source backed by the native C++ thread pool.

        Returns a FramePrefetcher over frames[start:] — `get(i)` yields frame
        `start + i` (strictly sequential). Falls back to a lazy synchronous
        source with the same `.get` interface when the library is absent."""
        paths = list(self.frames[start:])
        if native_loader.available():
            self.decoder = "native"
            return native_loader.FramePrefetcher(paths, n_threads=n_threads, ring=ring)
        seq = self

        class _Lazy:
            n = len(paths)

            def get(self, i, out=None):
                img, seq.decoder = _imread_gray(paths[i])
                if out is None:
                    return img
                out[...] = img
                return out

            def __iter__(self):
                return (self.get(i) for i in range(self.n))

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return None

            def close(self):
                return None

        return _Lazy()

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self):
        self._idx = 0
        return self

    def __next__(self) -> np.ndarray:
        if self._idx >= len(self.frames):
            raise StopIteration
        img = self.get_frame(self._idx)
        self._idx += 1
        return img

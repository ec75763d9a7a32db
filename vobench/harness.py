"""One run of one cell: make the inputs, set up and warm up, measure for
`seconds`, then judge what the window produced.

The program under test is the port, `vo_tpu_torch`: its bootstrap
(`pipeline.bootstrap`), its rollout (`pipeline.vo_rollout` for one lane,
`multiseq.batched_vo_rollout` over `multiseq.stack_states` for several),
which replays the step's captured CUDA graph on the card
(`graphed.capture_ahead` captures it in set-up), and its counters
(`graphed.summary`). Everything else is the benchmark's own: the city and
its exact ground truth (scene.py), the traffic, the clock, the trace and
the comparison (check.py).

Randomness: `--seed` draws every lane's bootstrap sampler and, for every
pass over the sequence, fresh RANSAC streams (PnP's, and the recovery's
from it), each seeded from (seed, pass, lane). One window so pools several
draws, and two runs of one seed make the same draws.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from vobench import scene

BOOT_TAG = 0  # derive(seed, BOOT_TAG, lane): the bootstrap's sampler; passes use 1 + pass


def derive(seed: int, *keys: int) -> int:
    """A 63-bit generator seed from the run's seed and `keys`."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), *keys]).generate_state(2)
    return int((int(words[0]) << 32 | int(words[1])) & ((1 << 63) - 1))


class Lane(NamedTuple):
    name: str
    spec: scene.SyntheticSpec
    adaptive: bool  # the adaptive keyframe policy (else every `keyframe_every` frames)


def lanes_of(config: dict) -> list[Lane]:
    out = []
    for c in config["lanes"]:
        path = scene.PathSpec(
            segments=tuple(tuple(s) for s in c["segments"]),
            step_m=c["step_m"], wiggle_amp=c["wiggle_amp"],
            wiggle_wavelength_m=c["wiggle_wavelength_m"],
            stops=tuple(tuple(s) for s in c["stops"]))
        spec = scene.SyntheticSpec(
            num_frames=c["num_frames"], width=c["width"], height=c["height"],
            focal=c["focal"], path=path, seed=c["seed"], cam_height_m=c["cam_height_m"],
            dist=tuple(c["dist"]))
        out.append(Lane(c["name"], spec, c["keyframe_mode"] == "adaptive"))
    return out


def vo_config(config: dict):
    from vo_tpu_torch.utils.config import VOConfig

    return VOConfig(**config["vo"])


class Setup(NamedTuple):
    lanes: list  # [Lane]
    cfg: Any  # the port's VOConfig
    frames: torch.Tensor  # (N, B, H, W) f32 grey levels on the device
    K: torch.Tensor  # (B, 3, 3) f32 on the device
    gt: np.ndarray  # (B, N, 4, 4) exact camera-to-world poses
    Ks: np.ndarray  # (B, 3, 3)
    boot_frames: tuple  # the bootstrap's two frames

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)


def render_lanes(lanes: list, scenes: list, gt: np.ndarray, Ks: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """(N, B, H, W) uint8 frames of every lane, rendered on `device`."""
    s0 = lanes[0].spec
    out = torch.empty((s0.num_frames, len(lanes), s0.height, s0.width), dtype=torch.uint8,
                      device=device)
    for b, (ln, (rects, tex)) in enumerate(zip(lanes, scenes)):
        out[:, b] = scene.render_frames_torch(rects, tex, gt[b], Ks[b], s0.width, s0.height,
                                              dist=ln.spec.dist, device=device)
    return out


def cached_frames(config: dict, render, cache_dir: Path | None) -> torch.Tensor:
    """The configuration's uint8 frames from `cache_dir` (one file named by
    a digest of the lanes), or `render()`ed and written there first."""
    if cache_dir is None:
        return render()
    digest = hashlib.sha256(json.dumps(config["lanes"], sort_keys=True).encode()).hexdigest()
    path = Path(cache_dir) / f"{config['name']}-{digest[:16]}.u8"
    s0 = lanes_of(config)[0].spec
    shape = (s0.num_frames, len(config["lanes"]), s0.height, s0.width)
    if path.exists() and path.stat().st_size == int(np.prod(shape)):
        return torch.from_numpy(np.fromfile(path, dtype=np.uint8).reshape(shape))
    frames = render()
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_suffix(".part")
    frames.cpu().numpy().tofile(part)
    os.replace(part, path)
    return frames


def make_setup(config: dict, device: torch.device, cache_dir: Path | None = None,
               copies: int = 1) -> Setup:
    """Every lane of `config` on `device`: the benchmark's city, rendered
    there (or read from the frame cache in `cache_dir`), as float32; with
    `copies`, the configuration's lanes that many times over, side by side
    (each copy draws its own samplers)."""
    lanes = lanes_of(config)
    specs = [ln.spec for ln in lanes]
    if len({(s.num_frames, s.height, s.width) for s in specs}) != 1:
        raise ValueError("the lanes of a configuration share one frame count and size")
    scenes = [scene.scene(s) for s in specs]
    gt = np.stack([scene.make_path(s.path, s.num_frames) for s in specs])
    Ks = np.stack([s.K() for s in specs])
    u8 = cached_frames(config, lambda: render_lanes(lanes, scenes, gt, Ks, device), cache_dir)
    frames = u8.to(device).to(torch.float32).repeat(1, copies, 1, 1)
    gt, Ks = np.tile(gt, (copies, 1, 1, 1)), np.tile(Ks, (copies, 1, 1))
    return Setup(lanes * copies, vo_config(config), frames,
                 torch.as_tensor(Ks, dtype=torch.float32, device=device), gt, Ks,
                 tuple(config["bootstrap_frames"]))


class Boot(NamedTuple):
    state: Any  # the port's VOState (batched where B > 1)
    poses: np.ndarray  # (B, 4, 4) the bootstrap's pose of its second frame


def bootstrap(setup: Setup, seed: int) -> Boot:
    """Every lane bootstrapped alone from its own sampler, then stacked."""
    from vo_tpu_torch.models import pipeline
    from vo_tpu_torch.parallel import multiseq

    dev = setup.frames.device
    f0, f1 = setup.boot_frames
    states, poses = [], []
    for b in range(setup.n_lanes):
        gen = torch.Generator(device=dev).manual_seed(derive(seed, BOOT_TAG, b))
        st, out = pipeline.bootstrap(setup.frames[f0, b], setup.frames[f1, b], setup.K[b],
                                     setup.cfg, gen)
        states.append(st)
        poses.append(out.pose)
    adaptive = torch.tensor([ln.adaptive for ln in setup.lanes], device=dev)
    if setup.n_lanes == 1:
        state = states[0]._replace(kf_adaptive=adaptive[0])
    else:
        state = multiseq.stack_states(states)._replace(kf_adaptive=adaptive)
    return Boot(state, torch.stack(poses).cpu().numpy())


def pass_state(setup: Setup, boot: Boot, seed: int, index: int):
    """The bootstrap's state with fresh samplers for pass `index`."""
    from vo_tpu_torch.models.pipeline import recovery_stream

    dev = setup.frames.device
    gens = [torch.Generator(device=dev).manual_seed(derive(seed, 1 + index, b))
            for b in range(setup.n_lanes)]
    rng = gens[0] if setup.n_lanes == 1 else gens
    return boot.state._replace(rng=rng, rec_rng=recovery_stream(rng))


def rollout(state, images: torch.Tensor, setup: Setup):
    """The program's rollout over `images` (n, B, H, W): `vo_rollout` for one
    lane, `batched_vo_rollout` for several. Returns (state, outputs)."""
    from vo_tpu_torch.models.pipeline import vo_rollout
    from vo_tpu_torch.parallel.multiseq import batched_vo_rollout

    if setup.n_lanes == 1:
        return vo_rollout(state, images[:, 0], setup.K[0], setup.cfg)
    return batched_vo_rollout(state, images, setup.K, setup.cfg)


def warm_up(setup: Setup, boot: Boot, traffic: dict) -> float:
    """Capture the step's graph (`capture_ahead`, which warms up on a
    scratch copy) and replay a few frames as the window will. Returns the
    capture's seconds."""
    from vo_tpu_torch.models.graphed import capture_ahead

    first = traffic["first_frame"]
    state = pass_state(setup, boot, -1, 0)
    if setup.n_lanes == 1:
        capture_s = capture_ahead(state, setup.frames[first:first + 1, 0], setup.K[0],
                                  setup.cfg)
    else:
        capture_s = capture_ahead(state, setup.frames[first:first + 1], setup.K, setup.cfg)
    n = max(2, *(int(c) for c in traffic["chunk_frames"]))
    rollout(state, setup.frames[first:first + n], setup)
    if setup.frames.is_cuda:
        torch.cuda.synchronize()
    return capture_s


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------

class Chunk(NamedTuple):
    first: int  # the chunk's first frame
    outs: Any  # the program's StepOutput, on the device
    table: Any  # the feature table after the chunk's last frame


@dataclasses.dataclass
class Pass:
    index: int
    chunks: list
    complete: bool = False


@dataclasses.dataclass
class Window:
    passes: list
    seconds: float  # first enqueue to the sync after the last chunk
    slice: Any = None  # the traced run's trace.profile reader

    @property
    def lane_frames(self) -> int:
        """Frames stepped, every lane's counted."""
        return sum(c.outs.pose_ok.numel() for p in self.passes for c in p.chunks)


def _sync(setup: Setup) -> None:
    if setup.frames.is_cuda:
        torch.cuda.synchronize()


def schedule(first: int, n: int, sizes) -> list[tuple[int, int]]:
    """(first frame, frames) of every chunk of a pass over frames
    first..n-1, the chunk sizes taken in turn from `sizes`; the last chunk
    ends at the sequence's end."""
    out, lo, i = [], first, 0
    while lo < n:
        size = min(int(sizes[i % len(sizes)]), n - lo)
        out.append((lo, size))
        lo, i = lo + size, i + 1
    return out


def window(setup: Setup, boot: Boot, seed: int, seconds: float, traffic: dict,
           traced: bool = False) -> Window:
    """Passes back to back over frames first..N-1 from the bootstrap, in
    chunks of the sizes `chunk_frames` gives in turn, nothing read between
    chunks; enqueuing stops at the first chunk boundary past `seconds`.
    With `traced`, the `trace_chunks` chunks from the first boundary past
    `trace_after_s` run under the profiler."""
    from vobench import trace

    chunks = schedule(traffic["first_frame"], setup.frames.shape[0], traffic["chunk_frames"])
    passes: list[Pass] = []
    sliced = None

    def advance(p: Pass, state, lo: int, size: int):
        state, outs = rollout(state, setup.frames[lo:lo + size], setup)
        p.chunks.append(Chunk(lo, outs, state.table))
        return state

    t0 = time.perf_counter()
    stop = False
    while not stop:
        p = Pass(len(passes), [])
        passes.append(p)
        state = pass_state(setup, boot, seed, p.index)
        j = 0
        while j < len(chunks):
            now = time.perf_counter()
            if now - t0 >= seconds:
                stop = True
                break
            if traced and sliced is None and now - t0 >= traffic["trace_after_s"]:
                todo = chunks[j:j + traffic["trace_chunks"]]
                box = {"state": state}

                def run(p=p, todo=todo, box=box):
                    for lo, size in todo:
                        box["state"] = advance(p, box["state"], lo, size)

                sliced = trace.profile(run, sum(size for _, size in todo), setup.n_lanes)
                state, j = box["state"], j + len(todo)
                continue
            state = advance(p, state, *chunks[j])
            j += 1
        p.complete = j == len(chunks)
    _sync(setup)
    return Window(passes, time.perf_counter() - t0, slice=sliced)



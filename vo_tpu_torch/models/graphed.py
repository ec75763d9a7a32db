"""The captured rollout: `vo_step`'s segments captured once as CUDA graphs
and replayed frame by frame — the port's counterpart of the reference's
jit-compiled `vo_rollout` (a `lax.scan` over `vo_step`) and, through
utils/cache.py, of its compile cache.

A frame runs the segments of models/pipeline.py in the order that
`pipeline.run_step` (the one schedule, which `vo_step` runs too) gives:

    draw, A, [lost? R], B1, eigh, B2, [push? C], D

- draw: the PnP uniforms of every lane, from the lane's torch.Generator,
  into a static buffer: the eager step's `torch.rand` call, same shape,
  same order (ops/ransac.py `draw_uniforms`); the clamp, Gumbel noise and
  top-k run inside A (`Drawn`).
- A, B1, B2, C, D: CUDA graphs, all in one memory pool.
- lost?, push?: the step's two host flags (one copy into pinned memory and
  one event sync each), where the reference has its two `lax.cond`s. R
  (the recovery, which draws) runs eagerly when a lane lost its pose; C
  (keyframe push and BA) replays when a lane pushes.
- eigh: the DLT's eigenvectors, eagerly between B1 and B2:
  `torch.linalg.eigh` reads its error flag on the host, which no graph can
  hold.

The results are the eager step's bit for bit: the same ops in the same
order on the same values.

Static buffers and the hazards they bring:
- The runner holds a static state (the batched shape, B lanes; one
  sequence is a batch of one, as in `vo_step`), a static frame, K and the
  uniforms, all allocated outside capture. A warm-up on a scratch copy of
  the state gives every segment's results static buffers ("slots") of
  their own; from then on a segment, captured or eager, copies its results
  into them. A result that is an input passed through (a buffer that
  exists already) is copied, never aliased, so no later write reaches
  an earlier segment's input.
- D writes the new state into the static state last, after every segment
  has read the old one, and clones first each new leaf that is still an
  old one (the new `prev_pose` is the old `pose`).
- The caller's state is copied in at the start of a rollout and never
  written. What the caller gets back is fresh: the final state is a copy
  of the static one, the outputs sit in an (N, B, ...) buffer allocated
  for the rollout, copied into after every frame, and fetched once.
- The kernel wrappers count launches when Python calls them, that is at
  capture. The runner captures (and warms up) with counting suspended
  (`kernels.uncounted`), keeps what each graph launched, and adds that at
  every replay: launch counts are the eager path's. On the card each
  count is held against the graph itself at capture: the graph must hold
  one node of the kernel for every launch counted (`check_recorded`), or
  the capture raises. (chip_smoke.py also counts the kernels of traced
  replays.)

The capture mechanism is injectable. `CudaGraphs` captures on the card.
`StandIn` is its CPU twin for the tests: "capture" runs a segment once and
keeps it, "replay" runs it again on the same static buffers with counting
suspended, as a graph's replay runs no Python. Everything else above (the
slots, the copies, the flags, the draws, the counts) is the same code.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from vo_tpu_torch.models.pipeline import (
    ROLLED,
    Segments,
    StepOutput,
    VOState,
    map_state,
    run_step,
    step_eigh,
    step_finish,
    step_keyframe,
    step_locate,
    step_map,
    step_recover,
    step_track,
)
from vo_tpu_torch.ops import kernels
from vo_tpu_torch.ops.pnp import pnp_budget
from vo_tpu_torch.ops.ransac import Drawn, draw_uniforms, drawn_hypotheses, is_lane_samplers
from vo_tpu_torch.utils.cache import RUNNERS, RunnerCache, runner_key
from vo_tpu_torch.utils.config import VOConfig

# The eager runs between graphs, in step order.
BOUNDARIES = (
    "R: the recovery (fundamental RANSAC, SVDs), only on frames where a lane lost its pose",
    "eigh: the DLT's torch.linalg.eigh between B1 and B2 (it reads its error flag)",
)


# ---------------------------------------------------------------------------
# Trees of tensors (NamedTuples, tuples, lists; other leaves are carried)
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return []


def _map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _own(tree, taken: set):
    """`tree` with every leaf cloned whose storage is in `taken` or is an
    earlier leaf's; its storages join `taken`."""
    def own(t):
        if _storage(t) in taken:
            t = t.clone()
        taken.add(_storage(t))
        return t

    return _map(own, tree)


def _copy_into(dst_tree, src_tree) -> None:
    """Copy src's leaves into dst's. A leaf that is its own target is left
    alone; one that shares storage with any target is cloned before the
    first copy, so the copies may come in any order."""
    dst, src = _leaves(dst_tree), _leaves(src_tree)
    if len(dst) != len(src):
        raise ValueError(f"{len(src)} leaves for {len(dst)} static buffers")
    targets = {_storage(d) for d in dst}
    pairs = []
    for d, s in zip(dst, src):
        if s is d:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"a {s.dtype} {tuple(s.shape)} result for a static "
                             f"{d.dtype} {tuple(d.shape)} buffer")
        pairs.append((d, s.clone() if _storage(s) in targets else s))
    for d, s in pairs:
        d.copy_(s)


# ---------------------------------------------------------------------------
# Capture mechanisms
# ---------------------------------------------------------------------------

class CudaGraphs:
    """torch.cuda.CUDAGraph capture, every graph in one memory pool, the
    warm-up on a side stream (torch's rule for capture), the capture in
    "thread_local" mode (another thread's CUDA calls, NCCL's watchdog
    among them, cannot invalidate it)."""

    reruns_python = False

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device)
        self.event = torch.cuda.Event()
        self._pinned: dict = {}

    @contextlib.contextmanager
    def warming_up(self):
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.side):
            yield
        torch.cuda.current_stream(self.device).wait_stream(self.side)

    def capture(self, fn: Callable[[], None]) -> tuple[Callable[[], None], tuple | None]:
        """(replay, `graph_nodes` of the graph). The graph is kept past
        capture to read its nodes, so it is instantiated here."""
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, pool=self.pool, capture_error_mode="thread_local"):
            fn()
        g.instantiate()
        return g.replay, graph_nodes(int(g.raw_cuda_graph()))

    def read(self, t: torch.Tensor) -> list:
        """A small tensor on the host: one copy into pinned memory, one
        event sync."""
        host = self._pinned.get((t.shape, t.dtype))
        if host is None:
            host = self._pinned[(t.shape, t.dtype)] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        self.event.record()
        self.event.synchronize()
        return host.tolist()


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h (libcuda)."""

    _fields_ = [("func", ctypes.c_void_p),
                *((f"{d}Dim{x}", ctypes.c_uint) for d in ("grid", "block") for x in "XYZ"),
                ("sharedMemBytes", ctypes.c_uint), ("kernelParams", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_nodes(graph: int) -> tuple[int, list]:
    """(the node count of a CUDA graph (a CUgraph handle), the function
    names of its kernel nodes, one per node), read through libcuda:
    cuGraphGetNodes, cuGraphNodeGetType, cuGraphKernelNodeGetParams and
    cuFuncGetName (or cuKernelGetName for a node that holds a CUkernel). A
    failed call raises."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn: str, *args) -> None:
        err = getattr(cu, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{fn} failed with CUresult {err}")

    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", ctypes.c_void_p(graph), None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", ctypes.c_void_p(graph), nodes, ctypes.byref(n))
    names = []
    kind, params, name = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p()
    for node in nodes:
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(params))
        if params.func:
            call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
        names.append(name.value.decode())
    return n.value, names


def check_recorded(segment: str, launches: dict, kernel_names: list) -> None:
    """Raise unless a graph holds one node of each kernel of ops/kernels.py
    for every launch that its capture counted (`launches`, by counter):
    the nodes whose function name holds the kernel's symbol
    (`kernels.SYMBOLS`) against the counted launches, kernel by kernel."""
    for symbol in sorted(set(kernels.SYMBOLS.values())):
        counted = sum(n for c, n in launches.items() if kernels.SYMBOLS[c] == symbol)
        held = sum(symbol in name for name in kernel_names)
        if counted != held:
            raise RuntimeError(f"graph {segment} holds {held} {symbol} nodes; its capture "
                               f"counted {counted} launches")


class StandIn:
    """The CPU twin of `CudaGraphs`: capture runs the segment once and keeps
    it; replay runs it again on the same static buffers, with launch
    counting suspended as in a graph's replay."""

    reruns_python = True

    @contextlib.contextmanager
    def warming_up(self):
        yield

    def capture(self, fn: Callable[[], None]) -> tuple[Callable[[], None], None]:
        fn()

        def replay():
            with kernels.uncounted():
                fn()

        return replay, None

    def read(self, t: torch.Tensor) -> list:
        return t.tolist()


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunnerStats:
    capture_s: float = 0.0  # warm-up and capture, host clock
    graphs: dict = dataclasses.field(default_factory=dict)  # segment -> nodes
    boundaries: tuple = BOUNDARIES
    frames: int = 0
    syncs: int = 0  # host reads: the two flags and eigh's error check
    recoveries: int = 0  # frames on which R ran
    keyframes: int = 0  # frames on which C replayed


class _Graph(NamedTuple):
    replay: Callable[[], None]
    nodes: int | None  # nodes of the CUDA graph (None where not counted)
    launches: dict  # kernel launches the graph makes, by counter name


class GraphedRollout:
    """The captured step for one `runner_key`: built (warm-up + capture) from
    the first rollout's state and frame, then replayed by every rollout."""

    def __init__(self, cfg: VOConfig, state: VOState, frame: torch.Tensor,
                 K: torch.Tensor, capture=None):
        dev = frame.device
        self.cfg = cfg
        self.capture = capture if capture is not None else (
            CudaGraphs(dev) if dev.type == "cuda" else StandIn())
        lanes = len(state.rng)
        self.stats = RunnerStats()
        t0 = time.perf_counter()
        # Static buffers, outside capture: the state (a scratch copy of the
        # first caller's until a rollout copies its own in), frame, K, the
        # PnP uniforms and the lanes' samplers over them.
        self.state = map_state(torch.clone, state, rng=None)
        self.image = frame.clone()
        self.K = K.clone()
        rows = drawn_hypotheses(pnp_budget(cfg.pnp.num_hypotheses))
        self.uniforms = torch.zeros((lanes, rows, cfg.capacity), dtype=torch.float32,
                                    device=dev)
        self.drawn = [Drawn(u) for u in self.uniforms]
        self.samplers = list(self.drawn)
        self._lanes: list = []  # the rollout's own samplers, which R draws from
        self._slots: dict = {}
        self._taken = {_storage(t) for t in _leaves(
            (self.state, self.image, self.K, self.uniforms))}
        fns = {"A": self._a, "B1": self._b1, "B2": self._b2, "C": self._c, "D": self._d}
        if not cfg.ba.enabled:  # without BA there is no keyframe decision and no C
            del fns["C"]
        with kernels.uncounted():
            with self.capture.warming_up():
                # One frame of the schedule that runs every captured segment
                # (no lane lost, every lane pushes) and gives them their slots.
                run_step(self._segments(lambda name: fns[name](), self._eigh),
                         lambda flag, t: [True] * len(t), cfg)
            self.graphs = {}
            for name, fn in fns.items():
                before = dict(kernels.launch_counts)
                replay, nodes = self.capture.capture(fn)
                launches = {k: v - before[k] for k, v in kernels.launch_counts.items()
                            if v != before[k]}
                if nodes is not None:  # a CUDA graph's (node count, kernel names)
                    check_recorded(name, launches, nodes[1])
                self.graphs[name] = _Graph(replay, None if nodes is None else nodes[0],
                                           launches)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.stats.capture_s = time.perf_counter() - t0
        self.stats.graphs = {name: g.nodes for name, g in self.graphs.items()}

    # -- segments: each writes its results into its slots and returns them --

    def _put(self, name: str, tree):
        slot = self._slots.get(name)
        if slot is None:
            slot = self._slots[name] = _own(tree, self._taken)
        else:
            _copy_into(slot, tree)
        return slot

    def _static(self) -> VOState:
        return self.state._replace(rng=self.samplers)

    def _a(self):
        self.a = self._put("A", step_track(self._static(), self.image, self.K, self.cfg))
        return self.a

    def _b1(self):
        self.g = self._put("B1", step_locate(self._static(), self.a, self.K, self.cfg))
        return self.g

    def _eigh(self, g=None):
        self.vecs = self._put("eigh", step_eigh(self.g))
        return self.vecs

    def _b2(self):
        self.b = self._put("B2", step_map(self._static(), self.a, self.g, self.vecs,
                                          self.image, self.cfg))
        return self.b

    def _c(self):
        return self._put("B2", step_keyframe(self.a, self.b, self.K, self.cfg))

    def _d(self):
        new, out = step_finish(self._static(), self.a, self.b)
        _copy_into(self.state, new)
        self.out = self._put("out", out)
        return self.out

    def _recover(self, a, lost: list):
        fb = step_recover(self.state._replace(rng=self._lanes), a, self.K, self.cfg, lost)
        self.stats.recoveries += 1
        return self._put("A", a._replace(pose_fb=fb))

    def _segments(self, run: Callable[[str], object], eigh: Callable) -> Segments:
        """The schedule's segments (pipeline.run_step): `run(name)` runs or
        replays the captured segment `name` and returns its results' slots;
        R and eigh run eagerly."""
        return Segments(
            track=lambda: run("A"),
            recover=self._recover,
            locate=lambda a: run("B1"),
            eigh=eigh,
            map=lambda a, g, vecs: run("B2"),
            keyframe=lambda a, b: run("C"),
            finish=lambda a, b: run("D"),
        )

    def _replay(self, name: str):
        g = self.graphs[name]
        g.replay()
        for counter, n in g.launches.items():
            kernels.launch_counts[counter] += n
        if name == "C":
            self.stats.keyframes += 1
        return {"A": self.a, "B1": self.g, "B2": self.b, "C": self.b, "D": self.out}[name]

    def _read(self, flag: str, t: torch.Tensor) -> list:
        self.stats.syncs += 1
        return self.capture.read(t)

    def _synced_eigh(self, g):
        self.stats.syncs += 1  # eigh's error check
        return self._eigh()

    # -- rollout ----------------------------------------------------------------

    def __call__(self, state: VOState, images: torch.Tensor,
                 K: torch.Tensor) -> tuple[VOState, StepOutput]:
        """`vo_rollout` (one sequence; images (N, H, W)) or
        `batched_vo_rollout` (B lanes; images (N, B, H, W), K (B, 3, 3)) over
        the graphs. The caller's state is read, never written."""
        if not is_lane_samplers(state.rng):
            batched = map_state(lambda x: x[None], state, rng=[state.rng])
            final, outs = self(batched, images[:, None], K.reshape(1, 3, 3))
            return (map_state(lambda x: x[0], final, rng=state.rng),
                    StepOutput(*(f[:, 0] for f in outs)))
        lanes = list(state.rng)
        if (len(lanes) != len(self.samplers) or images.dtype != self.image.dtype
                or tuple(images.shape[1:]) != tuple(self.image.shape)):
            raise ValueError(f"a runner of {self.image.dtype} frames "
                             f"{tuple(self.image.shape)} got {len(lanes)} lanes of "
                             f"{images.dtype} {tuple(images.shape[1:])}")
        gens = []
        for b, r in enumerate(lanes):
            if isinstance(r, torch.Generator):
                self.samplers[b] = self.drawn[b]
                gens.append((b, r))
            elif self.capture.reruns_python:
                self.samplers[b] = r  # a replaying sampler runs inside A
            else:
                raise ValueError("a captured rollout draws from torch.Generators; lane "
                                 f"{b} has {r!r}")
        self._lanes = lanes
        _copy_into(self.state, state)
        self.K.copy_(K)
        n = images.shape[0]
        outs = StepOutput(*(torch.empty((n,) + o.shape, dtype=o.dtype, device=o.device)
                            for o in self.out))
        rows, cols = self.uniforms.shape[1:]
        replayed = self._segments(self._replay, self._synced_eigh)
        for i in range(n):
            self.image.copy_(images[i])
            for b, gen in gens:
                self.uniforms[b].copy_(draw_uniforms(gen, rows, cols))
            out = run_step(replayed, self._read, self.cfg)
            for f, o in zip(outs, out):
                f[i].copy_(o)
        self.stats.frames += n
        ROLLED["graphs"] += n
        return map_state(torch.clone, self.state, rng=state.rng), outs


def graphed_rollout(state: VOState, images: torch.Tensor, K: torch.Tensor, cfg: VOConfig,
                    cache: RunnerCache = RUNNERS, capture=None) -> tuple[VOState, StepOutput]:
    """`vo_rollout` / `batched_vo_rollout` through the runner that `cache`
    keeps for this configuration and shape, captured on first use."""
    return runner_for(state, images, K, cfg, cache, capture)(state, images, K)


def runner_for(state: VOState, images: torch.Tensor, K: torch.Tensor, cfg: VOConfig,
               cache: RunnerCache = RUNNERS, capture=None) -> GraphedRollout:
    """The cached runner for a rollout of `images` from `state` (built from
    them if it is not there yet)."""
    if is_lane_samplers(state.rng):
        lanes, frame, K_b = state, images[0], K
    else:
        lanes = map_state(lambda x: x[None], state, rng=[state.rng])
        frame, K_b = images[0][None], K.reshape(1, 3, 3)
    key = runner_key(cfg, frame.shape[0], frame.shape[-2], frame.shape[-1], frame.dtype,
                     frame.device)
    return cache.get(key, lambda: GraphedRollout(cfg, lanes, frame, K_b, capture))


def capture_ahead(state: VOState, images: torch.Tensor, K: torch.Tensor, cfg: VOConfig,
                  graph: bool = True) -> float:
    """Capture now the runner that `vo_rollout(state, images, K, cfg, graph)`
    (or `batched_vo_rollout`) will replay, so that a timed window holds
    replays only (the JAX package compiles inside its warm-up). Returns the
    seconds it took: 0.0 where the rollout runs eagerly, and next to nothing
    where the runner is cached already."""
    if not (graph and images.is_cuda):
        return 0.0
    t0 = time.perf_counter()
    runner_for(state, images, K, cfg)
    return time.perf_counter() - t0

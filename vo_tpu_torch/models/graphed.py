"""The captured rollout: `vo_step` captured once as ONE CUDA graph a frame
and replayed frame by frame, with no host read between the first frame and
the caller's fetch — the port's counterpart of the reference's jit-compiled
`vo_rollout` (a `lax.scan` over `vo_step`, its two `lax.cond`s decided on
the device) and, through utils/cache.py, of its compile cache.

A frame is

    draw, replay the frame's graph, copy the outputs

- draw: every lane's PnP uniforms and, with the recovery on, its recovery
  uniforms, each from the lane's own torch.Generator into a static buffer:
  the eager step's `torch.rand` calls, same shapes, same order
  (ops/ransac.py `draw_uniforms`, pipeline.py `recovery_samplers`); the
  clamp, Gumbel noise and top-k run inside the graph (`Drawn`). A draw
  inside the graph would advance its generator at every replay, taken
  branch or not; outside it, the streams advance as the eager step's do.
- the frame's graph: the step's one schedule (pipeline.run_step) captured
  once, A, [R], B1, eigh, B2, [C], D, where R (the recovery) and C (the
  keyframe push and BA) are IF conditional nodes (csrc/graph_cond.cu) on
  predicates the graph computes: "a lane lost its pose" and "a lane pushes
  a keyframe". Their bodies are R's and C's own graphs, captured before the
  frame's, each in a memory pool of its own. The DLT's eigh and R's eighs
  and SVDs are the cuSOLVER routines torch.linalg runs, with their error
  flags left on the device (ops/cusolver.py).
- The graph also adds each predicate to a device counter: the frames on
  which R and C ran are counted on the device and read when asked for
  (`RunnerStats.recoveries`, `.keyframes`), after the chunk.
- Spans (models/spans.py), on unless the runner is built with
  `spans=False`: a mark kernel at every boundary of the schedule (R's and
  C's inside their bodies) stamps the card's clock into a device ring, one
  row a step, and the end marks copy the step's counts of work there; the
  frame loop stamps its host phases into a host ring of the same rows.
  `summary()` reads both after the rollouts. With `spans=False` the frame's
  graph holds no mark and no counter: the graph before spans, node for node.

The results are the eager step's bit for bit: the same ops in the same
order on the same values, and a branch that does not run leaves its
results as they stand, as the eager step's skipped branch does.

Static buffers and the hazards they bring:
- The runner holds a static state (the batched shape, B lanes; one
  sequence is a batch of one, as in `vo_step`), a static frame, K and the
  uniforms, all allocated outside capture. A warm-up on a scratch copy of
  the state runs the whole schedule with BOTH branches taken: it gives
  every result that crosses a graph's boundary a static buffer ("slot") —
  A's (which R reads and whose fallback pose R rewrites), B2's (which C
  reads and rewrites) and the step's outputs — and makes every lazy
  initialisation (cuSOLVER's handle and workspaces, the kernels' library)
  happen outside capture. From then on a segment, captured or not, copies
  its results into its slots, so a branch that does not run leaves the
  slots as A and B2 wrote them. A result that is an input passed through
  is copied, never aliased, so no later write reaches an earlier input.
- D writes the new state into the static state last, after every segment
  has read the old one, and clones first each new leaf that is still an
  old one (the new `prev_pose` is the old `pose`).
- The caller's state is copied in at the start of a rollout and never
  written. What the caller gets back is fresh: the final state is a copy
  of the static one, the outputs sit in an (N, B, ...) buffer allocated
  for the rollout, copied into after every frame, and fetched once.
- The kernel wrappers count launches when Python calls them, that is at
  capture. The runner captures (and warms up) with counting suspended
  (`kernels.uncounted`), keeps what the frame's graph launched, and adds
  that at every replay: launch counts are the eager path's. The kernels of
  ops/kernels.py launch outside the conditional bodies (a body that would
  launch one is refused: its launches could not be counted without a
  read). On the card the count is held against the graph itself at
  capture: it must hold one node of each kernel for every launch counted,
  and its bodies none (`check_recorded`), or the capture raises.
- No host read during the chunk's frames: what the frame loop runs is a
  replay, copies between device buffers and the draws, none of which reads
  the device. `RunnerStats.syncs` holds what torch's sync debug mode
  reported over those frames, a second look and no proof: torch calls that
  detector a prototype that misses some syncs, and it is a process-wide
  setting (the mode and the warnings filter are swapped for the chunk, so
  rollouts on two threads at once would see each other's).

The capture mechanism is injectable. `CudaGraphs` captures on the card.
`StandIn` is its CPU twin for the tests: "capture" runs a segment once and
keeps it, "replay" runs it again on the same static buffers with counting
suspended, as a graph's replay runs no Python, an IF node evaluates its
predicate itself, as the device does, and a span mark stamps the host's
clock. Everything else above (the slots, the copies, the draws, the counts,
the rings) is the same code.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from vo_tpu_torch.models import spans as spans_mod
from vo_tpu_torch.models.pipeline import (
    ROLLED,
    Segments,
    StepOutput,
    VOState,
    map_state,
    no_mark,
    recovery_shape,
    run_step,
    step_eigh,
    step_finish,
    step_keyframe,
    step_locate,
    step_localize,
    step_map,
    step_recover,
    step_track,
)
from vo_tpu_torch.ops import kernels
from vo_tpu_torch.ops.pnp import pnp_budget
from vo_tpu_torch.ops.ransac import Drawn, draw_uniforms, drawn_hypotheses, is_lane_samplers
from vo_tpu_torch.utils.cache import RUNNERS, RunnerCache, runner_key
from vo_tpu_torch.utils.config import VOConfig

BRANCHES = ("R", "C")  # the conditional nodes, in step order


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
# What a CUDA graph holds, read through libcuda
# ---------------------------------------------------------------------------

class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h (libcuda)."""

    _fields_ = [("func", ctypes.c_void_p),
                *((f"{d}Dim{x}", ctypes.c_uint) for d in ("grid", "block") for x in "XYZ"),
                ("sharedMemBytes", ctypes.c_uint), ("kernelParams", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_KERNEL, _CHILD_GRAPH, _CONDITIONAL = 0, 4, 13  # CUgraphNodeType


class GraphNodes(NamedTuple):
    """What a CUDA graph holds, its conditional bodies and child graphs
    included: every node, the function names of the kernel nodes outside
    any conditional body and inside one, and the conditional nodes."""

    nodes: int
    kernels: list
    body_kernels: list
    conditionals: int


def graph_nodes(graph: int, bodies: dict | None = None) -> GraphNodes:
    """The nodes of a CUDA graph (a CUgraph handle), read through libcuda:
    cuGraphGetNodes and cuGraphNodeGetType; a kernel node's function name
    through cuGraphKernelNodeGetParams and cuFuncGetName (or cuKernelGetName
    for a node that holds a CUkernel); a child graph node's graph through
    cuGraphChildGraphNodeGetGraph, walked in turn; a conditional node's body
    graphs from `bodies` (node handle -> its bodies, as csrc/graph_cond.cu
    handed them out: libcuda 580 cannot read them back), walked in
    turn. A failed call, or a conditional node of unknown bodies, raises."""
    bodies = bodies or {}
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn: str, *args) -> None:
        err = getattr(cu, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{fn} failed with CUresult {err}")

    found = GraphNodes(0, [], [], 0)

    def walk(g, in_body: bool) -> None:
        nonlocal found
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", ctypes.c_void_p(g), None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call("cuGraphGetNodes", ctypes.c_void_p(g), nodes, ctypes.byref(n))
        found = found._replace(nodes=found.nodes + n.value)
        kind = ctypes.c_int()
        for node in nodes:
            call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
            if kind.value == _KERNEL:
                params, name = _KernelNodeParams(), ctypes.c_char_p()
                call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
                     ctypes.byref(params))
                if params.func:
                    call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
                else:
                    call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
                (found.body_kernels if in_body else found.kernels).append(name.value.decode())
            elif kind.value == _CHILD_GRAPH:
                child = ctypes.c_void_p()
                call("cuGraphChildGraphNodeGetGraph", ctypes.c_void_p(node), ctypes.byref(child))
                walk(child.value, in_body)
            elif kind.value == _CONDITIONAL:
                if node not in bodies:
                    raise RuntimeError(f"conditional node {node:#x} of unknown bodies")
                found = found._replace(conditionals=found.conditionals + 1)
                for body in bodies[node]:
                    walk(body, True)

    walk(graph, False)
    return found


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


# ---------------------------------------------------------------------------
# Capture mechanisms
# ---------------------------------------------------------------------------

class Captured(NamedTuple):
    replay: Callable[[], None] | None  # None for a branch: it runs inside an IF node
    graph: Any  # the torch.cuda.CUDAGraph (None for the stand-in)
    nodes: GraphNodes | None  # None where not read


class CudaGraphs:
    """torch.cuda.CUDAGraph capture: the frame's graph in one memory pool,
    each branch's in a pool of its own; the warm-up on a side stream
    (torch's rule for capture); the capture in "thread_local" mode (another
    thread's CUDA calls, NCCL's watchdog among them, cannot invalidate
    it)."""

    reruns_python = False

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device)
        self.bodies: dict = {}  # IF node -> its body graphs (`graph_nodes`)

    @contextlib.contextmanager
    def warming_up(self):
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.side):
            yield
        torch.cuda.current_stream(self.device).wait_stream(self.side)

    def capture(self, fn: Callable[[], None], branch: bool = False) -> Captured:
        """The graph of `fn`, kept past capture to read its nodes. A branch's
        graph is never instantiated: `if_node` clones it into the body of an
        IF node of the frame's graph."""
        g = torch.cuda.CUDAGraph(keep_graph=True)
        pool = torch.cuda.graph_pool_handle() if branch else self.pool
        with torch.cuda.graph(g, pool=pool, capture_error_mode="thread_local"):
            fn()
        nodes = graph_nodes(int(g.raw_cuda_graph()), self.bodies)
        if branch:
            return Captured(None, g, nodes)
        g.instantiate()
        return Captured(g.replay, g, nodes)

    def if_node(self, pred: torch.Tensor, branch: Captured) -> None:
        """Inside a capture: an IF node that runs `branch` where the device
        bool `pred` is true (csrc/graph_cond.cu)."""
        if not (pred.is_cuda and pred.dtype == torch.bool and pred.numel() == 1):
            raise ValueError(f"an IF node needs one CUDA bool, got {pred.dtype} "
                             f"{tuple(pred.shape)} on {pred.device}")
        from vo_tpu_torch.ops._build import library

        node, body = ctypes.c_void_p(), ctypes.c_void_p()
        err = library().vo_graph_if_node(
            ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream),
            ctypes.c_void_p(pred.data_ptr()), ctypes.c_void_p(int(branch.graph.raw_cuda_graph())),
            ctypes.byref(node), ctypes.byref(body))
        if err != 0:
            raise RuntimeError(f"vo_graph_if_node failed with {err} (-1: the stream is not "
                               "capturing; else a cudaError_t)")
        self.bodies[node.value] = [body.value]

    def mark(self, ring: spans_mod.Ring, boundary: int, src: torch.Tensor | None,
             dst: int) -> None:
        """Span mark `boundary` on the current stream (csrc/spans.cu): inside
        a capture, a kernel node; `src`, int64 counters copied into the row
        from column `dst`."""
        from vo_tpu_torch.ops._build import library

        if src is not None and not (src.dtype == torch.int64 and src.is_contiguous()
                                    and src.device == ring.table.device):
            raise ValueError(f"span counters must be contiguous int64 on {ring.table.device}, "
                             f"got {src.dtype} on {src.device}")
        err = library().vo_span_mark_launch(
            boundary, ctypes.c_void_p(ring.table.data_ptr()), ctypes.c_void_p(ring.seq.data_ptr()),
            ring.rows, ring.table.shape[1],
            None if src is None else ctypes.c_void_p(src.data_ptr()),
            0 if src is None else src.numel(), dst,
            ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream))
        if err != 0:
            raise RuntimeError(f"vo_span_mark_launch({boundary}) failed with {err}")

    def clock(self, out: torch.Tensor) -> None:
        """Two readings of the card's clock into `out` (2,) int64."""
        from vo_tpu_torch.ops._build import library

        err = library().vo_span_clock(
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream))
        if err != 0:
            raise RuntimeError(f"vo_span_clock failed with {err}")

    def count_syncs(self, fn: Callable[[], None]) -> int:
        """fn() under torch's sync debug mode ("warn"): the syncs that
        torch's detector reported (it does not see every kind)."""
        before = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(before)
        syncs = 0
        for w in caught:
            if "synchronizing CUDA operation" in str(w.message):
                syncs += 1
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        return syncs


class StandIn:
    """The CPU twin of `CudaGraphs`: capture runs the segment once and keeps
    it; replay runs it again on the same static buffers, with launch
    counting suspended as in a graph's replay; an IF node evaluates its
    predicate itself and runs the branch, as the device does."""

    reruns_python = True

    @contextlib.contextmanager
    def warming_up(self):
        yield

    def capture(self, fn: Callable[[], None], branch: bool = False) -> Captured:
        fn()

        def replay():
            with kernels.uncounted():
                fn()

        return Captured(replay, None, None)

    def if_node(self, pred: torch.Tensor, branch: Captured) -> None:
        if bool(pred):
            branch.replay()

    def mark(self, ring: spans_mod.Ring, boundary: int, src: torch.Tensor | None,
             dst: int) -> None:
        spans_mod.host_mark(ring, boundary, src, dst)

    def clock(self, out: torch.Tensor) -> None:
        spans_mod.host_clock(out)

    def count_syncs(self, fn: Callable[[], None]) -> int:
        fn()
        return 0


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunnerStats:
    capture_s: float = 0.0  # warm-up and capture, host clock
    graphs: dict = dataclasses.field(default_factory=dict)  # "frame", "R", "C" -> nodes
    conditionals: int | None = None  # IF nodes in the frame's graph (None: not read)
    frames: int = 0
    syncs: int = 0  # syncs torch's detector reported during the chunks' frames
    taken: torch.Tensor | None = None  # (2,) frames on which R, C ran: device counts

    @property
    def recoveries(self) -> int:
        """Frames on which R ran (a read of the device count)."""
        return int(self.taken[0])

    @property
    def keyframes(self) -> int:
        """Frames on which C ran (a read of the device count)."""
        return int(self.taken[1])


class GraphedRollout:
    """The captured step for one `runner_key`: built (warm-up + capture) from
    the first rollout's state and frame, then replayed by every rollout."""

    def __init__(self, cfg: VOConfig, state: VOState, frame: torch.Tensor,
                 K: torch.Tensor, capture=None, spans: bool = True):
        dev = frame.device
        self.cfg = cfg
        self.capture = capture if capture is not None else (
            CudaGraphs(dev) if dev.type == "cuda" else StandIn())
        lanes = len(state.rng)
        self.stats = RunnerStats(taken=torch.zeros(len(BRANCHES), dtype=torch.int64,
                                                   device=dev))
        t0 = time.perf_counter()
        # Static buffers, outside capture: the state (a scratch copy of the
        # first caller's until a rollout copies its own in), frame, K, the
        # uniforms and the lanes' samplers over them.
        self.state = map_state(torch.clone, state, rng=None, rec_rng=None)
        self.image = frame.clone()
        self.K = K.clone()
        rows = drawn_hypotheses(pnp_budget(cfg.pnp.num_hypotheses))
        self.uniforms = torch.zeros((lanes, rows, cfg.capacity), dtype=torch.float32,
                                    device=dev)
        self.drawn = [Drawn(u) for u in self.uniforms]
        self.samplers = list(self.drawn)
        self.rec_uniforms = torch.zeros((lanes,) + recovery_shape(cfg), dtype=torch.float32,
                                        device=dev)
        self.rec_drawn = [Drawn(u) for u in self.rec_uniforms]
        self.rec_samplers = list(self.rec_drawn)
        self._slots: dict = {}
        self.spans = spans_mod.Ring(dev, spans_mod.ROWS) if spans else None
        self._counts: dict = {}  # boundary -> (counters its mark copies, first column)
        mark = self._mark if spans else no_mark
        self._taken = {_storage(t) for t in _leaves(
            (self.state, self.image, self.K, self.uniforms, self.rec_uniforms,
             self.stats.taken))}
        bodies = {}

        def warm(name, pred, run, skipped):
            bodies[name] = run  # the branch's body as the schedule gives it, marks included
            return run()

        with kernels.uncounted():
            with self.capture.warming_up():
                # One frame of the schedule with every branch taken: the
                # slots, and every lazy initialisation, outside capture.
                # The schedule hands over the bodies of the branches the
                # configuration has (without BA there is no C).
                run_step(self._segments(), warm, cfg, mark)
            self.branches = {name: self._capture(name, body, branch=True)
                             for name, body in bodies.items()}
            self.frame = self._capture("frame", lambda: run_step(
                self._segments(), self._if_node, cfg, mark))
        self.stats.taken.zero_()  # the stand-in's capture ran the frame once
        if self.spans is not None:
            self.spans.reset()  # so did the warm-up's marks
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if self.spans is not None:
            self.spans.calibrate(self.capture)
        self.stats.capture_s = time.perf_counter() - t0
        graphs = {"frame": self.frame, **self.branches}
        self.stats.graphs = {name: None if g.nodes is None else g.nodes.nodes
                             for name, g in graphs.items()}
        if self.frame.nodes is not None:
            self.stats.conditionals = self.frame.nodes.conditionals

    def _capture(self, name: str, fn: Callable[[], Any], branch: bool = False) -> Captured:
        """Capture `fn` as graph `name`; a frame's graph keeps its launches
        (added at every replay), a branch must launch no counted kernel."""
        before = dict(kernels.launch_counts)
        captured = self.capture.capture(fn, branch)
        launches = {k: v - before[k] for k, v in kernels.launch_counts.items()
                    if v != before[k]}
        if branch and launches:
            raise RuntimeError(f"branch {name} launches {launches}: a conditional body's "
                               "launches cannot be counted without a host read")
        if captured.nodes is not None:
            check_recorded(name, launches, captured.nodes.kernels)
            check_recorded(f"{name}'s conditional bodies", {}, captured.nodes.body_kernels)
        if not branch:
            self.launches = launches
        return captured

    # -- segments: each writes its results into its slots and returns them --

    def _put(self, name: str, tree):
        slot = self._slots.get(name)
        if slot is None:
            slot = self._slots[name] = _own(tree, self._taken)
        else:
            _copy_into(slot, tree)
        return slot

    def _static(self) -> VOState:
        return self.state._replace(rng=self.samplers, rec_rng=self.rec_samplers)

    def _track(self):
        self.front = step_track(self._static(), self.image, self.K, self.cfg,
                                self.spans is not None)
        return self.front

    def _localize(self):
        self.a = self._put("A", step_localize(self._static(), self.front, self.K, self.cfg))
        return self.a

    def _r(self):
        fb = step_recover(self._static(), self.a, self.K, self.cfg, self.rec_samplers)
        return self._put("A", self.a._replace(pose_fb=fb))

    def _b2(self, g, vecs):
        self.b = self._put("B2", step_map(self._static(), self.a, g, vecs, self.image,
                                          self.cfg))
        return self.b

    def _c(self):
        if self.spans is None:
            return self._put("B2", step_keyframe(self.a, self.b, self.K, self.cfg))
        b, kept = step_keyframe(self.a, self.b, self.K, self.cfg, True)
        if kept is not None:  # the lanes that ran BA, and those whose BA was kept
            push = self.b.push
            self._counts["C.end"] = (torch.stack([push, push & kept]).sum(dim=-1),
                                     spans_mod.COL[spans_mod.BA_COUNTS[0]])
        return self._put("B2", b)

    def _d(self):
        new, out = step_finish(self._static(), self.a, self.b)
        _copy_into(self.state, new)
        self.out = self._put("out", out)
        if self.spans is not None:
            # The step's counts, each summed over lanes, in STEP_COUNTS'
            # order (LK's last, where it ran).
            o = self.out
            per_lane = [o.num_tracked, self.a.tri.sum(dim=-1), o.num_pnp_inliers,
                        o.num_candidates, o.num_new_landmarks]
            if self.front.lk_active is not None:
                per_lane.append(self.front.lk_active)
            self._counts["end"] = (torch.stack(per_lane).sum(dim=-1),
                                   spans_mod.COL[spans_mod.STEP_COUNTS[0]])
        return self.out

    def _mark(self, boundary: str) -> None:
        """The span mark at `boundary`, with the counters a segment left for
        it."""
        src, dst = self._counts.get(boundary, (None, 0))
        self.capture.mark(self.spans, spans_mod.BOUNDARY[boundary], src, dst)

    def _segments(self) -> Segments:
        """The schedule's segments (pipeline.run_step) over the static
        buffers. B1's and the eigh's results stay inside the frame's graph
        and need no slot."""
        return Segments(
            track=self._track,
            localize=lambda f: self._localize(),
            recover=lambda a: self._r(),
            locate=lambda a: step_locate(self._static(), self.a, self.K, self.cfg),
            eigh=step_eigh,
            map=lambda a, g, vecs: self._b2(g, vecs),
            keyframe=lambda a, b: self._c(),
            finish=lambda a, b: self._d(),
        )

    def _if_node(self, name: str, pred: torch.Tensor, run, skipped):
        """The frame's branch `name`: its predicate counted on the device and
        an IF node over the branch's graph; the results are the slots, which
        the branch rewrites where it runs."""
        self.stats.taken[BRANCHES.index(name)] += pred
        self.capture.if_node(pred, self.branches[name])
        return skipped

    # -- rollout ----------------------------------------------------------------

    def _bind(self, lanes: list, mine: list, drawn: list, what: str) -> list:
        """Point this rollout's samplers (`mine`) at the lanes': a generator
        draws into its lane's static uniforms, which `Drawn` reads in the
        graph; a replaying sampler runs in the graph where the stand-in runs
        Python again. Returns the (lane, generator) pairs to draw from."""
        gens = []
        for b, r in enumerate(lanes):
            if isinstance(r, torch.Generator):
                mine[b] = drawn[b]
                gens.append((b, r))
            elif r is not None and self.capture.reruns_python:
                mine[b] = r
            else:
                raise ValueError(f"a captured rollout draws from torch.Generators; lane {b}'s "
                                 f"{what} is {r!r}")
        return gens

    def __call__(self, state: VOState, images: torch.Tensor,
                 K: torch.Tensor) -> tuple[VOState, StepOutput]:
        """`vo_rollout` (one sequence; images (N, H, W)) or
        `batched_vo_rollout` (B lanes; images (N, B, H, W), K (B, 3, 3)) over
        the frame's graph. The caller's state is read, never written."""
        if not is_lane_samplers(state.rng):
            batched = map_state(lambda x: x[None], state, rng=[state.rng],
                                rec_rng=[state.rec_rng])
            final, outs = self(batched, images[:, None], K.reshape(1, 3, 3))
            return (map_state(lambda x: x[0], final, rng=state.rng, rec_rng=state.rec_rng),
                    StepOutput(*(f[:, 0] for f in outs)))
        lanes = list(state.rng)
        if (len(lanes) != len(self.samplers) or images.dtype != self.image.dtype
                or tuple(images.shape[1:]) != tuple(self.image.shape)):
            raise ValueError(f"a runner of {self.image.dtype} frames "
                             f"{tuple(self.image.shape)} got {len(lanes)} lanes of "
                             f"{images.dtype} {tuple(images.shape[1:])}")
        gens = self._bind(lanes, self.samplers, self.drawn, "PnP sampler")
        rec_gens = (self._bind(list(state.rec_rng), self.rec_samplers, self.rec_drawn,
                               "recovery sampler") if self.cfg.recovery.enabled else [])
        # Under torch.profiler the phases are annotated in its trace, and the
        # rollout's steps are flagged: they measure the tracer.
        profiled = torch.autograd._profiler_enabled()
        ring = self.spans
        n = images.shape[0]
        with _annotated("vo.rollout", profiled):
            t_in = time.monotonic_ns()
            _copy_into(self.state, state)
            self.K.copy_(K)
            outs = StepOutput(*(torch.empty((n,) + o.shape, dtype=o.dtype, device=o.device)
                                for o in self.out))
            t_in_end = time.monotonic_ns()
            first = 0 if ring is None else ring.steps + 1
            self.stats.syncs += self.capture.count_syncs(
                lambda: self._frames(images, outs, gens, rec_gens, profiled))
            t_back = time.monotonic_ns()
            final = map_state(torch.clone, self.state, rng=state.rng, rec_rng=state.rec_rng)
            if ring is not None:
                ring.rollouts.append(spans_mod.Rollout(first, n, profiled, t_in, t_in_end,
                                                       t_back, time.monotonic_ns()))
        self.stats.frames += n
        ROLLED["graphs"] += n
        return final, outs

    def _frames(self, images: torch.Tensor, outs: StepOutput, gens: list, rec_gens: list,
                profiled: bool) -> None:
        """The frame loop: for each frame the draws, the frame's copy and the
        replay, the output copies; each phase's start stamped in the host
        ring (in a scratch row where the runner keeps no spans)."""
        rows, cols = self.uniforms.shape[1:]
        rec_rows = self.rec_uniforms.shape[1]
        col = spans_mod.HCOL
        scratch = np.zeros(len(spans_mod.HOST_COLUMNS), dtype=np.int64)
        for i in range(images.shape[0]):
            row = scratch if self.spans is None else self.spans.step(profiled)
            row[col["draw"]] = time.monotonic_ns()
            with _annotated("vo.step.draw", profiled):
                for b, gen in gens:
                    self.uniforms[b].copy_(draw_uniforms(gen, rows, cols))
                for b, gen in rec_gens:
                    self.rec_uniforms[b].copy_(draw_uniforms(gen, rec_rows, cols))
            row[col["launch"]] = time.monotonic_ns()
            with _annotated("vo.step.launch", profiled):
                self.image.copy_(images[i])
                self.frame.replay()
                for counter, k in self.launches.items():
                    kernels.launch_counts[counter] += k
            row[col["copy_out"]] = time.monotonic_ns()
            with _annotated("vo.step.copy_out", profiled):
                for f, o in zip(outs, self.out):
                    f[i].copy_(o)
            row[col["done"]] = time.monotonic_ns()

    def span_readout(self) -> spans_mod.Readout | None:
        """The runner's span rings, read now, after a new calibration of the
        card's clock; None where the runner keeps no spans."""
        if self.spans is None:
            return None
        if self.image.is_cuda:
            torch.cuda.synchronize(self.image.device)
        self.spans.calibrate(self.capture)
        cfg, lanes = self.cfg, len(self.samplers)
        slots = cfg.capacity * lanes
        lk = cfg.klt.pyramid_levels * cfg.klt.max_iters if cfg.tracker == "klt" else 0
        return self.spans.readout(dict(
            slots=slots, lk_run=slots * lk,
            pnp_hypotheses=pnp_budget(cfg.pnp.num_hypotheses) * lanes))


def _annotated(name: str, profiled: bool):
    """A torch.profiler annotation of `name` while the profiler runs;
    nothing (not even the annotation's own cost) otherwise."""
    return torch.profiler.record_function(name) if profiled else contextlib.nullcontext()


def graphed_rollout(state: VOState, images: torch.Tensor, K: torch.Tensor, cfg: VOConfig,
                    cache: RunnerCache = RUNNERS, capture=None,
                    spans: bool = True) -> tuple[VOState, StepOutput]:
    """`vo_rollout` / `batched_vo_rollout` through the runner that `cache`
    keeps for this configuration and shape, captured on first use."""
    return runner_for(state, images, K, cfg, cache, capture, spans)(state, images, K)


def runner_for(state: VOState, images: torch.Tensor, K: torch.Tensor, cfg: VOConfig,
               cache: RunnerCache = RUNNERS, capture=None,
               spans: bool = True) -> GraphedRollout:
    """The cached runner for a rollout of `images` from `state` (built from
    them if it is not there yet), with span marks and counters in its graph
    unless `spans=False`."""
    if is_lane_samplers(state.rng):
        lanes, frame, K_b = state, images[0], K
    else:
        lanes = map_state(lambda x: x[None], state, rng=[state.rng], rec_rng=[state.rec_rng])
        frame, K_b = images[0][None], K.reshape(1, 3, 3)
    key = runner_key(cfg, frame.shape[0], frame.shape[-2], frame.shape[-1], frame.dtype,
                     frame.device, spans)
    return cache.get(key, lambda: GraphedRollout(cfg, lanes, frame, K_b, capture, spans))


def capture_ahead(state: VOState, images: torch.Tensor, K: torch.Tensor, cfg: VOConfig,
                  graph: bool = True, spans: bool = True) -> float:
    """Capture now the runner that `vo_rollout(state, images, K, cfg, graph,
    spans)` (or `batched_vo_rollout`) will replay, so that a timed window
    holds replays only (the JAX package compiles inside its warm-up).
    Returns the seconds it took: 0.0 where the rollout runs eagerly, and next
    to nothing where the runner is cached already."""
    if not (graph and images.is_cuda):
        return 0.0
    t0 = time.perf_counter()
    runner_for(state, images, K, cfg, spans=spans)
    return time.perf_counter() - t0


def summary(cache: RunnerCache = RUNNERS) -> dict | None:
    """What the cache's runners replayed, for a JSON line: host syncs a
    frame, the frames on which R and C ran (the device counts, read here),
    each runner's graphs with their nodes and conditional nodes, and
    `spans`, the aggregates of the runners' span rings over the steps not
    run under the profiler (`spans.statistics`; None where no runner keeps
    spans or no step counts). Reading the rings recalibrates the card's
    clock. None where no runner was built."""
    runners = cache.runners()
    if not runners:
        return None
    stats = [r.stats for r in runners]
    frames = sum(s.frames for s in stats)
    readouts = [x for x in span_rows(cache) if x is not None]
    return dict(
        frames=frames,
        syncs_per_step=sum(s.syncs for s in stats) / max(frames, 1),
        recoveries=sum(s.recoveries for s in stats),
        keyframes=sum(s.keyframes for s in stats),
        graphs=[dict(lanes=len(r.samplers), nodes=r.stats.graphs,
                     conditional_nodes=r.stats.conditionals, frames=r.stats.frames,
                     capture_s=round(r.stats.capture_s, 3)) for r in runners],
        spans=spans_mod.statistics(readouts) if readouts else None,
    )


def span_rows(cache: RunnerCache = RUNNERS) -> list:
    """Every runner's span rings as read now (`spans.Readout`; None for a
    runner without spans), in the order the runners were built: the raw
    rows, for tools and tests."""
    return [r.span_readout() for r in cache.runners()]

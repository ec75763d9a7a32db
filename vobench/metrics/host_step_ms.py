"""Host ms a step inside the rollout executor: the draws, the frame's copy
and the graph's launch, and the output copies, stamped on the host's
monotonic clock (the rollouts not run under the profiler)."""

from vobench import span_reading


def read(ctx):
    parts = [span_reading.value(ctx, "host_ms", k) for k in ("draw", "launch", "copy_out")]
    return None if any(p is None for p in parts) else sum(parts)

"""What the per-layer readers of the program's own spans share: the span
aggregates that `graphed.summary()` gives under "spans" (the captured
step's marks on the card's clock and its counters, over the rollouts not
run under the profiler; vo_tpu_torch/models/spans.py). A program that keeps
no spans, or a run in which no step counted, gives None, and so does every
reader."""

from __future__ import annotations


def spans(ctx) -> dict | None:
    """The summary's span aggregates, or None where there are none."""
    summary = ctx.summary if isinstance(ctx.summary, dict) else {}
    s = summary.get("spans")
    return s if isinstance(s, dict) and s.get("steps") else None


def value(ctx, *keys) -> float | None:
    """The aggregate under `keys` (a path into the dict), or None."""
    x = spans(ctx)
    for k in keys:
        if not isinstance(x, dict):
            return None
        x = x.get(k)
    return None if x is None else float(x)


def segments_ms(ctx, *names) -> float | None:
    """The sum of the mean device ms a step of the segments `names`."""
    parts = [value(ctx, "segment_ms", n) for n in names]
    return None if any(p is None for p in parts) else sum(parts)


def share_pct(ctx, part: str, whole: str) -> float | None:
    """100 * counts[part] / counts[whole], or None where `whole` is 0."""
    num, den = value(ctx, "counts", part), value(ctx, "counts", whole)
    if num is None or not den:
        return None
    return 100.0 * num / den

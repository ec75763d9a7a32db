"""LK's point-iterations still active (their update applied) over those
run: the fixed 10 iterations on each level over every slot of every lane.
The rest add an exact 0."""

from vobench import span_reading


def read(ctx):
    return span_reading.share_pct(ctx, "lk_active", "lk_run")

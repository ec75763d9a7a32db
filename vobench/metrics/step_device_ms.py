"""The traced slice's union-busy device time over its steps (a step moves
every lane one frame)."""

from vobench import trace


def read(ctx):
    if ctx.slice is None or ctx.slice.steps == 0 or not ctx.slice.device:
        return None
    return 1e3 * trace.busy_s(ctx.slice) / ctx.slice.steps

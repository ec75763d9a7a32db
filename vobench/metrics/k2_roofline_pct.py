"""The K2 pair (the LK patch gathers of one lane, one launch a pyramid
level) as a share of its roofline on the path: the bounds of a step's
four launches, by the benchmark's byte model, times the steps, over the
sum of their kernel times in the traced slice."""

from vobench import roofline


def read(ctx):
    if ctx.slice is None or ctx.lanes != 1:
        return None
    return roofline.k2_share_pct(ctx.slice, ctx.lanes, ctx.height, ctx.width,
                                 ctx.capacity, ctx.levels)

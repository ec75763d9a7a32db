"""The K2b pair (the LK patch gathers of every lane at once) as a share of
its roofline on the path, as k2_roofline_pct reads the K2 pair."""

from vobench import roofline


def read(ctx):
    if ctx.slice is None or ctx.lanes == 1:
        return None
    return roofline.k2_share_pct(ctx.slice, ctx.lanes, ctx.height, ctx.width,
                                 ctx.capacity, ctx.levels)

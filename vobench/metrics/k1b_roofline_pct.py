"""K1b (the corner kernel over every lane at once) as a share of its
roofline on the path, as k1_roofline_pct reads K1."""

from vobench import roofline


def read(ctx):
    if ctx.slice is None or ctx.lanes == 1:
        return None
    return roofline.k1_share_pct(ctx.slice, ctx.lanes, ctx.height, ctx.width)

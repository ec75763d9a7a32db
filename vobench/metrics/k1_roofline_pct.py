"""K1 (the corner kernel over one lane) as a share of its roofline on the
path: the bounds of its launches in the traced slice, by the benchmark's
byte and operation model, over the sum of their kernel times."""

from vobench import roofline


def read(ctx):
    if ctx.slice is None or ctx.lanes != 1:
        return None
    return roofline.k1_share_pct(ctx.slice, ctx.lanes, ctx.height, ctx.width)

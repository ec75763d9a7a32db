"""The front end's device ms, mean over steps: the `track` segment (the
pyramid, LK or matching, the table's update), between its marks on the
card's clock."""

from vobench import span_reading


def read(ctx):
    return span_reading.segments_ms(ctx, "track")

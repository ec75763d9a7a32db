"""PnP's device ms, mean over steps: the `localize` segment (P3P-RANSAC and
the constant-velocity fallback), between its marks on the card's clock."""

from vobench import span_reading


def read(ctx):
    return span_reading.segments_ms(ctx, "localize")

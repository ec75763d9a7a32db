"""The mapping segments' device ms, mean over steps: B1 (pose selection,
the culls, the DLT systems; R's predicate and test count here), the DLT's
eigh and B2 (the new landmarks, the top-up detection, the keyframe
decision), between their marks on the card's clock."""

from vobench import span_reading


def read(ctx):
    return span_reading.segments_ms(ctx, "locate", "eigh", "map")

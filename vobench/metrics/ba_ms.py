"""C's body (the keyframe push and the windowed BA) in device ms, mean over
every step, 0 on a step where its IF node did not run; between C's start
and end marks on the card's clock. None where C never ran."""

from vobench import span_reading


def read(ctx):
    if not span_reading.value(ctx, "branch_steps", "keyframe"):
        return None
    return span_reading.segments_ms(ctx, "keyframe")

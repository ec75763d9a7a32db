"""The captured step's device ms, mean over steps: frame start mark to
frame end mark on the card's clock (the program's own counterpart of
`step_device_ms`, which reads the tracer)."""

from vobench import span_reading


def read(ctx):
    return span_reading.value(ctx, "step_ms", "mean")

"""The card idle between the captured steps, from the program's own spans on
the card's clock: the time from one step's end mark to the next step's
start mark, over the steps' device wall time (first start to last end), over
the rollouts not run under the profiler. What the card does outside the
frame's graph counts here too: the draws and the frame's and outputs'
copies."""

from vobench import span_reading


def read(ctx):
    return span_reading.value(ctx, "device_idle_pct")

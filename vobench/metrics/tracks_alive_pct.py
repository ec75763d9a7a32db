"""Slots tracked over the slots LK ran on (capacity x lanes x steps): the
share of the front end's work that keeps a track."""

from vobench import span_reading


def read(ctx):
    return span_reading.share_pct(ctx, "tracked", "slots")

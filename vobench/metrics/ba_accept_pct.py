"""BA runs that its accept veto kept over BA runs: on the steps where C
ran, the lanes that pushed a keyframe, and of them those whose refinement
neither grew the error by over 2% nor went non-finite."""

from vobench import span_reading


def read(ctx):
    return span_reading.share_pct(ctx, "ba_kept", "ba_runs")

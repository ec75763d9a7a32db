"""New landmarks over the triangulation's candidates (the tracks past the
bearing gate), summed over steps and lanes: the share of the DLT's work
that the depth and reprojection gates keep."""

from vobench import span_reading


def read(ctx):
    return span_reading.share_pct(ctx, "new_landmarks", "tri_candidates")

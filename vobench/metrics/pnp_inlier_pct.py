"""PnP's inliers over its inputs (the tracked slots with a landmark),
summed over steps and lanes. The hypotheses PnP scores, whatever this
share, are beside it in the summary (`pnp_hypotheses`)."""

from vobench import span_reading


def read(ctx):
    return span_reading.share_pct(ctx, "pnp_inliers", "pnp_inputs")

"""Host syncs a frame that torch's sync detector reported over the run's
replayed frames (the rollout executor's own count, graphed.summary)."""


def read(ctx):
    if not ctx.summary or not ctx.summary.get("frames"):
        return None
    return float(ctx.summary["syncs_per_step"])

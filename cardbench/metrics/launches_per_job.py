"""Launches of the port's kernels a job (a resident job, or a call of
images), from its launch counters summed over every kernel and every
rank.  Reads ``launches_per_job.<cells>`` for every kind of cell."""


def read(ctx):
    if not ctx.get("jobs"):
        return None
    return sum(ctx["launches"].values()) / ctx["jobs"]

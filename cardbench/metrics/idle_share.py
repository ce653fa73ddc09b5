"""Percent of the traced window in which neither a kernel nor a copy ran
on the card, the mean over the cards a run uses, from the profiler's
device timeline.  Reads ``idle_share.<cells>`` for every kind of cell."""

from cardbench.trace import idle_share


def read(ctx):
    return idle_share(ctx.get("trace"))

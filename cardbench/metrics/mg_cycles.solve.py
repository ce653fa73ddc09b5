"""V-cycles a solve, the mean over the window's solves (the solver's
result; it repeats exactly for a pool of fields)."""


def read(ctx):
    cycles = ctx.get("cycles")
    return sum(cycles) / len(cycles) if cycles else None

"""Milliseconds of host-to-device and device-to-host copies on the card a
call, from the profiler's device timeline."""


def read(ctx):
    s = ctx.get("trace")
    if not s or not ctx.get("calls"):
        return None
    copy_s = sum(v for k, v in s["copies"].items()
                 if "HtoD" in k or "DtoH" in k)
    return 1e3 * copy_s / ctx["calls"] if copy_s > 0 else None

"""device_idle: the share of the profiled call's wall span that no device
activity's interval covers. Moves tpot_ms (the decode is host-paced)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

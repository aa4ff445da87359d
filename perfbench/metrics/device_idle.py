"""device_idle: the share of the profiled call's wall span that no device
activity's interval covers. Moves prompt_tok_s: the window holds the
host-paced decode."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

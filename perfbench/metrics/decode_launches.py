"""decode_launches: the host's launch calls (kernel launches, copies,
fills: ``spans.LAUNCH``) made inside the program's ``decode.step`` spans
of the profiled call, per decode step: what a fused or graphed step has
to cut. Moves prompt_tok_s: the window holds the decode."""

from perfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    n = spans.count(ctx.trace, "decode.step")
    if not n:
        return None
    return spans.launches_in(ctx.trace, "decode.step") / n

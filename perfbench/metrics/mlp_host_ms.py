"""mlp_host_ms: host milliseconds inside the program's ``decode.mlp`` spans
(norm2 and the dense MLP, or the MoE layer's dense all-expert combine),
summed over the layers, per decode step of the profiled call. Moves
prompt_tok_s: the window holds the decode."""

from perfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    n = spans.count(ctx.trace, "decode.step")
    if not n:
        return None
    return 1e3 * spans.host_s(ctx.trace, ("decode.mlp",)) / n

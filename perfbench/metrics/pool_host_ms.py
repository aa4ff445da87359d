"""pool_host_ms: host milliseconds inside the program's ``decode.append``
(the token's write and score, the rollover) and ``decode.evict`` (Alg.
3's page choice and eviction) spans, summed over the layers, per decode
step of the profiled call: Alg. 3's pool bookkeeping. Moves
prompt_tok_s: the window holds the decode."""

from perfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    n = spans.count(ctx.trace, "decode.step")
    if not n:
        return None
    return 1e3 * spans.host_s(ctx.trace, ("decode.append",
                                          "decode.evict")) / n

"""tpot_host_ms: the time per output token, read per layer because it is
too unsteady to bound end to end: all decode wall time of the window's
calls over all their decode steps, on the host's clock (each call's steps
one block ending in a synchronizing read). The host's issue of the
launches paces the decode, so the number follows the host's speed, which
swings from call to call. Moves prompt_tok_s: the window holds the
decode."""


def read(ctx):
    recs = ctx.window.records
    return 1e3 * sum(r.decode_s for r in recs) / sum(r.steps for r in recs)

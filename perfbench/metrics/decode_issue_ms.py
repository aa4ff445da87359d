"""decode_issue_ms: host milliseconds from entering decode_step to its
return, with no synchronize, meaned over the window's decode steps (the
host's launch work, which paces the decode). Moves prompt_tok_s: the
window holds the decode."""


def read(ctx):
    recs = ctx.window.records
    return 1e3 * sum(r.issue_s for r in recs) / sum(r.steps for r in recs)

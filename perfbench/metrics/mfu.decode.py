"""mfu.decode: the whole decode step's roofline share: the chip's least
time for each step (the larger of its operations at 989 TFLOP/s and its
bytes at 3.35 TB/s: weights read once, the live K / V pages once, the
logits written) over the window's decode wall time. Moves prompt_tok_s:
the window holds the decode."""

from perfbench import counts


def read(ctx):
    cfg = ctx.prog.cfg
    page = ctx.prog.ccfg.page_size
    least = wall = 0.0
    for r in ctx.window.records:
        B = len(r.call.lengths)
        L = len(r.pre.block_table)
        pages = r.pre.mapped_pages() / L            # per layer, all rows
        kept = sum(len(r.pre.live(0, b)) for b in range(B))
        for i in range(r.steps):
            ops, nbytes = counts.decode_step(cfg, B, pages,
                                             kept + B * (i + 1), page)
            least += counts.least_s(ops, nbytes)[0]
        wall += r.decode_s
    return counts.share(least, wall)

"""k1_roofline: K1's least time over the profiled call's decode steps (the
larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s: the mapped
pages' K / V and positions, q, the split partials and the fused norms
written) over its device time, summed by kernel name
(csrc/paged_attention.cu: paged_decode_kernel). The split merge
(combine_splits) is plain torch and not counted. Moves prompt_tok_s: the
window holds the decode."""

from perfbench import counts

PATTERN = r"paged_decode_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    dev_s, launches = ctx.trace.device_time(PATTERN)
    if not launches:
        return None
    r, prog = ctx.traced, ctx.prog
    B = len(r.call.lengths)
    L = len(r.pre.block_table)
    pages = r.pre.mapped_pages() / L
    kept = sum(len(r.pre.live(0, b)) for b in range(B))
    least = L * sum(counts.least_s(*counts.k1_call(
        prog.cfg, B, pages, kept + B * (i + 1), prog.ccfg.page_size,
        prog.decode["decode_splits"]))[0] for i in range(r.steps))
    if launches != L * r.steps:
        raise RuntimeError(f"K1 launched {launches} times, not "
                           f"{L} layers x {r.steps} steps")
    return counts.share(least, dev_s)

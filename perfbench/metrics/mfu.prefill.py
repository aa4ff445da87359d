"""mfu.prefill: the prefill's model operations (valid tokens only) over
its synchronized wall time (call start to first tokens on the host) at
989 TFLOP/s, summed over the window's calls. Moves ttft_s."""

from perfbench import counts


def read(ctx):
    cfg = ctx.prog.cfg
    recs = ctx.window.records
    flops = sum(counts.prefill_flops(cfg, r.call.lengths) for r in recs)
    wall = sum(r.ttft for r in recs)
    return counts.share(flops / counts.PEAK_BF16_FLOPS, wall)

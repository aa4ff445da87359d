"""k5_roofline: K5's least time (operations at 989 TFLOP/s or bytes at
3.35 TB/s, the larger; every causal pair of the padded rows it is handed)
over its device time in the profiled call, summed by kernel name
(csrc/flash_attention.cu: flash_tc_kernel, flash_f32_kernel,
flash_kernel). Moves ttft_s."""

from perfbench import counts

PATTERN = r"flash_(tc_|f32_)?kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    dev_s, launches = ctx.trace.device_time(PATTERN)
    if not launches:
        return None
    call = ctx.traced.call
    ops, nbytes = counts.k5_call(ctx.prog.cfg, len(call.lengths),
                                 call.padded_len)
    return counts.share(launches * counts.least_s(ops, nbytes)[0], dev_s)

"""compress_ms: device milliseconds of the activities launched inside the
program's ``prefill.compress`` spans (Alg. 2: scores, selection, gathers,
page writes), summed over the layers, per prefill of the profiled call;
each activity is tied to its launch call by their Kineto correlation id
(``spans.launched``), since the prefill's host runs ahead of the device.
Moves ttft_s."""

from perfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    n = spans.count(ctx.trace, "prefill")
    prof = spans.traced_profile(ctx)
    if not n or prof is None:
        return None
    return 1e3 * spans.device_s(ctx.trace, prof, ("prefill.compress",)) / n

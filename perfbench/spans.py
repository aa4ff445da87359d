"""The program's own spans in the profiled call (``repro_torch.obs.trace.
annotation``: host spans on the profile's clock, with no device mirror),
read off the ``Trace`` the harness hands the per-layer metrics.

- A host call or an instant of host time belongs to the innermost program
  span running then.
- A device activity belongs to the program span that was innermost when
  the host call that launched it ran. The two are linked by the Kineto
  correlation id that the launch call and its activity share, read from
  the finished profile (``traced_profile``): the ``Trace`` keeps no ids,
  and time cannot link them, since the prefill's host runs ahead of its
  kernels.

Run as a script on a card, it prints the table of one traced call of a
cell by span (host ms, launch calls, device ms and idle ms charged to
each, per decode step and per prefill), and with ``--cost N`` the traced
call's wall time and device idle share in N pairs of calls with and
without the program's spans, in one process:

    python3 perfbench/spans.py --workload nemo12b.longdoc --seed 7
"""
from __future__ import annotations

import re
import sys
from collections import defaultdict
from pathlib import Path

# the program's spans (src/repro_torch/models/transformer.py, moe.py,
# core/decode.py)
PREFILL = ("prefill", "prefill.attn", "prefill.mlp", "prefill.compress",
           "prefill.logits", "moe.dispatch", "moe.experts", "moe.combine")
DECODE = ("decode.step", "decode.qkv", "decode.append", "decode.attn",
          "decode.evict", "decode.mlp", "decode.logits")
SPANS = frozenset(PREFILL + DECODE)
# host calls that put work on the device's queue: kernel launches by the
# runtime and the driver API, copies and fills
LAUNCH = re.compile(r"^(cudaLaunchKernel(ExC)?|cuLaunchKernel(Ex)?|"
                    r"cudaMemcpyAsync|cudaMemsetAsync)$")


def program_spans(trace, names=SPANS) -> list:
    """The host entries of the program's spans named in ``names``, in
    time order, outer before inner."""
    return sorted((h for h in trace.host if h[0] in names),
                  key=lambda t: (t[1], -t[2]))


def launch_calls(trace) -> list:
    """The host's launch calls, in time order."""
    return sorted((h for h in trace.host if LAUNCH.match(h[0])),
                  key=lambda t: t[1])


def innermost(spans: list, times: list) -> list:
    """For each of ``times`` (ascending), the innermost of ``spans`` (in
    ``program_spans`` order) running then, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def count(trace, name: str) -> int:
    """How many times the span ``name`` ran."""
    return sum(1 for h in trace.host if h[0] == name)


def host_s(trace, names) -> float:
    """Host seconds inside the program spans ``names``, summed."""
    return sum(e - s for n, s, e in trace.host if n in names)


def launches_in(trace, name: str) -> int:
    """Launch calls made while a span ``name`` ran."""
    spans = program_spans(trace, (name,))
    return sum(1 for o in innermost(spans, [c[1] for c in
                                            launch_calls(trace)]) if o)


def traced_profile(ctx):
    """The finished profile the context's trace was read from:
    ``ctx.profile`` where the context carries it, else the
    ``torch.profiler.profile`` that a calling frame holds (the harness
    keeps it while its readers run, beside the ``Trace`` it built from
    it); None without one."""
    prof = getattr(ctx, "profile", None)
    if prof is not None:
        return prof
    from torch.profiler import profile
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, profile):
                return value
        frame = frame.f_back
    return None


def launched(prof) -> list:
    """(start s, end s, host start s of its launch call) of the device
    activities of ``prof`` that ``Trace.from_profile`` counts as device
    work (no span's mirror), each found by the correlation id its launch
    call shares; those whose call the profile lacks are left out. Times
    on the trace's clock."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    base = res.trace_start_ns()
    calls, dev = {}, []
    for e in res.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and \
                    not name.startswith("perfbench."):
                dev.append((e.start_ns(), e.duration_ns(),
                            e.correlation_id()))
        elif LAUNCH.match(name):
            calls[e.correlation_id()] = e.start_ns()
    return [((s - base) * 1e-9, (s + d - base) * 1e-9,
             (calls[c] - base) * 1e-9) for s, d, c in dev if c in calls]


def charged(trace, acts: list) -> list:
    """(innermost program span at the launch or None, device s) of each
    of ``acts`` (``launched``'s)."""
    acts = sorted(acts, key=lambda a: a[2])
    owners = innermost(program_spans(trace), [a[2] for a in acts])
    return [(o and o[0], e - s) for o, (s, e, _) in zip(owners, acts)]


def device_s(trace, prof, names) -> float:
    """Device seconds of the activities launched inside the program spans
    ``names`` (the innermost program span at the launch)."""
    return sum(d for o, d in charged(trace, launched(prof)) if o in names)


def table(trace, prof=None) -> dict:
    """Per program span: [count, host s (the span's whole time), launch
    calls, device s, idle s], the last three charged to the innermost
    program span (device s: of the activities linked to their launch,
    with ``prof``); idle s are the device's idle gaps inside the call by
    the innermost program span at each gap's middle. Key None: what no
    program span holds."""
    spans = program_spans(trace)
    out: dict = defaultdict(lambda: [0, 0.0, 0, 0.0, 0.0])
    for n, s, e in spans:
        out[n][0] += 1
        out[n][1] += e - s
    for o in innermost(spans, [c[1] for c in launch_calls(trace)]):
        out[o and o[0]][2] += 1
    for o, d in charged(trace, launched(prof)) if prof is not None else ():
        out[o][3] += d
    busy = trace.busy_intervals()
    lo, hi = trace.span
    edges = [lo] + [x for b in busy for x in b] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    for (s, e), o in zip(gaps, innermost(spans, [0.5 * (s + e)
                                                 for s, e in gaps])):
        out[o and o[0]][4] += e - s
    return dict(out)


def main() -> int:
    import argparse
    import contextlib
    import time
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    from perfbench import harness
    from perfbench.spec import load_cell
    from perfbench.trace import Trace
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost", type=int, default=0, metavar="PAIRS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the table is read on the card only")
        return 3
    print(f"card: {torch.cuda.get_device_name(0)}")
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.build import build_all
    from repro_torch.obs import trace as obs_trace
    build_all()
    cell = load_cell(args.workload)
    prog = harness.setup(cell, args.seed, torch.device("cuda"))
    harness.warm_up(prog, cell, args.seed)

    def traced():
        t = time.perf_counter()
        _, prof = harness.profile_call(prog, cell, args.seed)
        return prof, Trace.from_profile(prof), time.perf_counter() - t

    prof, tr, call_s = traced()
    acts = launched(prof)
    print(f"traced call {tr.window_s:.4f} s (profile {call_s:.1f} s), "
          f"device busy {tr.busy_s:.4f} s; {len(acts)} of "
          f"{len(tr.device)} device activities linked to their launch")
    n_dec, n_pre = count(tr, "decode.step"), count(tr, "prefill")
    print(f"{'span':18} {'count':>6} {'host ms':>10} {'launches':>9} "
          f"{'device ms':>10} {'idle ms':>9}   (per decode step / per "
          f"prefill; {n_dec} steps, {n_pre} prefills)")
    rows = table(tr, prof)
    for name in PREFILL + DECODE + (None,):
        if name not in rows:
            continue
        c, h, k, d, i = rows[name]
        per = n_dec if name in DECODE else max(n_pre, 1)
        print(f"{str(name):18} {c / per:6.1f} {1e3 * h / per:10.3f} "
              f"{k / per:9.1f} {1e3 * d / per:10.3f} {1e3 * i / per:9.3f}")
    del prof, tr, acts
    record = obs_trace._RecordFunctionFast
    for i in range(2 * args.cost):
        spans_on = i % 4 in (0, 3)          # on, off, off, on, ...
        obs_trace._RecordFunctionFast = record if spans_on else \
            (lambda name: contextlib.nullcontext())
        prof, tr, _ = traced()
        obs_trace._RecordFunctionFast = record
        print(f"cost: spans {'on ' if spans_on else 'off'} traced call "
              f"{tr.window_s:.4f} s, device idle "
              f"{100 * (1 - tr.busy_s / tr.window_s):.4f}%, program "
              f"spans {len(program_spans(tr))}", flush=True)
        del prof, tr
    return 0


if __name__ == "__main__":
    sys.exit(main())

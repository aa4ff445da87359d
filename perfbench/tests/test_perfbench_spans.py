"""The readers of the program's spans (``perfbench/spans.py`` and the four
metrics that use it) on hand-built traces, and on the CPU profile of a
tiny cell's call, whose host spans are the program's own."""
import pytest

import pb_tiny
from perfbench import harness, spans
from perfbench.spec import metric_reader
from perfbench.trace import Trace

READERS = ("decode_launches", "pool_host_ms", "mlp_host_ms", "compress_ms")


class Ctx:
    def __init__(self, trace, profile=None):
        self.trace = trace
        self.profile = profile


class _Event:
    """What ``spans.launched`` reads of a raw Kineto event."""

    def __init__(self, name, start, end, corr, device):
        self._n, self._s, self._e, self._c = name, start, end, corr
        self._d = device

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return round(self._s * 1e9)

    def duration_ns(self):
        return round((self._e - self._s) * 1e9)

    def correlation_id(self):
        return self._c


class _Profile:
    """A finished profile's raw events: ``host`` and ``device`` entries,
    the i-th launch call correlated with the i-th device activity of
    ``links`` (index pairs)."""

    def __init__(self, host, device, links):
        corr = {}
        for k, (h, d) in enumerate(links):
            corr[("h", h)] = corr[("d", d)] = 100 + k
        events = [_Event(*t, corr.get(("h", i), 0), False)
                  for i, t in enumerate(host)]
        events += [_Event(*t, corr.get(("d", i), 0), True)
                   for i, t in enumerate(device)]
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events

    def trace_start_ns(self):
        return 0


def _read(trace, profile=None) -> dict:
    return {m: metric_reader(m)(Ctx(trace, profile)) for m in READERS}


def _trace():
    """A call of one prefill (two layers' compress) and two decode steps,
    and its profile. The prefill's host runs ahead: its compress kernels
    start on the device after the host has left the span."""
    host = [("perfbench.call", 0.0, 20.0),
            ("prefill", 0.0, 4.0),
            ("prefill.attn", 0.0, 1.0), ("cudaLaunchKernel", 0.1, 0.2),
            ("prefill.compress", 1.0, 2.0), ("cudaLaunchKernel", 1.1, 1.2),
            ("cudaMemcpyAsync", 1.3, 1.4),
            ("prefill.compress", 2.0, 3.0), ("cudaLaunchKernel", 2.1, 2.2),
            ("prefill.logits", 3.0, 4.0), ("cudaLaunchKernel", 3.1, 3.2)]
    dev = [("flash_tc_kernel", 0.5, 5.0), ("topk_kernel", 5.0, 6.0),
           ("Memcpy DtoD (Device -> Device)", 6.0, 6.5),
           ("gather_kernel", 6.5, 7.5), ("gemm", 7.5, 8.0)]
    for t in (10.0, 15.0):
        host += [("decode.step", t, t + 4.0),
                 ("decode.append", t + 0.5, t + 1.0),
                 ("cudaLaunchKernel", t + 0.6, t + 0.7),
                 ("decode.attn", t + 1.0, t + 1.5),
                 ("cudaLaunchKernelExC", t + 1.1, t + 1.2),
                 ("decode.evict", t + 1.5, t + 3.0),
                 ("cudaLaunchKernel", t + 1.6, t + 1.7),
                 ("cudaMemsetAsync", t + 1.8, t + 1.9),
                 ("aten::where", t + 2.0, t + 2.5),
                 ("decode.mlp", t + 3.0, t + 3.5),
                 ("cudaLaunchKernel", t + 3.1, t + 3.2),
                 ("cudaStreamSynchronize", t + 3.6, t + 3.7)]
        dev += [("write_kernel", t + 0.7, t + 0.8),
                ("paged_decode_kernel", t + 1.2, t + 1.4),
                ("where_kernel", t + 1.7, t + 1.75),
                ("Memset (Device)", t + 1.9, t + 1.95),
                ("gemm", t + 3.2, t + 3.4)]
    calls = [i for i, h in enumerate(host) if spans.LAUNCH.match(h[0])]
    # every launch call made the device activity of its rank, as on one
    # stream: the link is by correlation id all the same
    prof = _Profile(host, dev, list(zip(calls, range(len(dev)))))
    return Trace(device=dev, host=host, span=(0.0, 20.0)), prof


def test_readers_on_a_hand_built_trace():
    tr, prof = _trace()
    got = _read(tr, prof)
    assert got["decode_launches"] == 5.0
    assert got["pool_host_ms"] == pytest.approx(1e3 * 2.0)
    assert got["mlp_host_ms"] == pytest.approx(1e3 * 0.5)
    # linked to the launch, not by time: the compress kernels, copy
    # included, ran at 5.0-7.5, after the host left both compress spans
    assert got["compress_ms"] == pytest.approx(1e3 * 2.5)


def test_device_activities_follow_their_correlation_id():
    """An activity lost from the profile, or one without its launch call,
    moves no other activity to another launch."""
    tr, prof = _trace()
    prof._events = [e for e in prof._events if e.name() != "topk_kernel"]
    for e in prof._events:
        if e.name() == "gather_kernel":
            e._c = 7
    assert _read(tr, prof)["compress_ms"] == pytest.approx(1e3 * 0.5)
    assert len(spans.launched(prof)) == len(tr.device) - 2


def test_table_charges_the_innermost_program_span():
    tr, prof = _trace()
    rows = spans.table(tr, prof)
    assert rows["decode.step"][:4] == [2, 8.0, 0, 0.0]
    assert rows["decode.evict"][2] == 4
    assert rows["decode.evict"][3] == pytest.approx(0.2)
    assert rows["prefill.compress"][3] == pytest.approx(2.5)
    assert rows["prefill.attn"][3] == pytest.approx(4.5)
    # idle, by the innermost program span at each gap's middle: the gaps
    # between the calls' steps lie outside every span
    assert rows[None][4] == pytest.approx(2.7 + 2.3 + 1.6)
    assert rows["decode.evict"][4] == pytest.approx(2 * (0.3 + 0.15 + 1.25))
    assert rows["decode.attn"][4] == pytest.approx(2 * 0.4)
    assert rows["prefill.attn"][4] == pytest.approx(0.5)
    assert spans.table(tr)["prefill.compress"][3] == 0.0


def test_the_parents_trace_reads_nothing():
    """A trace without the program's spans (the port before them), or no
    trace: every reader falls silent, none raises."""
    tr, prof = _trace()
    tr.host = [h for h in tr.host if h[0] not in spans.SPANS]
    assert _read(tr, prof) == dict.fromkeys(READERS)
    assert _read(None) == dict.fromkeys(READERS)


def test_the_harness_profile_is_found_from_a_reader():
    """Without ``ctx.profile`` the link reads the profile a calling frame
    holds, as ``harness.execute`` holds the traced call's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass

    def reader():
        return spans.traced_profile(object())
    assert reader() is prof
    del prof
    assert reader() is None


def test_readers_on_the_cpu_profile_of_a_tiny_call():
    """The tiny nemo cell's call profiled on the CPU: the program's spans
    reach the trace's host entries; no launch, no device activity."""
    cell = pb_tiny.tiny_cell("mistral-nemo-12b")
    prog = harness.setup(cell, 2 ** 33 + 3, "cpu")
    rec, prof = harness.profile_call(prog, cell, 2 ** 33 + 3)
    tr = Trace.from_profile(prof)
    L = prog.cfg.num_layers
    steps = cell.traffic["decode_steps"]
    count = {n: sum(h[0] == n for h in tr.host) for n in spans.SPANS}
    assert count["decode.step"] == steps and count["prefill"] == 1
    assert count["decode.evict"] == L * steps
    assert count["prefill.compress"] == L
    got = _read(tr, prof)
    assert got["decode_launches"] == 0 and got["compress_ms"] == 0
    assert 0 < got["mlp_host_ms"] and 0 < got["pool_host_ms"]
    step_ms = 1e3 * spans.host_s(tr, ("decode.step",)) / steps
    assert got["pool_host_ms"] + got["mlp_host_ms"] < step_ms

"""The trace read from a profile's raw events holds what torch's own
parse of them holds (checked on the host's events, the ones a CPU
profile has), and the idle gaps are charged to the innermost host span."""
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import pb_tiny  # noqa: F401  (paths)
from perfbench.trace import Trace


def _profile():
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("perfbench.call"):
            for _ in range(3):
                with record_function("perfbench.decode_step"):
                    x = torch.tanh(x + 1) * 0.5
    return prof


def test_raw_events_match_torchs_parse():
    prof = _profile()
    tr = Trace.from_profile(prof)
    want = sorted((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                  for e in prof.events() if e.device_type == DeviceType.CPU)
    got = sorted(tr.host)
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for (_, s, e), (_, ws, we) in zip(got, want):
        assert s == pytest.approx(ws, abs=1e-6)
        assert e == pytest.approx(we, abs=1e-6)
    call = [t for t in want if t[0] == "perfbench.call"][0]
    assert tr.span == pytest.approx(call[1:], abs=1e-6)
    assert tr.device == [] and tr.window_s > 0


def test_idle_gaps_go_to_the_innermost_host_span():
    tr = Trace(device=[("k", 1.0, 2.0), ("k", 3.0, 4.0)],
               host=[("perfbench.call", 0.0, 5.0), ("step", 2.0, 3.5),
                     ("aten::add", 2.2, 2.8)],
               span=(0.0, 5.0))
    assert tr.busy_s == pytest.approx(2.0)
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"perfbench.call": 2.0, "aten::add": 1.0})

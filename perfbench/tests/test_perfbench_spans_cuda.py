"""On the card: the program's spans in a tiny cell's traced run."""
import time

import pytest
import torch

import pb_tiny
from perfbench import harness, spans
from perfbench.trace import Trace

READERS = ("decode_launches", "pool_host_ms", "mlp_host_ms", "compress_ms")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "mixtral-8x7b"])
def test_program_spans_on_the_card(arch):
    """The four readers report; no program span is mirrored among the
    device's activities; every device activity is linked to its launch
    call; every activity launched inside a ``decode.step`` starts after
    the span starts (one clock); the launch count repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = pb_tiny.tiny_cell(arch, limits={
        "token_gap": 1e-2, "kept_miss": 0.05, "evict_gap": 0.0})
    line = harness.execute(cell, 2 ** 31 + 7, 0.5, True, "cuda",
                           time.time(), log=lambda *a: None)
    assert line["correct"], line["check"]
    assert set(READERS) <= set(line["metrics"]), line["metrics"]
    prog = harness.setup(cell, 2 ** 31 + 7, torch.device("cuda"))
    harness.warm_up(prog, cell, 2 ** 31 + 7)
    counts = []
    for _ in range(2):
        _, prof = harness.profile_call(prog, cell, 2 ** 31 + 7)
        tr = Trace.from_profile(prof)
        assert not {n for n, _, _ in tr.device} & spans.SPANS
        acts = sorted(spans.launched(prof), key=lambda a: a[2])
        assert len(acts) == len(tr.device) > 0
        steps = spans.program_spans(tr, ("decode.step",))
        owners = spans.innermost(steps, [a[2] for a in acts])
        inside = [(a, o) for a, o in zip(acts, owners) if o]
        assert inside and all(a[0] >= o[1] for a, o in inside)
        counts.append(spans.launches_in(tr, "decode.step"))
    assert counts[0] == counts[1] > 0

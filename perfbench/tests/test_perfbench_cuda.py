"""On the card: a tiny cell through the kernels and the whole run."""
import time

import pytest
import torch

import pb_tiny
from perfbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(pb_tiny.CELL),
                         ids=list(pb_tiny.CELL.values()))
def test_tiny_cell_on_the_card(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arch, policy = arch
    cell = pb_tiny.tiny_cell(arch, policy=policy, limits={
        "token_gap": 1e-2, "kept_miss": 0.05, "evict_gap": 0.0})
    line = harness.execute(cell, 2 ** 31 + 5, 0.5, True, "cuda",
                           time.time(), log=lambda *a: None)
    assert line["correct"], line["check"]
    assert line["device"]["busy_s"] > 0
    assert "k5_roofline" in line["metrics"] and "k1_roofline" in \
        line["metrics"]

"""The plain reference against the port at a reduced size on the CPU
(f32, so both sides agree to rounding), and the control: the reference
in fp8 put in the program's place fails the check."""
import time

import pytest
import torch

import pb_tiny
from perfbench import harness, traffic as tm
from perfbench.check import control_reading, program_numbers
from perfbench.reference.model import Reference


def _tiny(arch):
    cell = pb_tiny.tiny_cell(arch)
    if cell.config["model"].get("num_local_experts"):
        # drops in the prefill's capacity dispatch
        cell.config["model"]["moe_capacity_factor"] = 0.5
    return cell


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "mixtral-8x7b"])
def test_reference_agrees_with_the_port(arch):
    line = harness.execute(_tiny(arch), 2 ** 31 + 11, 0.5, False, "cpu",
                           time.time(), log=lambda *a: None)
    assert line["correct"], line["check"]
    for k, v in line["check"].items():
        assert v["value"] <= 1e-4, (k, v)


def test_capacity_drops_happen_in_the_tiny_mixtral():
    from repro_torch.models import moe
    cell = _tiny("mixtral-8x7b")
    prog = harness.setup(cell, 5, "cpu")
    x = torch.randn((1, 256, prog.cfg.d_model), generator=torch.Generator(
        ).manual_seed(0))
    _, stats = moe.moe_forward(prog.params["layers"][0]["moe"], prog.cfg, x)
    assert float(stats.dropped) > 0


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "mixtral-8x7b"])
def test_control_fails_the_check(arch):
    """The control at a size a test run holds: its numbers, judged by the
    f32 reference, exceed the limits that sound runs of the program meet
    here."""
    cell = _tiny(arch)
    prog = harness.setup(cell, 3, "cpu")
    call = tm.make_call(cell.traffic, prog.cfg.vocab_size, 3, 0)
    rec = harness.run_call(prog, call, cell.traffic["decode_steps"])
    ccfg = cell.config["cache"]
    ref = Reference(prog.params, cell.config)
    ctl = Reference(prog.params, cell.config, "fp8")
    failed = []
    for row in range(len(call.lengths)):
        sound, _ = program_numbers(ref, rec, row, ccfg)
        assert all(sound[k] <= v for k, v in cell.limits.items()), sound
        c = control_reading(ref, ctl, rec, row, ccfg)
        failed.append(any(c[k] > v for k, v in cell.limits.items()))
    assert all(failed)

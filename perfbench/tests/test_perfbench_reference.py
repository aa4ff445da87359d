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

CELLS = list(pb_tiny.CELL)
IDS = [pb_tiny.CELL[k] for k in CELLS]


def _tiny(arch, policy="paged_eviction"):
    cell = pb_tiny.tiny_cell(arch, policy=policy)
    if cell.config["model"].get("num_local_experts"):
        # drops in the prefill's capacity dispatch
        cell.config["model"]["moe_capacity_factor"] = 0.5
    return cell


@pytest.mark.parametrize("arch", CELLS, ids=IDS)
def test_reference_agrees_with_the_port(arch):
    line = harness.execute(_tiny(*arch), 2 ** 31 + 11, 0.5, False, "cpu",
                           time.time(), log=lambda *a: None)
    assert line["correct"], line["check"]
    for k, v in line["check"].items():
        assert v["value"] <= 1e-4, (k, v)


def test_full_keeps_every_token_and_never_evicts():
    """Under ``full`` the reference keeps every prompt token, decodes over
    every position and evicts nothing: its own start is the prompt's pages
    in the program's slab of ceil((padded + T) / page) slots."""
    cell = _tiny("mistral-nemo-12b", "full")
    prog = harness.setup(cell, 7, "cpu")
    call = tm.make_call(cell.traffic, prog.cfg.vocab_size, 7, 0)
    T = cell.traffic["decode_steps"]
    n, page = int(call.lengths[0]), cell.config["cache"]["page_size"]
    ref = Reference(prog.params, cell.config)
    res = ref.run(torch.as_tensor(call.tokens[0, :n]),
                  torch.zeros(T + 1, dtype=torch.long), call.padded_len)
    for lay in res.layers:
        assert lay.kept.tolist() == list(range(n))
        assert lay.final == set(range(n + T))
        slots, head = lay.start
        assert len(slots) == -(-(call.padded_len + T) // page)
        assert head == -(-n // page)


@pytest.mark.parametrize("policy", ["streaming_llm", "inverse_key_l2",
                                    "keydiff"])
def test_reference_refuses_other_policies(policy):
    cell = _tiny("mistral-nemo-12b", policy)
    with pytest.raises(ValueError, match=policy):
        Reference({}, cell.config)


def test_capacity_drops_happen_in_the_tiny_mixtral():
    from repro_torch.models import moe
    cell = _tiny("mixtral-8x7b")
    prog = harness.setup(cell, 5, "cpu")
    x = torch.randn((1, 256, prog.cfg.d_model), generator=torch.Generator(
        ).manual_seed(0))
    _, stats = moe.moe_forward(prog.params["layers"][0]["moe"], prog.cfg, x)
    assert float(stats.dropped) > 0


@pytest.mark.parametrize("arch", CELLS, ids=IDS)
def test_control_fails_the_check(arch):
    """The control at a size a test run holds: its numbers, judged by the
    f32 reference, exceed the limits that sound runs of the program meet
    here."""
    cell = _tiny(*arch)
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

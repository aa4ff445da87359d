"""A run with the timed path broken underneath, the look for a card
skipped: each fault the cells can have makes ``correct`` false, judged by
the cell's own limits (``limits/<cell>.json``) on the tiny family of its
architecture under its policy. (The exchange between chips is no fault
here: every cell has one chip.)"""
import time

import pytest
import torch

import pb_tiny
from perfbench import harness
from perfbench.spec import load_cell


def _run(cell):
    return harness.execute(cell, 2 ** 31 + 3, 0.3, False, "cpu",
                           time.time(), log=lambda *a: None)


def _cell(key):
    arch, policy = key
    cell = pb_tiny.tiny_cell(arch, rows=2, policy=policy,
                             limits=load_cell(pb_tiny.CELL[key]).limits)
    cell.traffic["check_requests"] = 4
    return cell


CELLS = list(pb_tiny.CELL)
EVICTING = [k for k in CELLS if k[1] != "full"]
IDS = [pb_tiny.CELL[k] for k in CELLS]


@pytest.mark.parametrize("arch", CELLS, ids=IDS)
def test_sound_run_is_correct(arch):
    line = _run(_cell(arch))
    assert line["correct"], line["check"]
    assert line["check"]["evict_gap"]["value"] == 0.0


@pytest.mark.parametrize("arch", CELLS, ids=IDS)
def test_step_that_returns_its_state_unchanged(arch, monkeypatch):
    """decode_append writes nothing and evicts nothing: the step attends
    to the cache as the prefill left it."""
    from repro_torch.models import transformer

    def unchanged(cache, k, v, pos, policy, cfg, active=None, attend=None):
        attend(cache)
    monkeypatch.setattr(transformer, "decode_append", unchanged)
    line = _run(_cell(arch))
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("arch", CELLS, ids=IDS)
def test_half_the_batch_left_out(arch, monkeypatch):
    """The prefill runs the first half of the rows and hands their answer
    to the rest."""
    from repro_torch.models import transformer
    orig = transformer.forward_prefill

    def half(params, cfg, tokens, policy, ccfg, valid=None, **kw):
        h = tokens.shape[0] // 2
        t = torch.cat([tokens[:h]] * 2)
        v = torch.cat([valid[:h]] * 2)
        return orig(params, cfg, t, policy, ccfg, valid=v, **kw)
    monkeypatch.setattr(transformer, "forward_prefill", half)
    line = _run(_cell(arch))
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("arch", CELLS, ids=IDS)
@pytest.mark.parametrize("where", ["forward_prefill", "decode_step"])
def test_token_altered_where_produced(arch, where, monkeypatch):
    """The logits that give a served token come out shifted by one id."""
    from repro_torch.models import transformer
    orig = getattr(transformer, where)

    def shifted(*a, **kw):
        logits, cache = orig(*a, **kw)
        return logits.roll(1, -1), cache
    monkeypatch.setattr(transformer, where, shifted)
    line = _run(_cell(arch))
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("arch", EVICTING,
                         ids=[pb_tiny.CELL[k] for k in EVICTING])
@pytest.mark.parametrize("fault", ["none", "second", "scores"])
def test_eviction_goes_wrong(arch, fault, monkeypatch):
    """Alg. 3's step evicts no page, the second-lowest full page instead
    of the lowest, or ranks the pages by scores the attention's fused
    epilogue got wrong (a page's own score times its slot + 1; on the
    CPU, where no epilogue runs, the scores the policy reads)."""
    from repro_torch.core import policies
    orig = policies.PagedEviction.post_write
    if fault == "none":
        monkeypatch.setattr(policies, "evict_page",
                            lambda cache, victim, enable=None: cache)
    elif fault == "second":
        def argmin_second(x, dim=-1):
            return torch.topk(x, 2, dim=dim, largest=False).indices[..., 1]
        monkeypatch.setattr(policies.torch, "argmin", argmin_second)
    else:
        def skewed(self, cache, cfg, active=None, page_scores=None):
            ps = cache.page_scores() if page_scores is None else page_scores
            page_scores = ps * torch.arange(1, ps.shape[-1] + 1,
                                            device=ps.device)
            return orig(self, cache, cfg, active=active,
                        page_scores=page_scores)
        monkeypatch.setattr(policies.PagedEviction, "post_write", skewed)
    line = _run(_cell(arch))
    assert not line["correct"], line["check"]


def test_program_that_evicts_fails_the_full_check(monkeypatch):
    """The program runs PagedEviction (Alg. 2 to the budget, Alg. 3's
    evictions) where the configuration states the full cache."""
    from repro_torch.core import policies
    orig = policies.get_policy
    monkeypatch.setattr(policies, "get_policy",
                        lambda name, **kw: orig("paged_eviction", **kw))
    line = _run(_cell(("mistral-nemo-12b", "full")))
    assert not line["correct"], line["check"]

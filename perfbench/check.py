"""Whether the window's answers are right: a sample of its finished
requests, drawn from the seed with the longest in it, each run once more
by the plain reference over its prompt and the tokens the program served.

The numbers, each compared against its limit in ``limits/<cell>.json``
where that file names it:

- ``token_gap``: the widest gap, over every token a request was served,
  by which the reference's logit of it lies below the reference's best;
  ``prefill_gap`` that of the prefill's token alone (the last prompt
  token's logits: the decoder, the MoE capacity rule, K5);
- ``decode_gap_med``: the median (the lower middle) of a request's gaps
  over its decode steps' tokens (the decode through the evicting paged
  cache, K1 and its page scores), the worst over the requests;
- ``prefill_logit_err``: the distance of the program's prefill logits
  (the last prompt token's, over the whole vocabulary) from the
  reference's, relative to the spread of the reference's own, the worst
  over the requests; ``prefill_logit_err_min`` the least over them (a MoE
  model's router meets bf16 on near ties on some requests, which moves
  their logits as far as a lower precision does; a request that meets
  none still judges the prefill's last layers, norm and head);
- ``kept_miss``: the largest share, over layers and requests, of the
  positions the reference keeps after Alg. 2 that the program's pages do
  not hold; ``kept_miss_mean``: that share meaned over the layers, the
  worst over the requests;
- ``evict_gap``: over layers and requests, by how much the reference's
  mean token score of the page the program evicted lies above the lowest
  of the pages Alg. 3 could evict, relative to that lowest: Alg. 3 is
  replayed from the program's own pages after the prefill, and the page
  the program's final state lacks must be one of the full pages at the
  step that evicts (1.0 when it is not, or when the final state is not
  the pages less that one). Under a policy that never evicts (``full``)
  it reads 0 when the final state is the start and the decode's own
  tokens, 1 otherwise.

The decode is followed from the program's own pages after its prefill:
the reference decodes over the positions the program kept (their keys and
values its own), so that the decode gaps and ``evict_gap`` judge the
decode and not the few tokens at the edge of the budget on which bf16 and
f32 scores rank apart; that start is judged by ``kept_miss`` against the
reference's own selection.

A cell compares the numbers its limits file names; the others are printed
as readings. The reference is the one its configuration names
(``spec.reference``; ``reference/__init__.py`` gives its interface). It
runs after the window, one request and one layer at a time, on the
weights both sides were handed.
"""
from __future__ import annotations

import sys

import torch

from perfbench import spec, traffic as traffic_mod
from perfbench.reference.model import alg3

NUMBERS = ("token_gap", "prefill_gap", "prefill_logit_err",
           "decode_gap_med", "kept_miss", "kept_miss_mean", "evict_gap")


def gaps(logits: torch.Tensor, served) -> torch.Tensor:
    """(T + 1,) the reference's best logit minus its logit of each served
    token."""
    s = torch.as_tensor(served, device=logits.device).long()
    return logits.max(-1).values - logits.gather(1, s[:, None])[:, 0]


def logit_err(logits: torch.Tensor, ref: torch.Tensor) -> float:
    """The distance of a side's logits over the vocabulary from the
    reference's, relative to the spread of the reference's own."""
    ref = ref.float()
    d = logits.to(ref.device, torch.float32) - ref
    return float(d.norm() / (ref - ref.mean()).norm())


def evict_gap(start: tuple, final: set, scores: list, n: int, T: int,
              ccfg: dict) -> float:
    """Alg. 3 of the policy of ``ccfg`` replayed from ``start`` = (slots,
    head) over T decode tokens, ranked by ``scores``, against the ``final``
    live positions the side judged was left with (see the module's
    ``evict_gap``)."""
    alg = alg3(start, scores, ccfg)
    for i in range(T):
        alg.write(n + i)
    had = {t for s in start[0] if s for t in s} | set(range(n, n + T))
    gone = had - final
    if not alg.evictions:
        return 0.0 if not gone and final == had else 1.0
    if len(alg.evictions) > 1:
        want = {t for _, page in alg.evictions for t in page}
        return 0.0 if gone == want and final == had - want else 1.0
    full, _ = alg.evictions[0]
    if final != had - gone or sorted(gone) not in [sorted(p) for p in full]:
        return 1.0
    mean = lambda p: sum(scores[t] for t in p) / len(p)
    lo = min(mean(p) for p in full)
    return (mean(sorted(gone)) - lo) / abs(lo)


def evict_choices(start: tuple, scores: list, n: int, T: int,
                  ccfg: dict) -> list:
    """At the first eviction of Alg. 3 replayed from ``start`` over T decode
    tokens: each full page's mean score above the lowest, relative to the
    lowest, ascending (what ``evict_gap`` reads for each choice of victim);
    empty without an eviction that chooses among full pages."""
    alg = alg3(start, scores, ccfg)
    for i in range(T):
        alg.write(n + i)
        if alg.evictions:
            break
    if not alg.evictions or not alg.evictions[0][0]:
        return []
    means = sorted(sum(scores[t] for t in p) / len(p)
                   for p in alg.evictions[0][0])
    return [(m - means[0]) / abs(means[0]) for m in means]


def follow_pages(pre, row: int, n: int) -> tuple[list, bool]:
    """The program's pages after its prefill, per layer (slots, head),
    positions outside the prompt dropped; whether any were."""
    out, bad = [], False
    for li in range(len(pre.block_table)):
        slots = []
        for s in pre.positions(li, row):
            if s is not None:
                bad |= any(not 0 <= t < n for t in s)
                s = [t for t in s if 0 <= t < n]
            slots.append(s)
        out.append((slots, int(pre.cur_page[li][row])))
    return out, bad


def request_numbers(res, rec, row: int, ccfg: dict, follow: list,
                    bad: bool) -> dict:
    """The numbers of one request against the reference's result, which
    followed the program's pages ``follow``."""
    n, T = int(rec.call.lengths[row]), rec.steps
    misses, ev = [], 0.0
    for li, lay in enumerate(res.layers):
        ref_kept = set(lay.kept.tolist())
        prog_kept = rec.pre.live(li, row)
        misses.append(1.0 - len(ref_kept & prog_kept) / len(ref_kept))
        ev = max(ev, 1.0 if bad else evict_gap(
            follow[li], rec.post.live(li, row), lay.scores.tolist(), n, T,
            ccfg))
    return _numbers(gaps(res.logits, rec.served[row]),
                    logit_err(rec.prefill_logits[row], res.logits[0]),
                    misses, ev)


def _numbers(g: torch.Tensor, err: float, misses: list, ev: float) -> dict:
    return {"token_gap": float(g.max()), "prefill_gap": float(g[0]),
            "prefill_logit_err": err,
            "decode_gap_med": float(g[1:].median()) if len(g) > 1 else 0.0,
            "kept_miss": max(misses),
            "kept_miss_mean": sum(misses) / len(misses), "evict_gap": ev}


def worst(per_request: list) -> dict:
    """The worst of each number over the sample; and
    ``prefill_logit_err_min``, the least prefill logit distance of any
    request in it."""
    out = {k: max(r[k] for r in per_request) for k in NUMBERS}
    out["prefill_logit_err_min"] = min(r["prefill_logit_err"]
                                       for r in per_request)
    return out


def _inputs(rec, row: int):
    n = int(rec.call.lengths[row])
    return (n, torch.as_tensor(rec.call.tokens[row, :n]),
            torch.as_tensor(rec.served[row]))


def program_numbers(ref, rec, row: int, ccfg: dict):
    """(the numbers of request ``row`` of the call ``rec``, the reference's
    result), the reference following the program's pages."""
    n, prompt, served = _inputs(rec, row)
    follow, bad = follow_pages(rec.pre, row, n)
    res = ref.run(prompt, served, rec.call.padded_len, follow=follow)
    try:
        return request_numbers(res, rec, row, ccfg, follow, bad), res
    except Exception as exc:            # a state no sound run leaves
        print(f"check of row {row} failed: {exc!r}", file=sys.stderr)
        return {k: 1e30 for k in NUMBERS}, res


def control_reading(ref, ctl, rec, row: int, ccfg: dict) -> dict:
    """The control's numbers over request ``row``'s prompt and served
    tokens: ``ctl`` (the reference in fp8) in the program's place."""
    n, prompt, served = _inputs(rec, row)
    S = rec.call.padded_len
    c = ctl.run(prompt, served, S)
    own = ref.run(prompt, served, S)
    fol = ref.run(prompt, served, S, follow=[lay.start for lay in c.layers])
    return control_numbers(own, fol, c, n, rec.steps, ccfg)


def run_check(prog, cell, seed: int, records: list) -> tuple[dict, list]:
    """(the worst number over the sample, the sample's (call, row))."""
    picks = traffic_mod.check_sample(cell.traffic, seed,
                                     [r.call for r in records])
    by_index = {r.call.index: r for r in records}
    ref = spec.reference(cell.config, cell.here)(prog.params, cell.config)
    per = []
    for ci, row in picks:
        numbers, res = program_numbers(ref, by_index[ci], row,
                                       cell.config["cache"])
        per.append(numbers)
        del res
    return worst(per), picks


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the limits name within its limit."""
    return all(numbers[k] <= limits[k] for k in limits)


def report(numbers: dict, limits: dict) -> dict:
    """{number: {"value", "limit"}} of the compared numbers."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def control_numbers(own, follow, ctrl, n: int, T: int, ccfg: dict) -> dict:
    """The numbers of the control, the reference computed in the next
    precision down (``ctrl``, a Result over the same prompt and served
    tokens), put in the program's place and judged as the program is:
    by the reference's own selection (``own``) and by the reference
    following the control's pages (``follow``); the gap of the token it
    puts first at each position."""
    first = ctrl.logits.argmax(-1)
    g = torch.cat([gaps(own.logits[:1], first[:1]),
                   gaps(follow.logits[1:], first[1:])])
    misses, ev = [], 0.0
    for lo, lf, lc in zip(own.layers, follow.layers, ctrl.layers):
        rk, ck = set(lo.kept.tolist()), set(lc.kept.tolist())
        misses.append(1.0 - len(rk & ck) / len(rk))
        ev = max(ev, evict_gap(lc.start, lc.final, lf.scores.tolist(), n, T,
                               ccfg))
    return _numbers(g, logit_err(ctrl.logits[0], own.logits[0]), misses, ev)

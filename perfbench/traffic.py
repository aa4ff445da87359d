"""The one traffic generator: a traffic file's parameters and a seed give
the calls of a closed loop.

Every call of a mix holds the same multiset of prompt lengths, so that a
window's work does not hang on the seed or on where the deadline falls.
Two length distributions:

- ``"dist": "tasks"``: one request per listed task, of the task's
  published mean length in words times ``tokens_per_word`` (LongBench
  reports English lengths in words);
- ``"dist": "log_uniform"`` with ``"draw": "stratified_midpoints"``: the R
  requests of a call take the midpoints of R equal strata (request r of R
  is a * (b / a) ** ((r + 0.5) / R) over [a, b]).

The seed deals the lengths to the rows in another order in every call and
draws every token id. Rows are right-padded to the call's longest, rounded up to
``pad.multiple``; ``valid`` marks the real tokens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Call:
    index: int
    tokens: np.ndarray     # (R, S) int64, padded with 0
    valid: np.ndarray      # (R, S) bool
    lengths: np.ndarray    # (R,) int64 valid tokens per row

    @property
    def padded_len(self) -> int:
        return self.tokens.shape[1]


def prompt_lengths(traffic: dict) -> list[int]:
    """The R lengths every call holds, in the order the file lists them."""
    dist = traffic["prompt_len"]
    R = traffic["requests_per_call"]
    if dist["dist"] == "tasks":
        tasks = dist["tasks"]
        if len(tasks) != R:
            raise ValueError(f"{R} requests per call, {len(tasks)} tasks")
        return [int(round(t["words"] * dist["tokens_per_word"]))
                for t in tasks]
    if dist["dist"] != "log_uniform" or \
            dist.get("draw") != "stratified_midpoints":
        raise ValueError(f"unknown length distribution {dist}")
    lo, hi = math.log(dist["min"]), math.log(dist["max"])
    return [int(round(math.exp(lo + (r + 0.5) / R * (hi - lo))))
            for r in range(R)]


def padded_len(traffic: dict) -> int:
    m = traffic["pad"]["multiple"]
    return -(-max(prompt_lengths(traffic)) // m) * m


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def make_call(traffic: dict, vocab: int, seed: int, index: int) -> Call:
    """Call ``index`` of the loop that ``seed`` draws."""
    if traffic["loop"] != "closed" or traffic["token_ids"] != "uniform" or \
            traffic["pad"]["side"] != "right":
        raise ValueError(f"unknown traffic {traffic}")
    rng = _rng(seed, 1, index)
    lengths = rng.permutation(np.array(prompt_lengths(traffic)))
    S = padded_len(traffic)
    tokens = rng.integers(0, vocab, size=(len(lengths), S), dtype=np.int64)
    valid = np.arange(S)[None, :] < lengths[:, None]
    return Call(index, np.where(valid, tokens, 0), valid, lengths)


def check_sample(traffic: dict, seed: int, calls: list[Call]
                 ) -> list[tuple[int, int]]:
    """(call, row) of the requests the check compares, drawn from the seed
    among the finished ``calls``: the longest request of a drawn call, then
    further ones drawn among the rest."""
    rng = _rng(seed, 2)
    n = min(traffic["check_requests"], sum(len(c.lengths) for c in calls))
    first = calls[int(rng.integers(len(calls)))]
    picks = [(first.index, int(np.argmax(first.lengths)))]
    rest = [(c.index, r) for c in calls for r in range(len(c.lengths))
            if (c.index, r) != picks[0]]
    for i in rng.permutation(len(rest))[:n - 1]:
        picks.append(rest[int(i)])
    return picks

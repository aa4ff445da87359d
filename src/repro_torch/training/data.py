"""Synthetic data pipeline (the container has no datasets).

Two generators, both deterministic given a seed and shardable by host:

  lm_batches      Zipf-distributed token soup with local n-gram structure —
                  enough signal for loss to drop and smoke tests to pass.
  recall_batches  the *long-context recall* task used to evaluate eviction
                  quality (the LongBench proxy): a key-value list is embedded
                  early in a long distractor context; the query at the end
                  asks for the value of one key. A model with an evicted
                  cache can only answer if the eviction policy preserved the
                  right tokens — exactly the paper's accuracy axis.

Layout mirrors a production pipeline: an index-based sampler (host-side
numpy), per-host sharding by ``host_id``/``num_hosts``, and an iterator of
ready (tokens, targets, mask) batches.

A copy of the JAX package's ``training/data.py`` (numpy only): the batches
are bit-equal to the JAX package's for every (config, step, host).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-host batch
    seed: int = 0
    # recall task knobs
    num_pairs: int = 8         # key/value pairs in the preamble
    key_space: int = 64        # token ids reserved for keys
    distractor_frac: float = 0.8


def _rng_for(cfg: DataConfig, step: int, host_id: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))


# ---------------------------------------------------------------------------
# generic LM stream
# ---------------------------------------------------------------------------

def lm_batch(cfg: DataConfig, step: int, host_id: int = 0,
             num_codebooks: int = 1) -> dict:
    rng = _rng_for(cfg, step, host_id)
    V, S, B = cfg.vocab_size, cfg.seq_len, cfg.batch_size
    shape = (B, num_codebooks, S + 1) if num_codebooks > 1 else (B, S + 1)
    # zipf-ish marginal + short repeats for learnable structure
    z = rng.zipf(1.3, size=shape)
    toks = (z % V).astype(np.int32)
    rep = rng.integers(0, 2, size=shape).astype(bool)
    shifted = np.roll(toks, 3, axis=-1)
    toks = np.where(rep, shifted, toks)
    if num_codebooks > 1:
        return {"tokens": toks[..., :-1], "targets": toks[..., 1:],
                "mask": np.ones((B, S), np.float32)}
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32)}


def lm_batches(cfg: DataConfig, host_id: int = 0, num_hosts: int = 1,
               num_codebooks: int = 1) -> Iterator[dict]:
    step = host_id
    while True:
        yield lm_batch(cfg, step, host_id, num_codebooks)
        step += num_hosts


# ---------------------------------------------------------------------------
# long-context recall (eviction-quality eval)
# ---------------------------------------------------------------------------

def recall_example(cfg: DataConfig, rng: np.random.Generator):
    """One example: [pairs .. distractors .. QUERY key] -> value.

    Token map: 0 = pad, 1 = SEP, 2 = QUERY; keys in [3, 3+key_space);
    values in [3+key_space, vocab). Returns (prompt (S,), answer token)."""
    V, S = cfg.vocab_size, cfg.seq_len
    kv_lo = 3
    v_lo = 3 + cfg.key_space
    assert V > v_lo + 8, "vocab too small for recall task"
    keys = rng.choice(np.arange(kv_lo, v_lo), size=cfg.num_pairs, replace=False)
    vals = rng.integers(v_lo, V, size=cfg.num_pairs)
    body = []
    for k, v in zip(keys, vals):
        body += [int(k), int(v), 1]
    qi = rng.integers(0, cfg.num_pairs)
    tail = [2, int(keys[qi])]
    n_dis = S - len(body) - len(tail)
    assert n_dis >= 0, "seq too short for recall task"
    dis = rng.integers(v_lo, V, size=n_dis).tolist()
    prompt = np.array(body + dis + tail, np.int32)
    return prompt, int(vals[qi])


def recall_batch(cfg: DataConfig, step: int, host_id: int = 0) -> dict:
    """Batched recall prompts + answers (for prefill+decode eval) and also a
    teacher-forced training view (predict answer at the last position)."""
    rng = _rng_for(cfg, step, host_id)
    B, S = cfg.batch_size, cfg.seq_len
    prompts = np.zeros((B, S), np.int32)
    answers = np.zeros((B,), np.int32)
    for i in range(B):
        prompts[i], answers[i] = recall_example(cfg, rng)
    # training view: target only at the final position (the answer)
    tokens = prompts
    targets = np.zeros((B, S), np.int32)
    targets[:, :-1] = prompts[:, 1:]
    targets[:, -1] = answers
    mask = np.zeros((B, S), np.float32)
    mask[:, -1] = 1.0                      # score only the answer slot
    return {"tokens": tokens, "targets": targets, "mask": mask,
            "answers": answers}


def recall_batches(cfg: DataConfig, host_id: int = 0,
                   num_hosts: int = 1) -> Iterator[dict]:
    step = host_id
    while True:
        yield recall_batch(cfg, step, host_id)
        step += num_hosts

"""Eviction-regret shadow probes: what did pruning cost THIS request? (A
copy of the JAX package's ``repro.obs.regret``; only :func:`regret_smoke`
is rewritten, on the port's model and engine.)

The paper's claim is accuracy-vs-memory; throughput telemetry can't see
quality. This module measures eviction's counterfactual cost online:
the engine keeps an **uncompressed shadow copy** of every attention
layer's K/V history (host RAM, never device memory), fed by per-step taps
out of the step — the SAME k/v/q the pruned path computed, so the shadow holds
the production activations, not a re-run. Every ``every_n``-th decode step
of a probed request, :func:`run_probe` recomputes full-cache attention
against the shadow history and records, per layer:

- ``divergence`` — relative L2 between the pruned attention output and the
  full-cache shadow output at the row's probed token;
- ``evicted_mass`` — the shadow softmax mass landing on positions the
  pruned cache no longer holds (attention the policy threw away).

A ``full``-policy engine probes to ~zero on both (the shadow recompute is
the same math in f32), while ``paged_eviction`` under budget pressure
shows nonzero regret — tests and the ``--smoke`` CLI gate exactly that.
Probes off (``ObsConfig.regret_every == 0``): the engine runs the
identical ops and produces bit-identical outputs.

Probe cost is per-step tap transfer (k/v/q/o for every attention layer)
plus numpy attention on sampled steps — a forensics mode, not a serving
default; the CI smoke step documents the measured overhead.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.obs.trace import TRACE_SCHEMA_VERSION

# eviction_regret histogram bounds: divergence/evicted-mass live in [0, ~1];
# log-spaced so "~zero" (full cache, float noise) and "real" (pruned) regret
# land decades apart.
REGRET_BOUNDS = tuple(float(b) for b in np.geomspace(1e-6, 1.0, 25))


@dataclass
class RegretConfig:
    """Sampling knobs for the shadow probes."""
    every_n: int = 8          # probe every Nth decode step of a probed row
    max_probes: int = 0       # stop probing a request after this many
                              # samples (0 == unlimited)


class ShadowState:
    """Uncompressed per-layer K/V history for every batch row (host numpy).

    Mirrors the pruned pool's lifecycle: rows are cleared on reset and
    prefix adoption copies the source row's history — so the shadow is
    exactly "the cache nothing was ever evicted from"."""

    def __init__(self, num_layers: int, batch: int, max_len: int,
                 kv_heads: int, head_dim: int):
        shp = (num_layers, batch, max_len, kv_heads, head_dim)
        self.k = np.zeros(shp, np.float32)
        self.v = np.zeros(shp, np.float32)
        self.written = np.zeros((batch, max_len), bool)
        self.max_len = max_len

    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes + self.written.nbytes

    def reset_row(self, b: int) -> None:
        self.written[b] = False

    def adopt(self, dst: int, src: int, n_tokens: int) -> None:
        n = min(n_tokens, self.max_len)
        self.k[:, dst, :n] = self.k[:, src, :n]
        self.v[:, dst, :n] = self.v[:, src, :n]
        self.written[dst, :n] = self.written[src, :n]

    def record_step(self, layers: list, positions: np.ndarray,
                    n_tok: np.ndarray) -> None:
        """Append this step's tapped K/V. ``layers``: per-attention-layer
        dicts with ``k``/``v`` (B, T, KV, hd); positions (B, T) int32 with
        -1 padding; n_tok (B,)."""
        B = positions.shape[0]
        for b in range(B):
            n = int(n_tok[b])
            if n == 0:
                continue
            idx = positions[b, :n].astype(np.int64)
            ok = (idx >= 0) & (idx < self.max_len)
            if not ok.any():
                continue
            idx = idx[ok]
            for li, tp in enumerate(layers):
                self.k[li, b, idx] = np.asarray(tp["k"][b, :n][ok],
                                                np.float32)
                self.v[li, b, idx] = np.asarray(tp["v"][b, :n][ok],
                                                np.float32)
            self.written[b, idx] = True


def _full_attention(q: np.ndarray, k: np.ndarray, v: np.ndarray,
                    mask: np.ndarray):
    """GQA attention of one query against the shadow history (f32 numpy —
    same math as ``attention.paged_attention_ref``). q: (H, hd); k/v:
    (S, KV, hd); mask: (S,) valid. Returns (o (H, hd), probs (KV, G, S))."""
    H, hd = q.shape
    S, KV = k.shape[0], k.shape[1]
    G = H // KV
    qg = q.reshape(KV, G, hd).astype(np.float32)
    s = np.einsum("kgd,skd->kgs", qg, k.astype(np.float32)) / np.sqrt(hd)
    s = np.where(mask[None, None, :], s, -np.inf)
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    denom = p.sum(axis=-1, keepdims=True)
    p = np.where(denom > 0, p / np.maximum(denom, 1e-30), 0.0)
    o = np.einsum("kgs,skd->kgd", p, v.astype(np.float32))
    return o.reshape(H, hd), p


def run_probe(shadow: ShadowState, layers: list, positions: np.ndarray,
              n_tok: np.ndarray, rows: list) -> list:
    """Shadow-probe the given batch rows at their last live token of this
    step. ``layers``: per-attention-layer taps with ``q``/``o`` (B, T, H,
    hd) and ``live_pos`` (B, P, page) — the pruned cache's positions AT
    ATTENTION TIME. Returns one dict per row: per-layer ``divergence`` and
    ``evicted_mass`` plus the evicted-position count."""
    out = []
    for b in rows:
        n = int(n_tok[b])
        if n == 0:
            continue
        t = n - 1
        qp = int(positions[b, t])
        if qp < 0 or qp >= shadow.max_len:
            continue
        hist = shadow.written[b, :qp + 1]
        divs, masses = [], []
        n_evicted = 0
        for li, tp in enumerate(layers):
            live = np.asarray(tp["live_pos"][b]).ravel()
            live = live[(live >= 0) & (live <= qp)]
            live_mask = np.zeros(qp + 1, bool)
            live_mask[live] = True
            evicted = hist & ~live_mask
            n_evicted = max(n_evicted, int(evicted.sum()))
            o_shadow, probs = _full_attention(
                np.asarray(tp["q"][b, t], np.float32),
                shadow.k[li, b, :qp + 1], shadow.v[li, b, :qp + 1], hist)
            o_pruned = np.asarray(tp["o"][b, t], np.float32)
            num = float(np.linalg.norm(o_shadow - o_pruned))
            den = float(np.linalg.norm(o_shadow)) + 1e-9
            divs.append(num / den)
            masses.append(float(probs[..., evicted].sum(axis=-1).mean()))
        out.append({"slot": int(b), "pos": qp, "divergence": divs,
                    "evicted_mass": masses, "tokens_evicted": n_evicted})
    return out


def probe_record(sample: dict, *, step: int, request_id=None) -> dict:
    """Format one run_probe sample as a schema-v2 ``probe`` trace record."""
    rec = {"v": TRACE_SCHEMA_VERSION, "rec": "probe", "step": step,
           "slot": sample["slot"], "pos": sample["pos"],
           "divergence": [round(float(d), 8) for d in sample["divergence"]],
           "evicted_mass": [round(float(m), 8)
                            for m in sample["evicted_mass"]],
           "tokens_evicted": sample["tokens_evicted"]}
    if request_id is not None:
        rec["request_id"] = str(request_id)
    return rec


def summarize_request(samples: list) -> dict | None:
    """Per-request regret summary over its probe samples (feeds
    ``benchmarks/accuracy.py`` and the serve dashboard)."""
    if not samples:
        return None
    div = np.array([np.mean(s["divergence"]) for s in samples])
    mass = np.array([np.mean(s["evicted_mass"]) for s in samples])
    return {
        "probes": len(samples),
        "mean_divergence": float(div.mean()),
        "max_divergence": float(div.max()),
        "mean_evicted_mass": float(mass.mean()),
        "max_evicted_mass": float(mass.max()),
        "tokens_evicted_last": int(samples[-1]["tokens_evicted"]),
    }


# ---------------------------------------------------------------------------
# smoke harness (CI: regret-probe gate; benchmarks/accuracy.py --regret)
# ---------------------------------------------------------------------------

def regret_smoke(policy: str = "paged_eviction", *, budget: int = 32,
                 page: int = 8, num_requests: int = 3, prompt_len: int = 48,
                 new_tokens: int = 24, every_n: int = 4, seed: int = 0,
                 arch: str = "llama-3.2-1b", device=None) -> dict:
    """Run a tiny engine (the reduced ``arch``, f32, random weights from
    ``seed``) with shadow probes on and summarize the regret. ``device``:
    default CUDA; ``"cpu"`` runs the kernels' plain versions."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.models.transformer import init_model
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import Engine, SamplingParams

    cfg = get_arch(arch).reduced()
    params = init_model(cfg, seed=seed, device=device)
    ccfg = CacheConfig(page_size=page, cache_budget=budget, policy=policy,
                       dtype="float32")
    eng = Engine(cfg, params, cache_cfg=ccfg, max_batch=num_requests,
                 max_prompt_len=prompt_len, max_new_tokens=new_tokens,
                 sampling=SamplingParams(greedy=True), seed=seed,
                 obs=ObsConfig(regret_every=every_n), device=device)
    rng = np.random.default_rng(seed)
    for _ in range(num_requests):
        eng.submit(rng.integers(0, cfg.vocab_size,
                                size=prompt_len).astype(np.int32))
    finished = eng.run()
    samples = [s for r in finished for s in r.regret_samples]
    summaries = [summarize_request(r.regret_samples) for r in finished]
    summaries = [s for s in summaries if s]
    agg = {
        "policy": policy, "budget": budget, "probes": len(samples),
        "mean_divergence": (float(np.mean([s["mean_divergence"]
                                           for s in summaries]))
                            if summaries else 0.0),
        "mean_evicted_mass": (float(np.mean([s["mean_evicted_mass"]
                                             for s in summaries]))
                              if summaries else 0.0),
        "shadow_mb": round(eng.shadow_nbytes() / 1e6, 3),
        "outputs": [list(r.output_tokens) for r in finished],
    }
    eng.close()
    return agg


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.obs.regret --smoke [--device cpu]``.

    Asserts the acceptance criterion: nonzero eviction_regret for
    ``paged_eviction`` under budget pressure, ~zero for ``full``, and
    probes-off outputs identical to the never-instrumented engine."""
    import argparse
    import json
    ap = argparse.ArgumentParser(description="eviction-regret smoke gate")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None, help="write summaries here")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    del args.smoke  # only mode there is
    pruned = regret_smoke("paged_eviction", device=args.device)
    full = regret_smoke("full", device=args.device)
    ok = True
    if not (pruned["probes"] > 0 and pruned["mean_evicted_mass"] > 1e-4
            and pruned["mean_divergence"] > 1e-5):
        print(f"FAIL paged_eviction regret not visible: {pruned}")
        ok = False
    if not (full["probes"] > 0 and full["mean_divergence"] < 1e-3
            and full["mean_evicted_mass"] < 1e-6):
        print(f"FAIL full-cache regret not ~zero: {full}")
        ok = False
    for s in (pruned, full):
        s.pop("outputs")
        print("regret," + ",".join(f"{k}={v}" for k, v in s.items()))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"paged_eviction": pruned, "full": full}, f, indent=2)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's observability (repro_torch.obs and the engine's hooks) against
the JAX package's, on the CPU.

- The copies (metrics, trace, timeline, lineage, regret): the same inputs,
  made from one seed, through both packages' functions give the same
  histogram percentiles, snapshots (and a JSON round trip), trace
  validator verdicts, timeline documents, ledger events and probe numbers.
  The checked-in v1 fixture validates under the port's validator; a trace
  the port wrote validates under the JAX package's and is summarized by
  ``benchmarks.roofline.trace_summary``.
- The engine: the reduced llama-3.2-1b on an f32 pool, served by the JAX
  Engine and the port's with ``ObsConfig(trace, timeline, lineage,
  regret_every=2)``, step for step, under paged_eviction and
  streaming_llm: step records equal except ``t_ms``, ``plan_ms`` and
  ``step_ms``; lineage events with integer fields bit-equal and scores
  within 1e-5 relative; both ledgers reconcile after every step; metric
  counters and gauges equal, histogram counts equal; timeline spans equal
  in name and order for each request; regret probe records within 1e-4
  (f32). A ``full`` run probes to divergence <= 1e-5.
- ``run()`` flushes the trace tail when a step raises; ``metrics=False``
  gives bare caches and no stats read; ``want_taps=False`` runs exactly
  the aten ops of a step with taps, less the taps' own gathers.
"""
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import obs as jobs
from repro.configs import CacheConfig as JCacheConfig
from repro.configs import get_arch as jget_arch
from repro.models.transformer import init_model as jinit_model
from repro.obs import lineage as jlineage
from repro.obs import regret as jregret
from repro.obs import timeline as jtimeline
from repro.obs import trace as jtrace
from repro.serving import Engine as JEngine
from repro.serving import SamplingParams as JSamplingParams
from repro_torch import obs as tobs
from repro_torch.configs import CacheConfig, ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.paged_cache import lineage_snapshot_host
from repro_torch.obs import lineage as tlineage
from repro_torch.obs import regret as tregret
from repro_torch.obs import timeline as ttimeline
from repro_torch.obs import trace as ttrace
from repro_torch.serving import Engine, SamplingParams

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trace_v1.jsonl")
SEED = 0
TIMING = ("t_ms", "plan_ms", "step_ms")


# ---------------------------------------------------------------------------
# the copies, on the same inputs
# ---------------------------------------------------------------------------

def test_histogram_percentiles_match_jax():
    rng = np.random.default_rng(SEED)
    xs = np.exp(rng.normal(np.log(5e-3), 1.5, size=4000))
    hj, ht = jobs.Histogram("t"), tobs.Histogram("t")
    for x in xs:
        hj.observe(float(x))
        ht.observe(float(x))
    hj.observe(1e9)                                   # the overflow bucket
    ht.observe(1e9)
    assert ht.snapshot() == hj.snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ht.quantile(q) == hj.quantile(q)


def test_snapshot_json_roundtrip_matches_jax(tmp_path):
    xs = np.random.default_rng(SEED).random(50)
    snaps = []
    for pkg in (jobs, tobs):
        reg = pkg.MetricsRegistry()
        for i, x in enumerate(xs):
            reg.counter("engine.steps").inc()
            reg.gauge("pool.free_pages").set(i)
            reg.histogram("engine.itl_s").observe(float(x))
        path = tmp_path / f"{pkg.__name__}.json"
        reg.to_json(str(path))
        snaps.append(json.loads(path.read_text()))
        assert snaps[-1] == json.loads(json.dumps(reg.snapshot()))
        assert reg.render()
    assert snaps[1] == snaps[0]


def _records():
    """Step, event and probe records, good and bad, from one seed."""
    rng = np.random.default_rng(SEED)
    step = {"v": 2, "rec": "step", "step": 1, "kind": "decode", "t_ms": 1.0,
            "plan_ms": 0.1, "step_ms": 0.9, "decode_rows": 2,
            "prefill_rows": 0, "reset_rows": 0, "adopt_rows": 0, "tokens": 2,
            "programs": 2, "finished": 0}
    event = {"v": 2, "rec": "event", "step": 3, "etype": "evict", "page": 5,
             "slot": 1, "lpi": 2, "score": float(rng.random())}
    probe = {"v": 2, "rec": "probe", "step": 4, "slot": 0, "pos": 40,
             "divergence": rng.random(2).tolist(),
             "evicted_mass": rng.random(2).tolist()}
    v1 = {k: v for k, v in step.items() if k != "rec"}
    v1["v"] = 1
    return [step, event, probe, v1,
            dict(step, kind="bogus"), dict(step, zzz=1),
            dict(step, tokens=1.5), dict(step, tokens=True),
            dict(event, etype="steal"), dict(step, rec="other"),
            dict(step, v=3), {"v": 1}, [1, 2], dict(probe, divergence=0.5)]


def test_trace_validator_accepts_and_rejects_as_jax(tmp_path):
    recs = _records()
    for r in recs:
        assert ttrace.validate_event(r) == jtrace.validate_event(r)
    assert [bool(ttrace.validate_event(r)) for r in recs[:4]] == [False] * 4
    assert all(ttrace.validate_event(r) for r in recs[4:])
    path = tmp_path / "mixed.jsonl"
    with ttrace.TraceWriter(str(path), flush_every=3) as w:
        for r in recs[:4]:
            w.emit(r)
    assert ttrace.validate_file(str(path)) == [] == \
        jtrace.validate_file(str(path))
    assert ttrace.main([str(path)]) == 0
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1}\nnot json\n')
    assert ttrace.validate_file(str(bad)) == jtrace.validate_file(str(bad))
    assert ttrace.main([str(bad)]) == 1


def test_v1_fixture_validates_under_the_port():
    assert ttrace.validate_file(FIXTURE) == []
    assert ttrace.main([FIXTURE]) == 0


def test_timeline_document_matches_jax():
    docs = []
    for pkg in (jtimeline, ttimeline):
        tl = pkg.TimelineRecorder()
        tl.request_submitted("r1", 10.0)
        tl.request_admitted("r1", 10.5, slot=0, prompt_tokens=32,
                            shared_tokens=8, shared_pages=1)
        tl.prefill_chunk("r1", 10.5, 10.6, tokens=16, step=1)
        tl.decode_step("r1", 10.7)
        tl.request_evicted_page("r1", 10.75, page=3, lpi=1, score=0.5)
        tl.request_finished("r1", 10.9, tokens=2, reason="finished_length")
        tl.engine_step(1, "prefill", 10.5, 0.1, tokens=16)
        tl.engine_instant(10.6, "pages_evicted", count=2)
        docs.append(tl.to_chrome_trace())
    assert docs[1] == docs[0]
    assert ttimeline.validate_chrome_trace(docs[1]) == []


def test_ledger_and_probe_math_match_jax():
    """The ledger's diff over hand-made snapshots (alloc, evict with its
    score, release, adopt, fork), and run_probe over a seeded shadow."""
    B, P, N = 2, 3, 8

    def snap(bt, tpp, scores):
        bt = np.array(bt, np.int32)
        return {"block_table": bt,
                "ref_count": np.bincount(bt[bt >= 0], minlength=N)
                .astype(np.int32),
                "cur_page": np.zeros(B, np.int32),
                "tokens_per_page": np.array(tpp, np.int32),
                "page_scores": np.array(scores, np.float32),
                "pos_base": np.where(np.array(tpp) > 0, 0, -1)
                .astype(np.int32)}
    snaps = [snap([[0, 1, -1], [2, -1, -1]], [[8, 3, 0], [4, 0, 0]],
                  [[0.5, 0.25, np.inf], [1.5, np.inf, np.inf]]),
             snap([[-1, 1, 3], [2, 0, -1]], [[0, 3, 2], [8, 8, 0]],
                  [[np.inf, 0.25, 2.0], [1.5, 0.5, np.inf]]),
             snap([[4, -1, -1], [2, 0, -1]], [[1, 0, 0], [8, 8, 0]],
                  [[1.0, np.inf, np.inf], [1.5, 0.5, np.inf]])]
    ctxs = [None, None, {"reset_slots": frozenset({0})}]
    out = []
    for pkg in (jlineage, tlineage):
        led = pkg.PageLineageLedger()
        evs = []
        for i, (s, c) in enumerate(zip(snaps, ctxs)):
            ctx = pkg.StepPlanContext(**c) if c else None
            evs += [e.to_record() for e in led.observe_step(i + 1, s, ctx)]
            assert led.reconcile(s) == []
        out.append((evs, led.counts()))
    assert out[1] == out[0]
    assert out[1][1]["evict"] >= 1

    L, Bp, S, KV, hd, H = 2, 2, 24, 2, 8, 4
    res = []
    for pkg in (jregret, tregret):
        sh = pkg.ShadowState(L, Bp, S, KV, hd)
        r = np.random.default_rng(SEED)
        pos = np.tile(np.arange(S, dtype=np.int32), (Bp, 1))
        layers = [{"k": r.standard_normal((Bp, S, KV, hd)),
                   "v": r.standard_normal((Bp, S, KV, hd)),
                   "q": r.standard_normal((Bp, S, H, hd)),
                   "o": r.standard_normal((Bp, S, H, hd)),
                   "live_pos": np.where(r.random((Bp, 3, 8)) < 0.7,
                                        np.arange(24).reshape(3, 8), -1)}
                  for _ in range(L)]
        n_tok = np.full(Bp, S, np.int32)
        sh.record_step(layers, pos, n_tok)
        res.append(pkg.run_probe(sh, layers, pos, n_tok, [0, 1]))
    assert len(res[1]) == len(res[0]) == 2
    for a, b in zip(res[0], res[1]):
        assert (b["slot"], b["pos"], b["tokens_evicted"]) == \
            (a["slot"], a["pos"], a["tokens_evicted"])
        np.testing.assert_allclose(b["divergence"], a["divergence"],
                                   atol=1e-6)
        np.testing.assert_allclose(b["evicted_mass"], a["evicted_mass"],
                                   atol=1e-6)
        assert tregret.probe_record(b, step=1) == \
            jregret.probe_record(a, step=1)


# ---------------------------------------------------------------------------
# the engines, step for step
# ---------------------------------------------------------------------------

def _configs():
    jcfg = jget_arch("llama-3.2-1b").reduced()
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


_PARAMS: dict = {}


def _params():
    """The JAX init tree and its port copy (made once per process)."""
    if not _PARAMS:
        jcfg, tcfg = _configs()
        jp = jinit_model(jax.random.PRNGKey(SEED), jcfg)
        _PARAMS["jax"] = jp
        _PARAMS["port"] = params_from_jax(jax.device_get(jp), tcfg,
                                          device="cpu")
    return _PARAMS["jax"], _PARAMS["port"]


def _prompts(vocab, n=4):
    rng = np.random.default_rng(SEED)
    shared = rng.integers(0, vocab, 16)
    out = []
    for i in range(n):
        length = int(rng.integers(20, 48))
        head = shared if i % 2 == 0 else rng.integers(0, vocab, 16)
        out.append(np.concatenate(
            [head, rng.integers(0, vocab, length - 16)]).astype(np.int32))
    return out


def _port_engine(policy, obs, budget=32, **kw):
    _, tcfg = _configs()
    _, tp = _params()
    return Engine(tcfg, tp, cache_cfg=CacheConfig(
        page_size=8, cache_budget=budget, policy=policy, dtype="float32"),
        max_batch=3, max_prompt_len=48, max_new_tokens=8, chunk_size=16,
        sampling=SamplingParams(greedy=True), device="cpu", obs=obs, **kw)


def _read(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _by_rec(recs, rec):
    return [r for r in recs if r.get("rec") == rec]


def _metrics_view(snap):
    """Counters and gauges by value, histograms by count."""
    return {k: (v["value"] if v["type"] in ("counter", "gauge")
                else v["count"]) for k, v in snap.items()}


def _spans(doc):
    """Per track (pid, tid): the (phase, name) sequence."""
    out: dict = {}
    for e in doc["traceEvents"]:
        out.setdefault((e["pid"], e.get("tid")), []).append(
            (e["ph"], e["name"]))
    return out


@pytest.mark.parametrize("policy", ["paged_eviction", "streaming_llm"])
def test_engine_obs_matches_jax(policy, tmp_path):
    jcfg, _ = _configs()
    jp, _ = _params()
    ck = dict(page_size=8, cache_budget=32, policy=policy, dtype="float32")
    paths = {n: str(tmp_path / f"{n}.jsonl") for n in ("jax", "port")}
    mk = lambda n: dict(trace_path=paths[n], timeline=True,  # noqa: E731
                        lineage=True, regret_every=2)
    je = JEngine(jcfg, jp, cache_cfg=JCacheConfig(**ck), max_batch=3,
                 max_prompt_len=48, max_new_tokens=8, chunk_size=16,
                 sampling=JSamplingParams(greedy=True),
                 obs=jobs.ObsConfig(**mk("jax")))
    te = _port_engine(policy, tobs.ObsConfig(**mk("port")))
    for p in _prompts(jcfg.vocab_size):
        je.submit(p)
        te.submit(p)
    for step in range(200):
        j_more, t_more = je.step(), te.step()
        assert j_more == t_more, step
        jsnap = jax.device_get(je._lineage_fn(je.cache))
        assert je.obs.ledger.reconcile(jsnap) == []
        assert te.obs.ledger.reconcile(
            lineage_snapshot_host(te.cache.layers[0])) == [], step
        if not j_more:
            break
    assert not j_more
    je.close()
    te.close()
    assert jtrace.validate_file(paths["port"]) == []
    jr, tr = _read(paths["jax"]), _read(paths["port"])
    assert [r["rec"] for r in tr] == [r["rec"] for r in jr]
    strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                       if k not in TIMING}
    assert [strip(r) for r in _by_rec(tr, "step")] == \
        [strip(r) for r in _by_rec(jr, "step")]
    assert max(r["programs"] for r in _by_rec(tr, "step")) == 2
    jev, tev = _by_rec(jr, "event"), _by_rec(tr, "event")
    assert len(tev) == len(jev) > 0
    # page evictions under paged_eviction; streaming_llm evicts tokens
    assert any(e["etype"] == "evict" for e in tev) == \
        (policy == "paged_eviction")
    for a, b in zip(jev, tev):
        assert {k: v for k, v in b.items() if k != "score"} == \
            {k: v for k, v in a.items() if k != "score"}
        assert ("score" in b) == ("score" in a)
        if "score" in a:
            assert b["score"] == pytest.approx(a["score"], rel=1e-5)
    jpr, tpr = _by_rec(jr, "probe"), _by_rec(tr, "probe")
    assert tpr and len(tpr) == len(jpr)
    for a, b in zip(jpr, tpr):
        for k in ("step", "slot", "pos", "tokens_evicted", "request_id"):
            assert b[k] == a[k]
        np.testing.assert_allclose(b["divergence"], a["divergence"],
                                   atol=1e-4)
        np.testing.assert_allclose(b["evicted_mass"], a["evicted_mass"],
                                   atol=1e-4)
    assert _metrics_view(te.metrics_snapshot()) == \
        _metrics_view(je.metrics_snapshot())
    tdoc, jdoc = (e.obs.timeline.to_chrome_trace() for e in (te, je))
    assert ttimeline.validate_chrome_trace(tdoc) == []
    assert _spans(tdoc) == _spans(jdoc)
    # the trace is read by the benchmarks' summary
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from benchmarks.roofline import trace_summary
    rows = trace_summary(tr)
    assert {r["kind"] for r in rows} <= {"prefill", "mixed", "decode"}
    assert sum(r["steps"] for r in rows) == te.stats.steps


def test_full_policy_probes_to_zero_and_probes_change_nothing():
    outs = []
    for every in (0, 2):
        te = _port_engine("full", tobs.ObsConfig(regret_every=every),
                          budget=32)
        for p in _prompts(te.cfg.vocab_size):
            te.submit(p)
        done = te.run()
        outs.append({r.request_id: r.output_tokens for r in done})
        if every:
            samples = [s for r in done for s in r.regret_samples]
            assert samples and te.shadow_nbytes() > 0
            assert max(max(s["divergence"]) for s in samples) <= 1e-5
            assert max(max(s["evicted_mass"]) for s in samples) == 0.0
        else:
            assert te.shadow_nbytes() == 0
    assert outs[0] == outs[1]


def test_run_flushes_trace_on_error(tmp_path, monkeypatch):
    trace = tmp_path / "t.jsonl"
    te = _port_engine("paged_eviction",
                      tobs.ObsConfig(trace_path=str(trace)))
    for p in _prompts(te.cfg.vocab_size, n=2):
        te.submit(p)
    real_plan, calls = te.scheduler.plan, [0]

    def dying_plan():
        calls[0] += 1
        if calls[0] > 3:
            raise RuntimeError("scheduler died")
        return real_plan()

    monkeypatch.setattr(te.scheduler, "plan", dying_plan)
    with pytest.raises(RuntimeError, match="scheduler died"):
        te.run()
    assert ttrace.validate_file(str(trace)) == []
    assert [r["step"] for r in _read(trace)] == [1, 2, 3]


def test_no_metrics_gives_bare_caches(tmp_path):
    trace = tmp_path / "t.jsonl"
    te = _port_engine("paged_eviction", tobs.ObsConfig(
        metrics=False, trace_path=str(trace)))
    assert all(c.stats is None for c in te.cache.layers)
    for p in _prompts(te.cfg.vocab_size, n=2):
        te.submit(p)
    te.run()
    te.close()
    assert te.last_stats is None and te.metrics_snapshot() == {}
    recs = _read(trace)
    assert recs and not any("pages_allocated" in r for r in recs)
    assert jtrace.validate_file(str(trace)) == []


class _Ops(TorchDispatchMode):
    """Record the aten ops run under the mode, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_taps_off_runs_the_step_without_the_taps():
    """forward_step(want_taps=True) runs the ops of want_taps=False plus,
    per layer, those of one ``pos_view`` (the tap's live positions); the
    other tap fields are tensors the step makes anyway."""
    from repro_torch.core.policies import get_policy
    from repro_torch.models import transformer as ttf
    _, tcfg = _configs()
    _, tp = _params()
    ccfg = CacheConfig(page_size=8, cache_budget=32, dtype="float32")
    pol = get_policy(ccfg.policy)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 16))
                              .astype(np.int32))
    n_tok = torch.tensor([16, 9], dtype=torch.int32)
    seqs, taps = [], None
    for want in (False, True):
        cache = ttf.init_decode_caches(tcfg, 2, 64, pol, ccfg,
                                       chunk_tokens=16, track_stats=True,
                                       device="cpu")
        with _Ops() as rec:
            out = ttf.forward_step(tp, tcfg, tokens, n_tok, cache, pol, ccfg,
                                   reset_mask=torch.ones(2, dtype=torch.bool),
                                   want_taps=want)
        seqs.append(rec.ops)
        if want:
            taps = out[2]
        else:
            assert len(out) == 2
    with _Ops() as rec:
        cache.layers[0].pos_view()
    per_layer = len(rec.ops)
    assert len(seqs[1]) == len(seqs[0]) + per_layer * tcfg.num_layers
    it = iter(seqs[1])
    assert all(op in it for op in seqs[0])        # a subsequence
    assert len(taps["layers"]) == tcfg.num_layers
    assert taps["layers"][0]["live_pos"].shape == \
        cache.layers[0].block_table.shape + (8,)


def test_regret_smoke_runs_on_the_port():
    pruned = tregret.regret_smoke("paged_eviction", device="cpu",
                                  new_tokens=12)
    assert pruned["probes"] > 0 and pruned["mean_evicted_mass"] > 1e-4
    assert pruned["shadow_mb"] > 0


def test_serve_cli_obs_flags(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve
    f = {n: str(tmp_path / n) for n in ("t.jsonl", "tl.json", "s.json")}
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2.5-3b", "--reduced", "--budget", "16",
        "--page", "8", "--requests", "2", "--max-batch", "2",
        "--prompt-len", "24", "--new-tokens", "6", "--chunk", "8",
        "--device", "cpu", "--trace", f["t.jsonl"], "--timeline",
        f["tl.json"], "--lineage", "--regret-every", "2", "--snapshot",
        f["s.json"], "--profile-annotations"])
    serve.main()
    out = capsys.readouterr().out
    assert "reconcile: ok" in out and "probes" in out
    assert jtrace.validate_file(f["t.jsonl"]) == []
    assert {r["rec"] for r in _read(f["t.jsonl"])} == {"step", "event",
                                                       "probe"}
    with open(f["tl.json"]) as fh:
        assert ttimeline.validate_chrome_trace(json.load(fh)) == []
    with open(f["s.json"]) as fh:
        assert json.load(fh)["engine.ttft_s"]["count"] == 2

"""Per-request span timelines → Chrome-trace / Perfetto JSON (a copy of the
JAX package's ``repro.obs.timeline``).

The engine and scheduler call the ``TimelineRecorder`` hooks with host
wall-clock times (``time.perf_counter()`` seconds); the recorder keeps
everything as plain python records and only does formatting work at
:meth:`export`. The export is the Chrome Trace Event Format (the JSON
flavour ``chrome://tracing`` and https://ui.perfetto.dev load directly):

- pid 1 / "engine": one ``X`` (complete) span per ``Engine.step`` with the
  batch-mix kind, plus ``i`` (instant) marks for page evictions.
- pid 2 / "requests": one tid per request, named after the request id,
  carrying the request's life as stacked spans — ``queue`` (submit →
  admission), ``prefill[k]`` for each prompt chunk, ``decode`` (first
  decode step → finish) — plus instants for prefix adoption and for
  evictions that hit the request's own pages (lineage-attributed when the
  ledger is on).

All spans carry ``args`` with the raw numbers (tokens, pages, scores) so
the Perfetto query engine can aggregate them. The recorder is pure host
bookkeeping — nothing here touches the device.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field


def _us(t: float) -> float:
    return t * 1e6


@dataclass
class _ReqTrack:
    tid: int
    rid: str
    submit_t: float | None = None
    admit_t: float | None = None
    decode_t0: float | None = None
    decode_steps: int = 0
    chunks: list = field(default_factory=list)   # (t0, t1, tokens, index)
    instants: list = field(default_factory=list)  # (t, name, args)
    finish_t: float | None = None
    finish_args: dict = field(default_factory=dict)


class TimelineRecorder:
    """Assembles engine/scheduler hook calls into a Chrome-trace timeline."""

    def __init__(self):
        self._t0: float | None = None
        self._reqs: dict = {}        # rid -> _ReqTrack
        self._steps: list = []       # (t0, dur, step, kind, args)
        self._engine_instants: list = []  # (t, name, args)

    # -- clock ----------------------------------------------------------
    def _rel(self, t: float) -> float:
        if self._t0 is None:
            self._t0 = t
        return t - self._t0

    def _track(self, rid) -> _ReqTrack:
        rid = str(rid)
        if rid not in self._reqs:
            self._reqs[rid] = _ReqTrack(tid=len(self._reqs) + 1, rid=rid)
        return self._reqs[rid]

    # -- request hooks --------------------------------------------------
    def request_submitted(self, rid, t: float) -> None:
        self._track(rid).submit_t = self._rel(t)

    def request_admitted(self, rid, t: float, *, slot: int,
                         shared_tokens: int = 0, shared_pages: int = 0,
                         prompt_tokens: int = 0) -> None:
        tr = self._track(rid)
        tr.admit_t = self._rel(t)
        if shared_tokens:
            tr.instants.append((tr.admit_t, "adopt_prefix",
                                {"slot": slot, "shared_tokens": shared_tokens,
                                 "shared_pages": shared_pages}))
        tr.finish_args.update(slot=slot, prompt_tokens=prompt_tokens)

    def prefill_chunk(self, rid, t0: float, t1: float, *, tokens: int,
                      step: int) -> None:
        tr = self._track(rid)
        tr.chunks.append((self._rel(t0), self._rel(t1), tokens, step))

    def decode_step(self, rid, t0: float) -> None:
        """First call opens the request's decode span; later calls count."""
        tr = self._track(rid)
        if tr.decode_t0 is None:
            tr.decode_t0 = self._rel(t0)
        tr.decode_steps += 1

    def request_evicted_page(self, rid, t: float, *, page: int, lpi: int,
                             score: float | None = None) -> None:
        args = {"page": page, "lpi": lpi}
        if score is not None:
            args["score"] = score
        self._track(rid).instants.append((self._rel(t), "evict_page", args))

    def request_finished(self, rid, t: float, *, tokens: int = 0,
                         reason: str = "complete") -> None:
        tr = self._track(rid)
        tr.finish_t = self._rel(t)
        tr.finish_args.update(new_tokens=tokens, reason=reason)

    # -- engine hooks ---------------------------------------------------
    def engine_step(self, step: int, kind: str, t0: float, dur_s: float,
                    **args) -> None:
        self._steps.append((self._rel(t0), dur_s, step, kind, args))

    def engine_instant(self, t: float, name: str, **args) -> None:
        self._engine_instants.append((self._rel(t), name, args))

    # -- export ---------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        ev: list = [
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
             "args": {"name": "step"}},
            {"ph": "M", "pid": 2, "name": "process_name",
             "args": {"name": "requests"}},
        ]
        for t0, dur, step, kind, args in self._steps:
            ev.append({"ph": "X", "pid": 1, "tid": 1, "ts": _us(t0),
                       "dur": _us(dur), "name": f"step:{kind}",
                       "cat": "engine", "args": dict(args, step=step)})
        for t, name, args in self._engine_instants:
            ev.append({"ph": "i", "pid": 1, "tid": 1, "ts": _us(t), "s": "t",
                       "name": name, "cat": "engine", "args": args})
        for tr in self._reqs.values():
            ev.append({"ph": "M", "pid": 2, "tid": tr.tid,
                       "name": "thread_name",
                       "args": {"name": f"req {tr.rid}"}})
            end = tr.finish_t
            if tr.submit_t is not None and tr.admit_t is not None:
                ev.append({"ph": "X", "pid": 2, "tid": tr.tid,
                           "ts": _us(tr.submit_t),
                           "dur": _us(max(tr.admit_t - tr.submit_t, 0.0)),
                           "name": "queue", "cat": "request", "args": {}})
            for i, (t0, t1, tokens, step) in enumerate(tr.chunks):
                ev.append({"ph": "X", "pid": 2, "tid": tr.tid,
                           "ts": _us(t0), "dur": _us(max(t1 - t0, 0.0)),
                           "name": f"prefill[{i}]", "cat": "request",
                           "args": {"tokens": tokens, "step": step}})
            if tr.decode_t0 is not None:
                d_end = end if end is not None else tr.decode_t0
                ev.append({"ph": "X", "pid": 2, "tid": tr.tid,
                           "ts": _us(tr.decode_t0),
                           "dur": _us(max(d_end - tr.decode_t0, 0.0)),
                           "name": "decode", "cat": "request",
                           "args": dict(tr.finish_args,
                                        decode_steps=tr.decode_steps)})
            for t, name, args in tr.instants:
                ev.append({"ph": "i", "pid": 2, "tid": tr.tid, "ts": _us(t),
                           "s": "t", "name": name, "cat": "request",
                           "args": args})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the Perfetto/Chrome JSON; returns the event count."""
        doc = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.write("\n")
        return len(doc["traceEvents"])


def validate_chrome_trace(doc: dict) -> list:
    """Structural validation of a Chrome-trace document (what
    ``chrome://tracing`` needs to load it). Returns violations."""
    errs = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing traceEvents container"]
    if not isinstance(doc["traceEvents"], list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E"):
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev:
            errs.append(f"event {i}: missing name/pid")
        if ph == "X" and not (isinstance(ev.get("ts"), (int, float))
                              and isinstance(ev.get("dur"), (int, float))
                              and ev["dur"] >= 0):
            errs.append(f"event {i}: X needs numeric ts/dur>=0")
        if ph == "i" and ("ts" not in ev or ev.get("s") not in ("t", "p",
                                                                "g")):
            errs.append(f"event {i}: i needs ts and scope")
        if len(errs) >= 20:
            errs.append("... (truncated)")
            break
    return errs

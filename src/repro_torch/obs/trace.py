"""Structured trace: buffered JSONL writer + versioned schema + profiler scopes
(a copy of the JAX package's ``repro.obs.trace``: the same schema, v1 and
v2, so either package's validator reads either's traces).

Schema **v2** (this file) carries three record kinds on one stream,
discriminated by the required ``rec`` field:

- ``rec == "step"``  — one per ``Engine.step`` iteration (same shape as the
  v1 flat event, plus ``rec``).
- ``rec == "event"`` — one per page-lineage mutation (alloc / adopt / fork /
  evict / release) observed on the tracked attention layer, with the
  physical page id, owner slot, logical page index, and the policy score
  at eviction (``obs/lineage.py`` consumes these).
- ``rec == "probe"`` — one per sampled eviction-regret shadow probe
  (``obs/regret.py``): per-layer output divergence vs an uncompressed
  shadow cache and the attention mass attributable to evicted pages.

Records are flat JSON objects so any tool (jq, pandas,
``benchmarks/roofline.py --obs``) can consume them without a reader
library. :func:`validate_event` / :func:`validate_file` are the contract
and version-dispatch: **v1 files stay valid** (a v1 record has ``v == 1``
and no ``rec``; tests pin this on a checked-in fixture).

The writer buffers ``flush_every`` encoded lines before touching the file
so the hot path pays one json.dumps per record and an amortized write —
never an fsync. Crash safety: the writer registers an ``atexit`` fallback
at construction (unregistered on close) so an unhandled exception or
normal interpreter exit still lands the buffered tail; the engine loop
additionally flushes on error. SIGKILL can still lose at most
``flush_every - 1`` records — by design (no fsync on the hot path).

``annotation(name)`` names a host region on the profiler's own clock while
a ``torch.profiler`` profile records (a function-scoped record, as an
aten op's: the region is a host span and casts no mirror onto the
device's timeline), and is a shared nullcontext otherwise, so the code
writes ``with annotation("decode.evict"):`` unconditionally. The engine
names ``engine.plan`` and ``engine.step``; the one-shot path
(``models/transformer.py``) names its prefill and decode stages:
``prefill`` (``prefill.attn``, ``prefill.mlp``, ``prefill.compress``,
``prefill.logits``, and in an MoE block ``moe.dispatch``,
``moe.experts``, ``moe.combine``) and ``decode.step`` (``decode.qkv``,
``decode.append``, ``decode.attn``, ``decode.evict``, ``decode.mlp``,
``decode.logits``).
"""
from __future__ import annotations

import atexit
import contextlib
import json
from typing import IO

import torch
from torch._C._profiler import _RecordFunctionFast

TRACE_SCHEMA_VERSION = 2

# ---------------------------------------------------------------------------
# schemas: field -> (type(s), required)
# ---------------------------------------------------------------------------

# v1 step event. Integer counter fields are per-STEP deltas (device
# stats vector summed over layers), not running totals; *_ms are host
# wall-clock milliseconds. Kept verbatim for back-compat validation.
TRACE_SCHEMA_V1: dict = {
    "v": (int, True),               # schema version
    "step": (int, True),            # engine step counter at emission
                                    # (monotonic, 1-based after each step)
    "kind": (str, True),            # "decode" | "mixed" | "prefill" | "idle"
    "t_ms": (float, True),          # host time since engine start
    "plan_ms": (float, True),       # scheduler plan() wall time
    "step_ms": (float, True),       # step wall time (dispatch+sync)
    "decode_rows": (int, True),     # batch mix this iteration
    "prefill_rows": (int, True),
    "reset_rows": (int, True),
    "adopt_rows": (int, True),
    "tokens": (int, True),          # live tokens consumed (sum n_tok)
    "tokens_written": (int, False),     # device stats (absent if obs off)
    "pages_allocated": (int, False),
    "pages_freed": (int, False),
    "pages_released": (int, False),
    "pages_adopted": (int, False),
    "pages_forked": (int, False),
    "pages_evicted": (int, False),
    "tokens_evicted": (int, False),
    "forced_evictions": (int, False),
    "pool_pages": (int, False),     # physical pool size (per layer)
    "free_pages": (int, False),     # engine's running free-list estimate
    "programs": (int, True),        # compiled-program cache size (sentinel)
    "unexpected_compile": (bool, False),  # step crossed the known ceiling
    "finished": (int, True),        # requests retired this step
}

# v2 step record: v1 shape + the "rec" discriminator.
TRACE_STEP_SCHEMA: dict = dict(TRACE_SCHEMA_V1, rec=(str, True))

# v2 page-lineage event record. One per mutation of the tracked attention
# layer's page pool, derived host-side (engine snapshot diff + step plan).
TRACE_EVENT_SCHEMA: dict = {
    "v": (int, True),
    "rec": (str, True),
    "step": (int, True),            # engine step the mutation landed on
    "etype": (str, True),           # alloc | adopt | fork | evict | release
    "page": (int, True),            # physical page id in the pool
    "slot": (int, True),            # owner batch slot (request row)
    "lpi": (int, True),             # logical page index within the row
    "layer": (int, False),          # tracked attention layer index
    "src_page": (int, False),       # fork: physical source page copied from
    "src_slot": (int, False),       # adopt: source row the prefix came from
    "score": (float, False),        # policy score at eviction (evict only)
    "tokens": (int, False),         # tokens live on the page at event time
    "pos": (int, False),            # first token position on the page
}

# v2 regret-probe record. One per sampled shadow probe (obs/regret.py):
# lists are per-transformer-layer, index 0 == first attention layer.
TRACE_PROBE_SCHEMA: dict = {
    "v": (int, True),
    "rec": (str, True),
    "step": (int, True),
    "slot": (int, True),            # probed batch slot
    "request_id": (str, False),
    "pos": (int, True),             # token position probed (row's last live)
    "divergence": (list, True),     # per-layer relative L2 of attn output
    "evicted_mass": (list, True),   # per-layer shadow attn mass on evicted
                                    # positions (0..1)
    "tokens_evicted": (int, False), # positions missing from the pruned row
}

# Back-compat alias: TRACE_SCHEMA has meant "the step-event schema" since
# v1; keep it pointing at the current step-record shape.
TRACE_SCHEMA = TRACE_STEP_SCHEMA

_V2_SCHEMAS = {
    "step": TRACE_STEP_SCHEMA,
    "event": TRACE_EVENT_SCHEMA,
    "probe": TRACE_PROBE_SCHEMA,
}
_STEP_KINDS = ("decode", "mixed", "prefill", "idle")
_EVENT_TYPES = ("alloc", "adopt", "fork", "evict", "release")


def _check_fields(ev: dict, schema: dict) -> list:
    errs = []
    for key, (typ, required) in schema.items():
        if key not in ev:
            if required:
                errs.append(f"missing required field {key!r}")
            continue
        val = ev[key]
        ok = isinstance(val, typ) and not (typ is int and isinstance(val, bool))
        if typ is float:
            ok = isinstance(val, (int, float)) and not isinstance(val, bool)
        if not ok:
            errs.append(f"{key!r}: expected {typ.__name__}, "
                        f"got {type(val).__name__}")
    for key in ev:
        if key not in schema:
            errs.append(f"unknown field {key!r}")
    return errs


def validate_event(ev: dict) -> list:
    """Return a list of schema violations (empty == valid).

    Version-dispatched: ``v == 1`` (or absent, for pre-versioned files)
    validates against the v1 step schema; ``v == 2`` dispatches on ``rec``.
    """
    if not isinstance(ev, dict):
        return [f"event is {type(ev).__name__}, not object"]
    v = ev.get("v", 1)
    if v == 1:
        errs = _check_fields(ev, TRACE_SCHEMA_V1)
        if ev.get("kind") not in (None,) + _STEP_KINDS:
            errs.append(f"bad kind {ev.get('kind')!r}")
        return errs
    if v != TRACE_SCHEMA_VERSION:
        return [f"schema version {v!r} not in (1, {TRACE_SCHEMA_VERSION})"]
    rec = ev.get("rec")
    schema = _V2_SCHEMAS.get(rec)
    if schema is None:
        return [f"bad rec {rec!r} (want one of {sorted(_V2_SCHEMAS)})"]
    errs = _check_fields(ev, schema)
    if rec == "step" and ev.get("kind") not in (None,) + _STEP_KINDS:
        errs.append(f"bad kind {ev.get('kind')!r}")
    if rec == "event" and ev.get("etype") not in (None,) + _EVENT_TYPES:
        errs.append(f"bad etype {ev.get('etype')!r}")
    return errs


def validate_file(path: str, max_errors: int = 20) -> list:
    """Validate every line of a JSONL trace (v1 or v2); returns violations
    with line numbers (empty == valid file)."""
    errs = []
    with open(path) as f:
        n = -1
        for n, line in enumerate(f):
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"line {n}: not JSON ({e})")
                continue
            for e in validate_event(ev):
                errs.append(f"line {n}: {e}")
            if len(errs) >= max_errors:
                errs.append("... (truncated)")
                return errs
        if n < 0:
            errs.append("empty trace")
    return errs


class TraceWriter:
    """Buffered JSONL sink. ``emit`` encodes and appends to an in-memory
    list; the file is written every ``flush_every`` events and on close.

    An ``atexit`` hook (installed at construction, removed on close) flushes
    the tail if the process exits — cleanly or via unhandled exception —
    without the owner calling ``close()``. Idempotent: double-close and
    close-after-atexit are no-ops."""

    def __init__(self, path: str, flush_every: int = 64):
        self.path = path
        self.flush_every = max(1, flush_every)
        self.events_written = 0
        self._buf: list = []
        self._f: IO | None = open(path, "w")
        atexit.register(self.close)

    def emit(self, ev: dict) -> None:
        if self._f is None:
            raise ValueError(f"TraceWriter({self.path}) is closed")
        self._buf.append(json.dumps(ev, separators=(",", ":")))
        self.events_written += 1
        if len(self._buf) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self._buf and self._f is not None:
            self._f.write("\n".join(self._buf) + "\n")
            self._f.flush()
            self._buf.clear()

    def close(self) -> None:
        if self._f is not None:
            self.flush()
            self._f.close()
            self._f = None
            with contextlib.suppress(Exception):
                atexit.unregister(self.close)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_NO_SPAN = contextlib.nullcontext()


def annotation(name: str):
    """Context manager: a host span ``name`` in the profile while
    ``torch.profiler`` records, else a shared nullcontext (no record, no
    callback: about half a microsecond). The span adds no tensor op and
    reads nothing from the device."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _RecordFunctionFast(name)


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.obs.trace TRACE.jsonl`` — exit 0 iff
valid."""
    import argparse
    ap = argparse.ArgumentParser(description="validate a trace JSONL file")
    ap.add_argument("path")
    args = ap.parse_args(argv)
    errs = validate_file(args.path)
    if errs:
        for e in errs:
            print(f"INVALID {args.path}: {e}")
        return 1
    counts: dict = {}
    with open(args.path) as f:
        for line in f:
            ev = json.loads(line)
            key = f"v{ev.get('v', 1)}:{ev.get('rec', 'step')}"
            counts[key] = counts.get(key, 0) + 1
    total = sum(counts.values())
    mix = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    print(f"OK {args.path}: {total} records ({mix})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

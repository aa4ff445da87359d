"""Serving telemetry + forensics of the torch port: a copy of the JAX
package's ``repro.obs`` (numpy and the stdlib, and torch's profiler for
the spans of ``trace.annotation``), with the same ``ObsConfig`` and
``EngineObs``.

Pieces, deliberately decoupled from each other and from the engine:

- :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket latency
  histograms with real p50/p90/p99, snapshot-able to JSON and renderable
  as a text dashboard.
- :mod:`repro_torch.obs.trace` — buffered JSONL trace (schema v2: step /
  event / probe records + version-dispatched validator) and the
  ``annotation`` spans, which a ``torch.profiler`` profile records and
  which cost a shared nullcontext when none does.
- :mod:`repro_torch.core.devstats` — the device half: the int32 stats
  vector the pool mutators accumulate during the step, read once per step
  and reconciled into the registry.
- :mod:`repro_torch.obs.timeline` — per-request span timelines exported as
  Chrome-trace/Perfetto JSON (``serve.py --timeline``).
- :mod:`repro_torch.obs.lineage` — host-side page-lineage ledger: every
  page's life, every request's eviction losses, reconciled exactly against
  ``block_table``/``ref_count``.
- :mod:`repro_torch.obs.regret` — sampled eviction-regret shadow probes
  (divergence vs an uncompressed shadow cache + attention mass on evicted
  pages).

``ObsConfig`` is the single knob surface the engine takes; ``EngineObs``
bundles the live registry + writer + forensics state so ``Engine.step``
carries one handle.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, LATENCY_BOUNDS_S)
from repro_torch.obs.trace import (TRACE_SCHEMA, TRACE_SCHEMA_V1,
                                   TRACE_SCHEMA_VERSION, TraceWriter,
                                   annotation, validate_event, validate_file)
from repro_torch.obs.timeline import TimelineRecorder
from repro_torch.obs.lineage import PageLineageLedger, StepPlanContext

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "LATENCY_BOUNDS_S",
    "TRACE_SCHEMA", "TRACE_SCHEMA_V1", "TRACE_SCHEMA_VERSION", "TraceWriter",
    "annotation", "validate_event", "validate_file", "ObsConfig",
    "EngineObs", "TimelineRecorder", "PageLineageLedger", "StepPlanContext",
]


@dataclass
class ObsConfig:
    """What the engine should instrument.

    metrics      : host registry + device stats vector (the default-on
                   path; off gives bare caches with no stats vector and no
                   per-step read of it)
    trace_path   : write one JSONL record per step here (None == no trace);
                   lineage events and regret probes also land on this
                   stream when enabled
    program_ceiling : distinct step shapes the engine expects at steady
                   state (T == chunk and T == 1); crossing it flips the
                   unexpected_compile flag on that step's trace event and
                   bumps the sentinel counter
    timeline     : record per-request span timelines (queue / prefill
                   chunks / decode / instants) for Perfetto export
    lineage      : host-side page-lineage ledger over the first attention
                   layer (one extra snapshot gather and read per step)
    regret_every : probe eviction regret on every Nth decode step of each
                   request (0 == off). NONZERO runs the step with per-layer
                   taps and transfers them every step — a forensics mode,
                   not a serving default.
    """
    metrics: bool = True
    trace_path: str | None = None
    program_ceiling: int = 2
    timeline: bool = False
    lineage: bool = False
    regret_every: int = 0

    @property
    def enabled(self) -> bool:
        return (self.metrics or self.trace_path is not None or self.timeline
                or self.lineage or self.regret_every > 0)


@dataclass
class EngineObs:
    """Live telemetry state owned by one Engine."""
    cfg: ObsConfig
    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    writer: TraceWriter | None = None
    timeline: TimelineRecorder | None = None
    ledger: PageLineageLedger | None = None

    def __post_init__(self):
        if self.cfg.trace_path and self.writer is None:
            self.writer = TraceWriter(self.cfg.trace_path)
        if self.cfg.timeline and self.timeline is None:
            self.timeline = TimelineRecorder()
        if self.cfg.lineage and self.ledger is None:
            self.ledger = PageLineageLedger(layer=0)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()

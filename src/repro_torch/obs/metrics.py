"""Host-side metrics: counters, gauges, fixed-bucket latency histograms (a
copy of the JAX package's numpy-only ``repro.obs.metrics``).

Design constraints (DESIGN.md §9): every instrument is a few Python floats
— ``observe()`` on the serving hot path is O(log n_buckets) with zero
allocation, so the registry itself can never be the overhead the
BENCH_obs gate measures. Histograms use FIXED log-spaced bucket bounds
(~100 us .. ~60 s, 8 per decade) chosen once at import: snapshots from
different runs/processes are mergeable bucket-by-bucket, and quantiles
come from linear interpolation inside the bucket (error bounded by the
~33% bucket width — tests/test_obs.py pins this against numpy on random
latency draws).

Metric names are dot-paths (``engine.step.wall_s``); units live in the
name suffix (``_s`` seconds, ``_ms`` never — everything is seconds) so a
snapshot is self-describing. The registry is snapshot-able to a plain
dict (JSON-safe) and renderable as a text dashboard (launch/serve.py).
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Iterable


def _default_bounds() -> tuple:
    """Log-spaced upper bounds, 8 per decade over [1e-4, 60] seconds."""
    bounds = []
    lo, hi = -4.0, math.log10(60.0)
    n = int(round((hi - lo) * 8))
    for i in range(n + 1):
        bounds.append(10.0 ** (lo + (hi - lo) * i / n))
    return tuple(bounds)


LATENCY_BOUNDS_S = _default_bounds()


class Counter:
    """Monotonic non-negative accumulator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n

    def snapshot(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def snapshot(self):
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max and interpolated
    quantiles. ``bounds`` are inclusive upper edges; one overflow bucket
    catches everything above the last bound."""

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, bounds: Iterable[float] = LATENCY_BOUNDS_S):
        self.name = name
        self.bounds = tuple(bounds)
        assert list(self.bounds) == sorted(self.bounds), name
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (0 <= q <= 1); nan when empty. Exact
        min/max clamp the first/last occupied buckets, so q=0 and q=1 are
        exact and interior quantiles never leave the observed range."""
        if self.count == 0:
            return math.nan
        rank = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else 0.0
            hi = self.bounds[i] if i < len(self.bounds) else self.max
            lo, hi = max(lo, self.min), min(max(hi, lo), self.max)
            if seen + c >= rank:
                frac = min(max((rank - seen) / c, 0.0), 1.0)
                return lo + (hi - lo) * frac
            seen += c
        return self.max

    def snapshot(self):
        d = {"type": "histogram", "count": self.count, "sum": self.sum,
             "min": self.min if self.count else None,
             "max": self.max if self.count else None,
             "mean": (self.sum / self.count) if self.count else None,
             "buckets": {f"{b:.6g}": c
                         for b, c in zip(self.bounds, self.counts) if c},
             "overflow": self.counts[-1]}
        for q, tag in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            v = self.quantile(q)
            d[tag] = None if math.isnan(v) else v
        return d


class MetricsRegistry:
    """Name -> instrument map. get-or-create accessors keep call sites
    one-liners; a name can only ever hold one instrument type."""

    def __init__(self):
        self._m: dict = {}

    def _get(self, name: str, cls, *args):
        inst = self._m.get(name)
        if inst is None:
            inst = self._m[name] = cls(name, *args)
        elif not isinstance(inst, cls):
            raise TypeError(f"{name} is {type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds=LATENCY_BOUNDS_S) -> Histogram:
        return self._get(name, Histogram, bounds)

    def names(self):
        return sorted(self._m)

    def snapshot(self) -> dict:
        """JSON-safe dict of every instrument."""
        return {name: self._m[name].snapshot() for name in self.names()}

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")

    # ------------------------------------------------------------- dashboard
    def render(self) -> str:
        """Text dashboard: counters/gauges as a two-column table, histograms
        as count/mean/p50/p90/p99/max rows (seconds shown in ms)."""
        lines = []
        scalars = [(n, i) for n, i in sorted(self._m.items())
                   if isinstance(i, (Counter, Gauge))]
        hists = [(n, i) for n, i in sorted(self._m.items())
                 if isinstance(i, Histogram)]
        if scalars:
            w = max(len(n) for n, _ in scalars)
            lines.append("-- counters / gauges " + "-" * max(1, w - 9))
            for n, inst in scalars:
                v = inst.value
                sv = f"{v:.4g}" if isinstance(v, float) else str(v)
                lines.append(f"  {n:<{w}}  {sv:>12}")
        if hists:
            w = max(len(n) for n, _ in hists)
            lines.append("-- latency histograms (ms) " + "-" * max(1, w - 15))
            hdr = f"  {'name':<{w}}  {'count':>7} {'mean':>9} {'p50':>9} " \
                  f"{'p90':>9} {'p99':>9} {'max':>9}"
            lines.append(hdr)
            for n, h in hists:
                if h.count == 0:
                    lines.append(f"  {n:<{w}}  {0:>7}")
                    continue
                ms = lambda x: f"{x * 1e3:>9.2f}"
                lines.append(
                    f"  {n:<{w}}  {h.count:>7} {ms(h.sum / h.count)} "
                    f"{ms(h.quantile(.5))} {ms(h.quantile(.9))} "
                    f"{ms(h.quantile(.99))} {ms(h.max)}")
        return "\n".join(lines)

"""The profiled call reduced to what the per-layer metrics and the result
line read: the device's activity intervals by name, the host's spans,
the device's busy time (the union of its intervals), its idle gaps, and
the breakdown of the result line. Times in seconds."""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name).replace("void ", "").strip()
    return name[:120]


@dataclass
class Trace:
    device: list        # (name, start_s, end_s) of every device activity
    host: list          # (name, start_s, end_s) of every host span / op
    span: tuple         # (start_s, end_s) of the profiled call

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        """The trace of a finished ``torch.profiler.profile``, read from its
        raw Kineto events: torch's own parse of them into FunctionEvents
        costs minutes at the hundreds of thousands of events of a long
        model's decode, and none of what it adds is read here. Names, and
        the events left out, as that parse has them."""
        from torch.autograd import DeviceType
        from torch.autograd.profiler_util import _filter_name, _rewrite_name
        res = prof.profiler.kineto_results
        base = res.trace_start_ns()
        dev, host, span = [], [], None
        for e in res.events():
            name = e.name()
            if _filter_name(name) or \
                    getattr(e, "is_hidden_event", lambda: False)():
                continue
            name = _rewrite_name(name, with_wildcard=True)
            t0 = e.start_ns() - base
            item = (name, t0 * 1e-9, (t0 + e.duration_ns()) * 1e-9)
            if e.device_type() == DeviceType.CUDA:
                # the host's spans are mirrored on the device's timeline
                # as annotations: they are not device work
                if not e.is_user_annotation() and \
                        not name.startswith("perfbench."):
                    dev.append(item)
            else:
                host.append(item)
                if name == "perfbench.call":
                    span = item[1:]
        if span is None:
            raise RuntimeError("the profile holds no perfbench.call span")
        return cls(sorted(dev, key=lambda t: t[1]), host, span)

    @property
    def window_s(self) -> float:
        return self.span[1] - self.span[0]

    def busy_intervals(self) -> list:
        """The union of the device's intervals inside the call's span."""
        lo, hi = self.span
        out: list = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_time(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of the device activities whose name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [e - s for n, s, e in self.device if rx.search(n)]
        return sum(hits), len(hits)

    def device_ops(self, top: int = 10) -> list:
        by: dict = defaultdict(float)
        for n, s, e in self.device:
            by[short_name(n)] += e - s
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The device's idle time inside the call, by the innermost host
        span or op running at each gap's middle."""
        busy = self.busy_intervals()
        lo, hi = self.span
        edges = [lo] + [x for b in busy for x in b] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda t: (t[1], -t[2]))
        by: dict = defaultdict(float)
        stack: list = []        # open host spans, innermost last
        i = 0
        for s, e in gaps:       # in time order: one sweep
            mid = 0.5 * (s + e)
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            name = stack[-1][0] if stack else "(no host span)"
            by[name[:120]] += e - s
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]

"""Host-side page-lineage ledger: every page's life, every request's losses
(a copy of the JAX package's numpy-only ``repro.obs.lineage``).

The engine snapshots ONE tracked attention layer once per step via
``core.paged_cache.lineage_snapshot`` (block table, ref counts, per-page
token counts / base positions / policy scores — a few torch ops on the
device and one read to the host).
:meth:`PageLineageLedger.observe_step` diffs consecutive snapshots and,
using the step plan for context (which rows were reset, which adopted a
prefix from whom), classifies each block-table mutation into one of five
event types:

========  ==========================================================
alloc     a fresh physical page was mapped into (slot, lpi)
adopt     the mapping was copied from another row's prefix (CoW share)
fork      the row remapped (slot, lpi) to a private copy (CoW fork)
evict     the policy unmapped the page (carries the pre-step score)
release   the mapping was dropped because the row was reset/retired
========  ==========================================================

The same events are emitted as schema-v2 ``rec == "event"`` trace records,
so :meth:`PageLineageLedger.from_trace` can rebuild the ledger offline
from a trace file alone.

Contract (DESIGN.md §10, tested in tests/test_lineage.py): the ledger's
replayed block table equals the device block table after EVERY step, and
``ref_count`` equals the column count of the replayed table (the
mapping-count invariant) — :meth:`reconcile` returns the violations.
Within-step churn (a page allocated and evicted inside one step) is
invisible to snapshot diffs by design; count cross-checks against the
devstats vector are therefore inequalities, while *state* reconciliation
stays exact.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs.trace import TRACE_SCHEMA_VERSION


@dataclass
class PageEvent:
    """One mutation of the tracked layer's page pool (= one v2 trace
    ``event`` record)."""
    step: int
    etype: str          # alloc | adopt | fork | evict | release
    page: int           # physical page id
    slot: int           # owner row
    lpi: int            # logical page index within the row
    layer: int = 0
    src_page: int | None = None   # fork: page the copy split from
    src_slot: int | None = None   # adopt: row the prefix came from
    score: float | None = None    # evict: policy score priced pre-step
    tokens: int | None = None     # live tokens on the page at event time
    pos: int | None = None        # first token position on the page

    def to_record(self) -> dict:
        rec = {"v": TRACE_SCHEMA_VERSION, "rec": "event", "step": self.step,
               "etype": self.etype, "page": self.page, "slot": self.slot,
               "lpi": self.lpi, "layer": self.layer}
        for k in ("src_page", "src_slot", "score", "tokens", "pos"):
            val = getattr(self, k)
            if val is not None:
                rec[k] = val
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "PageEvent":
        return cls(step=rec["step"], etype=rec["etype"], page=rec["page"],
                   slot=rec["slot"], lpi=rec["lpi"],
                   layer=rec.get("layer", 0),
                   src_page=rec.get("src_page"),
                   src_slot=rec.get("src_slot"), score=rec.get("score"),
                   tokens=rec.get("tokens"), pos=rec.get("pos"))


def _np_snap(snap: dict) -> dict:
    return {k: np.asarray(v) for k, v in snap.items()}


@dataclass
class StepPlanContext:
    """The scheduler facts the diff needs to disambiguate event types."""
    reset_slots: frozenset = frozenset()
    # dst slot -> (src slot, n shared pages)
    adopt: dict = field(default_factory=dict)


class PageLineageLedger:
    """Diff-and-replay ledger over one tracked attention layer."""

    def __init__(self, layer: int = 0):
        self.layer = layer
        self.events: list[PageEvent] = []
        self._prev: dict | None = None
        self._bt: np.ndarray | None = None   # replayed block table
        self._pool_pages: int | None = None

    # ------------------------------------------------------------ ingest
    def observe_step(self, step: int, snap: dict,
                     plan: StepPlanContext | None = None) -> list[PageEvent]:
        """Diff the new snapshot against the previous one; returns (and
        retains) the events derived for this step."""
        snap = _np_snap(snap)
        plan = plan or StepPlanContext()
        new_events: list[PageEvent] = []
        cur_bt = snap["block_table"]
        if self._prev is None:
            # first observation: everything mapped is a pre-existing alloc
            B, P = cur_bt.shape
            for b in range(B):
                for p in range(P):
                    if cur_bt[b, p] >= 0:
                        new_events.append(self._ev(step, "alloc", snap, b, p))
        else:
            prev_bt = self._prev["block_table"]
            B, P = cur_bt.shape
            for b in range(B):
                in_reset = b in plan.reset_slots
                adopt = plan.adopt.get(b)
                for p in range(P):
                    g0, g1 = int(prev_bt[b, p]), int(cur_bt[b, p])
                    if g0 == g1:
                        if g0 < 0:
                            continue
                        if in_reset:
                            # reset rows release everything, so an unchanged
                            # mapping means the SAME physical page was
                            # recycled into the new occupant's row
                            new_events.append(
                                self._unmap_ev(step, b, p, g0, True))
                            new_events.append(
                                self._map_ev(step, snap, b, p, adopt))
                        elif (int(self._prev["tokens_per_page"][b, p]) > 0
                              and int(snap["tokens_per_page"][b, p]) == 0
                              and int(snap["cur_page"][b]) == p):
                            # policy eviction + working-page rollover that
                            # recycled the SAME physical page into the SAME
                            # slot — invisible to a block-table diff, visible
                            # as the slot becoming the row's EMPTY working
                            # page (the realloc'd page takes its first token
                            # next step)
                            new_events.append(
                                self._unmap_ev(step, b, p, g0, False))
                            new_events.append(
                                self._ev(step, "alloc", snap, b, p))
                        continue
                    if g0 >= 0 and g1 >= 0 and not in_reset:
                        # same-slot remap. A CoW fork carries the copied
                        # tokens; an evict + working-page rollover lands an
                        # EMPTY page (rollover is the step's last mutation,
                        # the first write comes next step).
                        if int(snap["tokens_per_page"][b, p]) > 0:
                            new_events.append(self._ev(step, "fork", snap,
                                                       b, p, src_page=g0))
                        else:
                            new_events.append(
                                self._unmap_ev(step, b, p, g0, False))
                            new_events.append(
                                self._ev(step, "alloc", snap, b, p))
                        continue
                    if g0 >= 0:
                        new_events.append(
                            self._unmap_ev(step, b, p, g0, in_reset))
                    if g1 >= 0:
                        new_events.append(
                            self._map_ev(step, snap, b, p, adopt))
        # replay onto ledger state
        if self._bt is None:
            self._bt = np.full_like(cur_bt, -1)
            self._pool_pages = int(snap["ref_count"].shape[0])
        for ev in new_events:
            if ev.etype in ("release", "evict"):
                if self._bt[ev.slot, ev.lpi] == ev.page:
                    self._bt[ev.slot, ev.lpi] = -1
            else:
                self._bt[ev.slot, ev.lpi] = ev.page
        self.events.extend(new_events)
        self._prev = snap
        return new_events

    def _ev(self, step, etype, snap, b, p, **kw) -> PageEvent:
        return PageEvent(
            step=step, etype=etype, page=int(snap["block_table"][b, p]),
            slot=b, lpi=p, layer=self.layer,
            tokens=int(snap["tokens_per_page"][b, p]),
            pos=int(snap["pos_base"][b, p]), **kw)

    def _unmap_ev(self, step, b, p, g0, in_reset) -> PageEvent:
        prev = self._prev
        if in_reset:
            return PageEvent(step=step, etype="release", page=g0, slot=b,
                             lpi=p, layer=self.layer,
                             tokens=int(prev["tokens_per_page"][b, p]),
                             pos=int(prev["pos_base"][b, p]))
        score = float(prev["page_scores"][b, p])
        return PageEvent(step=step, etype="evict", page=g0, slot=b, lpi=p,
                         layer=self.layer,
                         score=score if np.isfinite(score) else None,
                         tokens=int(prev["tokens_per_page"][b, p]),
                         pos=int(prev["pos_base"][b, p]))

    def _map_ev(self, step, snap, b, p, adopt) -> PageEvent:
        if adopt is not None:
            src, n_pages = adopt
            g1 = int(snap["block_table"][b, p])
            if p < n_pages and int(self._prev["block_table"][src, p]) == g1:
                return self._ev(step, "adopt", snap, b, p, src_slot=int(src))
        return self._ev(step, "alloc", snap, b, p)

    # --------------------------------------------------------- reconcile
    def replayed_block_table(self) -> np.ndarray | None:
        return None if self._bt is None else self._bt.copy()

    def replayed_ref_count(self) -> np.ndarray | None:
        """ref_count derived purely from the replayed block table: a page's
        refcount is the number of rows mapping it (the CoW invariant)."""
        if self._bt is None:
            return None
        mapped = self._bt[self._bt >= 0]
        return np.bincount(mapped, minlength=self._pool_pages).astype(np.int32)

    def reconcile(self, snap: dict) -> list:
        """Exact-state check against a device snapshot; returns mismatch
        descriptions (empty == the ledger and the device agree)."""
        snap = _np_snap(snap)
        errs = []
        if self._bt is None:
            return ["ledger has observed no steps"]
        bt = snap["block_table"]
        if not np.array_equal(self._bt, bt):
            bad = np.argwhere(self._bt != bt)
            for b, p in bad[:5]:
                errs.append(f"block_table[{b},{p}]: ledger "
                            f"{self._bt[b, p]} != device {bt[b, p]}")
            if len(bad) > 5:
                errs.append(f"... {len(bad) - 5} more block-table mismatches")
        rc = self.replayed_ref_count()
        dev_rc = snap["ref_count"]
        if not np.array_equal(rc, dev_rc):
            bad = np.argwhere(rc != dev_rc).ravel()
            for g in bad[:5]:
                errs.append(f"ref_count[{g}]: ledger {rc[g]} != device "
                            f"{dev_rc[g]}")
            if len(bad) > 5:
                errs.append(f"... {len(bad) - 5} more ref-count mismatches")
        return errs

    # ----------------------------------------------------------- queries
    def page_history(self, page: int) -> list:
        """Every event that touched physical page ``page``, in step order —
        the page's life across owners and reuses."""
        return [ev for ev in self.events if ev.page == page
                or ev.src_page == page]

    def request_loss_report(self, slot: int, *, since_step: int = 0) -> dict:
        """\"What did I lose\": the pages evicted out from under ``slot``
        (policy evictions only — resets/releases are lifecycle, not loss)."""
        losses = [ev for ev in self.events
                  if ev.etype == "evict" and ev.slot == slot
                  and ev.step >= since_step]
        scores = [ev.score for ev in losses if ev.score is not None]
        return {
            "slot": slot,
            "pages_lost": len(losses),
            "tokens_lost": sum(ev.tokens or 0 for ev in losses),
            "positions": [(ev.pos, (ev.pos or 0) + (ev.tokens or 0))
                          for ev in losses if ev.pos is not None
                          and ev.pos >= 0],
            "mean_evict_score": (float(np.mean(scores)) if scores else None),
            "events": losses,
        }

    def counts(self) -> dict:
        out: dict = {}
        for ev in self.events:
            out[ev.etype] = out.get(ev.etype, 0) + 1
        return out

    # ------------------------------------------------------ construction
    @classmethod
    def from_events(cls, events, *, batch: int, num_pages: int,
                    pool_pages: int, layer: int = 0) -> "PageLineageLedger":
        """Rebuild a ledger by replaying event records (e.g. parsed from a
        v2 trace file) — no snapshots needed."""
        led = cls(layer=layer)
        led._bt = np.full((batch, num_pages), -1, np.int32)
        led._pool_pages = pool_pages
        for ev in sorted(events, key=lambda e: e.step):
            if ev.etype in ("release", "evict"):
                if led._bt[ev.slot, ev.lpi] == ev.page:
                    led._bt[ev.slot, ev.lpi] = -1
            else:
                led._bt[ev.slot, ev.lpi] = ev.page
            led.events.append(ev)
        return led

    @classmethod
    def from_trace(cls, path: str, *, batch: int, num_pages: int,
                   pool_pages: int, layer: int = 0) -> "PageLineageLedger":
        import json
        events = []
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("rec") == "event" and rec.get("layer", 0) == layer:
                    events.append(PageEvent.from_record(rec))
        return cls.from_events(events, batch=batch, num_pages=num_pages,
                               pool_pages=pool_pages, layer=layer)

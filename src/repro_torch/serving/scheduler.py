"""Chunk-aware continuous-batching scheduler (vLLM-style token budget): a
copy of the JAX package's numpy-only ``repro.serving.scheduler``.

Keeps a waiting queue and a fixed number of batch slots (the unified
step has a static batch). Each engine iteration the scheduler emits ONE
:class:`StepPlan` mixing decode tokens and prompt chunks:

- **Admission**: a waiting request is admitted (FIFO) whenever a slot frees
  up. Because every policy statically bounds the per-request block table
  (budget + chunk headroom) and the pool is sized ``B * P``, admission can
  never over-commit HBM — no memory-pressure feedback loop, no preemption
  (DESIGN.md §2, §6).
- **Decode priority**: every RUNNING slot gets exactly 1 token first —
  decode latency (ITL) is never sacrificed to prefill throughput.
- **Prompt chunks**: the remaining ``token_budget`` is handed to PREFILLING
  slots in slot order, up to ``chunk_size`` tokens each, tracked via
  ``Request.prefill_pos``. A long prompt therefore spreads over many steps
  while decode rows keep emitting — the old engine's whole-prompt prefill
  stall is gone.

``token_budget`` floors at ``max_batch + 1`` so a prefilling request always
makes progress even with every other slot decoding.

**Prefix sharing** (DESIGN.md §7): when constructed with a ``page_size``,
the scheduler keeps a :class:`RadixPrefixIndex` — a page-granular trie over
the resident requests' prompt tokens. At admission it looks up the longest
FULL-page prefix the newcomer textually shares with a resident row, asks
the engine's device probe how much of that prefix actually survives in
every attention layer (eviction may have punched holes), and on a hit marks
the request to adopt those pages: its ``prefill_pos`` starts past the
shared tokens, so shared chunks are never recomputed, and the step's
``adopt`` entry tells the unified step to remap + ref-bump the pages.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.request import Request, RequestStatus


class _RadixNode:
    __slots__ = ("children", "slots")

    def __init__(self):
        self.children: dict[bytes, _RadixNode] = {}
        self.slots: set[int] = set()


class RadixPrefixIndex:
    """Page-granular prefix trie over resident prompts (vLLM's automatic
    prefix caching, host side). Each edge is the raw bytes of one FULL page
    of prompt tokens — exact-match keys, so hash collisions cannot alias
    different prefixes. Only complete pages participate: a partially-filled
    page is the owner's write head and is never shareable."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _RadixNode()
        # slot -> [(parent, edge_key, node), ...] along its insertion path
        self._paths: dict[int, list[tuple[_RadixNode, bytes, _RadixNode]]] = {}

    def _keys(self, prompt: np.ndarray) -> list[bytes]:
        p = self.page_size
        n = len(prompt) // p
        arr = np.ascontiguousarray(np.asarray(prompt[:n * p], np.int32))
        return [arr[i * p:(i + 1) * p].tobytes() for i in range(n)]

    def insert(self, slot: int, prompt: np.ndarray) -> None:
        self.remove(slot)
        node, path = self.root, []
        for key in self._keys(prompt):
            child = node.children.setdefault(key, _RadixNode())
            child.slots.add(slot)
            path.append((node, key, child))
            node = child
        self._paths[slot] = path

    def remove(self, slot: int) -> None:
        for parent, key, node in reversed(self._paths.pop(slot, [])):
            node.slots.discard(slot)
            if not node.slots and not node.children:
                parent.children.pop(key, None)

    def lookup(self, prompt: np.ndarray,
               exclude: set[int] | None = None) -> tuple[int, int]:
        """Longest full-page prefix match -> (source_slot, n_pages);
        (-1, 0) when nothing matches. ``exclude``: slots whose device rows
        are stale this step (being reset) and must not serve as sources."""
        exclude = exclude or set()
        node, depth, best = self.root, 0, (-1, 0)
        for key in self._keys(prompt):
            child = node.children.get(key)
            if child is None:
                break
            cands = child.slots - exclude
            if not cands:
                break
            depth += 1
            best = (min(cands), depth)
            node = child
        return best


@dataclass
class StepPlan:
    """One unified step's worth of work.

    decode : (slot, request) rows feeding back their last sampled token
    prefill: (slot, request, chunk, completes) rows consuming ``chunk``
             prompt tokens; ``completes`` marks the prompt's final chunk
             (the step's sampled token is that request's FIRST output)
    reset  : slots whose row state must be wiped first (newly admitted —
             the previous occupant's pages return to the shared pool)
    adopt  : (slot, src_slot, n_pages) prefix-sharing adoptions riding the
             reset — slot maps src_slot's first n_pages prompt pages
    """
    decode: list[tuple[int, Request]] = field(default_factory=list)
    prefill: list[tuple[int, Request, np.ndarray, bool]] = \
        field(default_factory=list)
    reset: list[int] = field(default_factory=list)
    adopt: list[tuple[int, int, int]] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.decode and not self.prefill

    @property
    def num_tokens(self) -> int:
        return len(self.decode) + sum(len(c) for _, _, c, _ in self.prefill)


class Scheduler:
    def __init__(self, max_batch: int, chunk_size: int = 64,
                 token_budget: int | None = None,
                 page_size: int | None = None, prefix_probe=None):
        self.max_batch = max_batch
        self.chunk_size = chunk_size
        self.token_budget = max(token_budget or (max_batch + chunk_size),
                                max_batch + 1)
        self.waiting: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * max_batch
        self.finished: list[Request] = []
        # prefix sharing: index over resident prompts + the engine's device
        # probe (slot -> intact prefix pages). None == sharing disabled.
        self.prefix_index = RadixPrefixIndex(page_size) if page_size else None
        self.prefix_probe = prefix_probe
        # admission hook: called as on_admit(slot, req) the moment a request
        # is assigned a batch slot (the engine wires this to the per-request
        # timeline recorder; None == no observer)
        self.on_admit = None

    # ------------------------------------------------------------------ api
    def add(self, req: Request) -> None:
        req.status = RequestStatus.WAITING
        self.waiting.append(req)

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _match_prefix(self, req: Request, stale: set[int]) -> bool:
        """Host half of prefix-sharing admission: radix-match the prompt
        against resident rows, validate the hit against the engine's device
        probe, cap so at least one prompt token always prefills (the last
        token's logits seed the first output), and mark the request.

        Returns True to DEFER admission: the matched source is still
        prefilling the shared prefix, so the pages the newcomer would adopt
        don't exist yet — admitting now would forfeit the share and
        recompute the whole prompt (the batched-arrival case: N same-prefix
        requests land together, the first warms the pool for the rest)."""
        idx = self.prefix_index
        cap = (len(req.prompt) - 1) // idx.page_size
        src, n = idx.lookup(req.prompt, exclude=stale)
        if src < 0:
            # the only match (if any) is a slot admitted THIS call — its
            # pages don't exist on device yet; wait a step for them rather
            # than recompute the whole prefix
            src_any, n_any = idx.lookup(req.prompt)
            return src_any >= 0 and min(n_any, cap) > 0
        want = min(n, cap)
        have = want
        if self.prefix_probe is not None:
            have = min(want, int(self.prefix_probe(src)))
        if have < want:
            owner = self.slots[src]
            if owner is not None and owner.status == RequestStatus.PREFILLING:
                return True   # prefix still being written — wait for it
        if have > 0:
            req.share_src = src
            req.shared_tokens = have * idx.page_size
            req.prefill_pos = req.shared_tokens
        return False

    def schedule(self) -> list[tuple[int, Request]]:
        """Admit waiting requests into free slots (FIFO). Returns the newly
        admitted (slot, request) pairs — their first chunk is scheduled by
        the same step's :meth:`plan`."""
        admitted = []
        stale: set[int] = set()   # slots reset this step: device rows still
                                  # hold the PREVIOUS occupant's pages
        for slot in self.free_slots():
            if not self.waiting:
                break
            req = self.waiting[0]
            req.prefill_pos = 0
            req.share_src, req.shared_tokens = -1, 0
            if self.prefix_index is not None and \
                    self._match_prefix(req, stale):
                break         # FIFO: defer this request and those behind it
            self.waiting.popleft()
            req.slot = slot
            # admission stamp: queueing (incl. prefix-sharing deferral) ends
            # here; TTFT stays arrival-based, queue_time = this - arrival
            req.admission_time = time.perf_counter()
            req.status = RequestStatus.PREFILLING
            self.slots[slot] = req
            stale.add(slot)
            if self.prefix_index is not None:
                self.prefix_index.insert(slot, req.prompt)
            if self.on_admit is not None:
                self.on_admit(slot, req)
            admitted.append((slot, req))
        return admitted

    def plan(self) -> StepPlan:
        """Admit, then pack one unified step under the token budget."""
        admitted = self.schedule()
        plan = StepPlan(reset=[slot for slot, _ in admitted])
        page = self.prefix_index.page_size if self.prefix_index else 1
        plan.adopt = [(slot, r.share_src, r.shared_tokens // page)
                      for slot, r in admitted if r.share_src >= 0]
        plan.decode = self.active()
        budget = self.token_budget - len(plan.decode)
        for slot, req in self.prefilling():
            if budget <= 0:
                break
            n = min(self.chunk_size, req.prompt_remaining, budget)
            chunk = req.prompt[req.prefill_pos:req.prefill_pos + n]
            completes = req.prefill_pos + n >= len(req.prompt)
            plan.prefill.append((slot, req, chunk, completes))
            budget -= n
        return plan

    def active(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.status == RequestStatus.RUNNING]

    def prefilling(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.status == RequestStatus.PREFILLING]

    def retire(self, req: Request) -> None:
        assert req.finished
        if self.prefix_index is not None:
            self.prefix_index.remove(req.slot)
        self.slots[req.slot] = None
        req.slot = -1
        self.finished.append(req)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_active > 0

"""Device-side step statistics: the int32 stats vector.

Every :class:`~repro_torch.core.paged_cache.PagedLayerCache` may carry a
``(NSTATS,)`` int32 tensor; each pool mutator adds its event counts into it
on the device, from masks it already computed, so the step needs no host
callback. The unified step zeroes each layer's vector on entry, and the
engine sums the per-layer vectors (``transformer.collect_step_stats``) and
reads the one ``(NSTATS,)`` tensor once per step.

Index semantics (counts are summed over B rows and, at the engine level,
over attention layers):

    PAGES_ALLOCATED   alloc_pages successes (a free page left the free list)
    PAGES_FREED       ref_count reached 0 (a page returned to the free list)
    PAGES_RELEASED    single-reference releases (block-table unmaps + CoW
                      source drops; the clamped decrements of _unref_pages)
    PAGES_ADOPTED     prefix-sharing block-table mappings (ref bumps)
    PAGES_FORKED      copy-on-write forks that actually copied
    PAGES_EVICTED     policy page-level evictions (incl. forced)
    TOKENS_EVICTED    token-level evictions that invalidated a live token
    FORCED_EVICTIONS  fragmentation force-evicts (rollover found no free page)
    TOKENS_WRITTEN    token appends that landed

Conservation identities (exact):

    Δ sum(ref_count)  == PAGES_ALLOCATED + PAGES_ADOPTED - PAGES_RELEASED
    Δ free_pages      == PAGES_FREED - PAGES_ALLOCATED
    Δ mapped_entries  == PAGES_ALLOCATED + PAGES_ADOPTED - PAGES_RELEASED
"""
from __future__ import annotations

import torch

PAGES_ALLOCATED = 0
PAGES_FREED = 1
PAGES_RELEASED = 2
PAGES_ADOPTED = 3
PAGES_FORKED = 4
PAGES_EVICTED = 5
TOKENS_EVICTED = 6
FORCED_EVICTIONS = 7
TOKENS_WRITTEN = 8
NSTATS = 9

STAT_NAMES = (
    "pages_allocated", "pages_freed", "pages_released", "pages_adopted",
    "pages_forked", "pages_evicted", "tokens_evicted", "forced_evictions",
    "tokens_written",
)


def zeros(device) -> torch.Tensor:
    return torch.zeros((NSTATS,), dtype=torch.int32, device=device)


def bump(stats, idx: int, count) -> None:
    """stats[idx] += sum(count), in place; no-op when tracking is off
    (``stats is None``). ``count`` may be a bool/int tensor of any shape."""
    if stats is None:
        return
    stats[idx] += count.sum().to(torch.int32)

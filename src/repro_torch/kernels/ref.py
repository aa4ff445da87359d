"""Plain torch oracles of the attention and page-score kernels: dense
softmax over the pool gathered through the block table, causal attention
over contiguous K/V, and the Alg.1 page score. Pools are in the native
(N, page, KV, hd) layout the port's kernels read."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

_EPS = 1e-6


def gather_block_table(k_pool, v_pool, pos, block_table):
    """Materialise the per-request view of a page pool.

    k_pool/v_pool: (N, page, KV, hd); pos: (N, page); block_table: (B, P)
    -> k/v (B, KV, P, page, hd), pos (B, P, page) with unmapped slots -1."""
    mapped = block_table >= 0
    phys = block_table.clamp_min(0).long()
    kg = k_pool[phys].permute(0, 3, 1, 2, 4)
    vg = v_pool[phys].permute(0, 3, 1, 2, 4)
    pg = torch.where(mapped[..., None], pos[phys], -1)
    return kg, vg, pg


def _masked_softmax_av(s, mask, vf):
    """softmax over the last axis of ``s`` where ``mask``; fully masked rows
    give zeros. s: (..., S); vf broadcastable for ``p @ vf``."""
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return p @ vf


def paged_attention_block_table_ref(q, k_pool, v_pool, pos, block_table,
                                    cur_pos, *, window: int = 0,
                                    scale: float | None = None):
    """q: (B, KV, G, hd); cur_pos: (B,) -> (B, KV, G, hd) in q.dtype."""
    B, KV, G, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    kg, vg, pg = gather_block_table(k_pool, v_pool, pos, block_table)
    P, page = kg.shape[2], kg.shape[3]
    kf = kg.reshape(B, KV, P * page, hd).float()
    vf = vg.reshape(B, KV, P * page, hd).float()
    pf = pg.reshape(B, P * page)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), kf) * scale
    mask = (pf >= 0) & (pf <= cur_pos[:, None])
    if window > 0:
        mask &= pf > (cur_pos[:, None] - window)
    return _masked_softmax_av(s, mask[:, None, None, :], vf).to(q.dtype)


def paged_prefill_attention_block_table_ref(q, k_pool, v_pool, pos,
                                            block_table, q_pos, *,
                                            window: int = 0,
                                            scale: float | None = None):
    """q: (B, T, H, hd); q_pos: (B, T) (-1 == padding query)
    -> (B, T, H, hd) in q.dtype; padding queries return zeros."""
    B, T, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    kg, vg, pg = gather_block_table(k_pool, v_pool, pos, block_table)
    KV, P, page = kg.shape[1], kg.shape[2], kg.shape[3]
    G = H // KV
    kf = kg.reshape(B, KV, P * page, hd).float()
    vf = vg.reshape(B, KV, P * page, hd).float()
    pf = pg.reshape(B, P * page)
    qg = q.reshape(B, T, KV, G, hd).float()
    s = torch.einsum("btkgd,bksd->bkgts", qg, kf) * scale
    mask = (pf[:, None, :] >= 0) & (pf[:, None, :] <= q_pos[:, :, None]) & \
        (q_pos[:, :, None] >= 0)
    if window > 0:
        mask &= pf[:, None, :] > (q_pos[:, :, None] - window)
    o = _masked_softmax_av(s, mask[:, None, None], vf[:, :, None])
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype)


def flash_attention_ref(q, k, v, *, window: int = 0,
                        scale: float | None = None):
    """Causal GQA attention, causal by index. q: (B, S, H, hd); k, v:
    (B, S, KV, hd) -> (B, S, H, hd) in q.dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    i = torch.arange(S, device=q.device)
    mask = i[None, :, None] >= i[None, None, :]                  # (1, Sq, Sk)
    if window > 0:
        mask &= i[None, None, :] > (i[None, :, None] - window)
    p = torch.softmax(torch.where(mask[:, None, None], s, -torch.inf), -1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def block_score_ref(k_pages, v_pages, pos):
    """Alg.1 page score: the mean over valid tokens of
    mean_h ||v|| / max(mean_h ||k||, 1e-6); +inf for an empty page.
    k_pages, v_pages: (..., page, KV, hd); pos: (..., page) -> (...,)."""
    kn = torch.linalg.vector_norm(k_pages.float(), dim=-1).mean(-1)
    vn = torch.linalg.vector_norm(v_pages.float(), dim=-1).mean(-1)
    tok = vn / kn.clamp_min(_EPS)
    valid = pos >= 0
    cnt = valid.sum(-1)
    ssum = torch.where(valid, tok, 0.0).sum(-1)
    return torch.where(cnt > 0, ssum / cnt.clamp_min(1), torch.inf)


def page_scores_ref(cache):
    """Per-request Alg.1 page scores (B, P) from the gathered, dequantized
    view of a :class:`PagedLayerCache`; unmapped or empty pages +inf."""
    scores = block_score_ref(cache.k_view(), cache.v_view(),
                             cache.pos_view())
    return torch.where(cache.mapped_mask(), scores, torch.inf)


# ---------------------------------------------------------------------------
# test inputs
# ---------------------------------------------------------------------------

def churned_pool(B, P, page, KV, hd, dtype, seed, shared=4, holes=3,
                 device=None):
    """A pool as the serving path leaves it: block tables over a shuffled
    pool (pages freed and reallocated), each row's slots holding ascending
    pages of its sequence with evicted gaps, a partly filled last page,
    unmapped slots, the first ``shared`` slots of the odd rows mapping row
    0's pages (a shared prefix), and garbage positions on free pages.
    Returns (k, v, pos, bt, cur_pos) on ``device`` (default CUDA); dtype
    torch.int8 gives an int8 pool, and then (k, v, k_scale, v_scale, pos,
    bt, cur_pos) with scales (N, page, KV) f32."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    N = B * P + 8
    bt = torch.randperm(N, generator=g)[:B * P].reshape(B, P).int()
    pos = torch.randint(-1, 4 * P * page, (N, page), generator=g).int()
    cur = torch.zeros(B, dtype=torch.int32)
    for b in range(B):
        rest = torch.randperm(P + 8 - shared, generator=g)[:P - shared]
        ids = list(range(shared)) + sorted((rest + shared).tolist())
        if b % 2 and b:
            bt[b, :shared] = bt[0, :shared]
        for s, pid in enumerate(ids):
            pos[bt[b, s]] = pid * page + torch.arange(page)
        fill = int(torch.randint(1, page + 1, (1,), generator=g))
        pos[bt[b, P - 1], fill:] = -1
        cur[b] = ids[-1] * page + fill - 1
        for _ in range(holes):
            s = int(torch.randint(shared, P - 1, (1,), generator=g))
            bt[b, s] = -1
    k = torch.randn((N, page, KV, hd), generator=g)
    v = torch.randn((N, page, KV, hd), generator=g)
    out = [k.to(dtype), v.to(dtype)]
    if dtype == torch.int8:
        out = [torch.randint(-127, 128, k.shape, generator=g).to(dtype),
               torch.randint(-127, 128, v.shape, generator=g).to(dtype),
               torch.rand((N, page, KV), generator=g) * 4,
               torch.rand((N, page, KV), generator=g) * 4]
    return tuple(t.to(device) for t in (*out, pos, bt, cur))


def prefill_positions(cur, T):
    """q_pos of a mixed step: row 0 prefills a full chunk ending at its
    newest token, row 1 a partial one, the last row is idle (all padding),
    the other rows decode one token (T - 1 padding queries). On
    ``cur``'s device."""
    B = cur.shape[0]
    qp = torch.full((B, T), -1, dtype=torch.int32, device=cur.device)
    t = torch.arange(T, dtype=torch.int32, device=cur.device)
    qp[0] = cur[0] - (T - 1) + t
    n1 = T // 3
    qp[1, :n1] = cur[1] - (n1 - 1) + t[:n1]
    for b in range(2, B - 1):
        qp[b, 0] = cur[b]
    return qp

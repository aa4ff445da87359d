"""The one-shot prefill and decode over a grid: the regions of
``transformer.forward_prefill`` / ``decode_step`` computed on each rank's
local shards, with their collectives written out.

Over a (data, model) grid (``sharding.rules``; ``ac`` an
``activation_constraint``) the parameters are DTensors placed by
``param_shardings`` and the caches are laid out by ``cache_shardings``
(``place_cache``: every pool buffer without its trash row). What DTensor
propagates correctly (norms, projections, the MLP, the MoE regions of
training, the logits) runs on DTensors; the rest runs here:

- **Attention** (``attention._grid_attention``): each rank's rows and
  query heads, K/V by KV head when the model axes divide them, else each
  query head's KV head; on CUDA shards the flash kernel (K5).
- **Compression and paging** (:func:`compress_and_page`): Alg. 2 on the
  rank's rows (and KV heads: the policy's head means are summed over the
  model axes, one all-reduce), then one all-gather of the selections over
  the data axes, every rank writing the whole batch's prompt pages
  (``core.prefill.page_selection``, the one-device page placement) for
  its heads and keeping its shard of the pool.
- **Decode** (:func:`decode_attention`): the pool's pages are not local to
  their rows (the allocator takes the lowest free page of the whole pool,
  as the JAX package's; rules.py:167-171), so each rank all-gathers the
  layer's pool over the page dimension (its KV heads only, when they
  split) and the metadata whole, all-gathers the new token's K/V over the
  data axes, runs the one-device bookkeeping (``decode_append``: write,
  rollover, Alg. 3 eviction) on the whole batch, and attends its own rows
  and query heads only (K1 / K2 on CUDA shards); then keeps its shard of
  the pool. The bookkeeping is integer work repeated on every rank; the
  attention's FLOPs are split.
- **Recurrent mixers** (:func:`recurrent_prefill`, :func:`recurrent_decode`):
  the mixer's weights all-gathered whole, the one-device mixer run on the
  rank's rows, the state kept by its cache spec (the mixer's work is
  repeated over the model axes).

Without a grid nothing here runs. The fused score epilogue
(``fused_scores``) is refused over a grid: a rank that holds a slice of
a KV head's query group would count its norms twice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.core.decode import decode_append
from repro_torch.core.paged_cache import PagedLayerCache
from repro_torch.core.policies import get_policy, plain_kw
from repro_torch.core.prefill import compress, page_selection
from repro_torch.models import attention as attn_mod
from repro_torch.obs.trace import annotation
from repro_torch.sharding import rules


class AxisGroup:
    """A policy's ``tp_group`` over grid axes: the head means of its scores
    averaged over the ranks that hold the other KV heads (one functional
    all-reduce per axis)."""

    def __init__(self, grid, axes: tuple):
        self.mesh, self.axes = rules._mesh(grid), axes
        self.size = rules.axis_size(grid, *axes)

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        for a in self.axes:
            t = funcol.wait_tensor(funcol.all_reduce(
                t, "sum", self.mesh.get_group(a)))
        return t / self.size


def _kv_axes(grid, cfg):
    """The model axes when they split the KV heads, else None."""
    msz = rules.model_size(grid)
    return rules.model_axes(grid) if msz > 1 and \
        cfg.num_kv_heads % msz == 0 else None


def _policy(policy, grid, hk):
    """``policy``, or a fresh one whose head means cross the model axes
    when the KV heads split over them."""
    if hk is None:
        return policy
    return get_policy(policy.name,
                      tp_group=AxisGroup(grid, rules.axes_of(hk)))


def gather(x: DTensor, keep: tuple = ()) -> torch.Tensor:
    """This rank's tensor of ``x`` whole along every dimension but those of
    ``keep`` (all-gathers over the axes that split them)."""
    pl = [p if p.is_shard() and p.dim in keep else Replicate()
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl).to_local()


def scatter(grid, t: torch.Tensor, spec: tuple, keep: tuple = ()) -> DTensor:
    """A DTensor laid out by ``spec`` from ``t``, whole on this rank along
    every dimension but those of ``keep`` (already this rank's shard
    there): each other dimension cut to this rank's chunk, no
    collective. A cut chunk is copied out: as a view it would keep all of
    ``t`` alive on this rank."""
    mesh = rules._mesh(grid)
    pl = rules.placements(grid, spec)
    cut = [p if p.is_shard() and p.dim not in keep else Replicate()
           for p in pl]
    local = rules._cut(mesh, t, cut)
    local = local.clone(memory_format=torch.contiguous_format) \
        if local.numel() < t.numel() else local.contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False)


def _rows(grid, t: torch.Tensor, b, keep_heads=None) -> torch.Tensor:
    """The whole batch of a local per-row tensor ``t`` (dimension 0 this
    rank's rows over ``b``; dimension 2 its heads over ``keep_heads``):
    one all-gather over the data axes."""
    spec = (b,) + (None,) * (t.dim() - 1)
    keep = ()
    if keep_heads is not None:
        spec = spec[:2] + (keep_heads,) + spec[3:]
        keep = (2,)
    return gather(rules.from_local(grid, t, spec), keep)


_POOL = ("k_buf", "v_buf", "k_scale_buf", "v_scale_buf")


def shard_layer_cache(grid, cfg, whole: PagedLayerCache, batch: int,
                      heads_local: bool) -> PagedLayerCache:
    """A layer cache whole on this rank (its KV heads only when
    ``heads_local``) laid out by ``rules.cache_spec``, each buffer
    without its trash row."""
    out = {}
    for f in dataclasses.fields(whole):
        t = getattr(whole, f.name)
        if t is None:
            continue
        spec = rules.cache_spec(grid, cfg, f"layers/0/{f.name}",
                                tuple(t.shape), batch)
        if f.name in rules._JAX_NAME:
            t = t[:-1]
        keep = (2,) if heads_local and f.name in _POOL else ()
        out[f.name] = scatter(grid, t, spec, keep)
    return dataclasses.replace(whole, **out)


def whole_layer_cache(c: PagedLayerCache, heads_local: bool
                      ) -> PagedLayerCache:
    """A grid layer cache gathered whole on this rank (its KV heads only
    when ``heads_local``), each buffer given a fresh trash row."""
    out = {}
    for f in dataclasses.fields(c):
        t = getattr(c, f.name)
        if t is None:
            continue
        keep = (2,) if heads_local and f.name in _POOL else ()
        out[f.name] = rules.with_trash_row(f.name, gather(t, keep))
    return dataclasses.replace(c, **out)


def compress_and_page(cfg, k, v, positions, valid, policy, ccfg,
                      seq_len_hint: int, cache_dtype, ac) -> PagedLayerCache:
    """``core.prefill.compress_and_page`` over the grid: k, v (B, S, KV, hd)
    and positions / valid (B, S) DTensors -> the layer's cache laid out by
    ``cache_shardings`` (module docstring)."""
    grid, b = ac.grid, ac.batch_axes
    hk = _kv_axes(grid, cfg)
    kl, vl = (rules.to_local(grid, t, (b, None, hk, None)) for t in (k, v))
    pl, okl = (rules.to_local(grid, t, (b, None)) for t in (positions, valid))
    k_sel, v_sel, pos_sel, score_sel, num_pages = compress(
        kl, vl, pl, okl, _policy(policy, grid, hk), ccfg, seq_len_hint)
    k_sel, v_sel = (_rows(grid, t, b, hk) for t in (k_sel, v_sel))
    pos_sel, score_sel = (_rows(grid, t, b) for t in (pos_sel, score_sel))
    whole = page_selection(k_sel, v_sel, pos_sel, score_sel, num_pages,
                           ccfg.page_size, cache_dtype)
    return shard_layer_cache(grid, cfg, whole, whole.batch, hk is not None)


def place_cross(cfg, xc, ac):
    """A layer's conditioning K/V (``attention.StaticKVCache`` of
    DTensors) laid out by its cache spec."""
    return dataclasses.replace(xc, **{
        n: rules.place(ac.grid, t, rules.cache_spec(
            ac.grid, cfg, f"cross/0/{n}", tuple(t.shape), t.shape[0]))
        for n in ("k", "v") for t in (getattr(xc, n),)})


def _head_view(c: PagedLayerCache, rows: slice, lo: int, hi: int,
               whole_heads: bool) -> PagedLayerCache:
    """The cache as the attention of rows ``rows`` sees it, over KV heads
    [lo, hi) of the pool (a copy when that is not all of them)."""
    def heads(t):
        if t is None or whole_heads:
            return t
        return t[:, :, lo:hi].contiguous()
    return dataclasses.replace(
        c, k_buf=heads(c.k_buf), v_buf=heads(c.v_buf),
        k_scale_buf=heads(c.k_scale_buf), v_scale_buf=heads(c.v_scale_buf),
        block_table=c.block_table[rows], cur_page=c.cur_page[rows],
        cur_off=c.cur_off[rows])


def decode_attention(lp: dict, cfg, h, kvc: PagedLayerCache, cur_pos, active,
                     policy, ccfg, window: int, decode_splits: int,
                     plain: bool, ac):
    """One attention layer of ``decode_step`` over the grid (module
    docstring). h: (B, D) DTensor, the normed input; ``kvc`` the layer's
    grid cache; cur_pos (B,) and active (B,) DTensors. Returns (the
    attention's output after ``wo``, (B, D) DTensor, the new grid cache).
    """
    grid, b = ac.grid, ac.batch_axes
    G = cfg.num_heads // cfg.num_kv_heads
    hk = _kv_axes(grid, cfg)
    msz, MA = rules.model_size(grid), rules.model_axes(grid)
    hq = MA if msz > 1 and cfg.num_heads % msz == 0 else None
    # the projections on DTensors (as the prefill's), then this rank's
    # rows and heads
    with annotation("decode.qkv"):
        q, k, v = attn_mod.decode_project_qkv(lp, cfg, h, cur_pos)
        qd = rules.place(grid, q, (b, hq, None))
        h0 = rules.shard_offset(qd, 1)
        q = qd.to_local()
        kv0 = rules.shard_offset(rules.place(grid, k, (b, hk, None)), 1)
        k, v = (rules.to_local(grid, t, (b, hk, None)) for t in (k, v))
    pos_l = rules.to_local(grid, cur_pos, (b,))
    B_l, H_l = q.shape[:2]
    r0 = rules.shard_offset(rules.place(grid, cur_pos, (b,)), 0)
    k_all, v_all = (_rows(grid, t, b) for t in (k, v))
    whole = whole_layer_cache(kvc, hk is not None)
    out = []
    # the KV heads this rank's query heads read, within its pool's heads
    lo = h0 // G - kv0
    hi = (h0 + H_l - 1) // G + 1 - kv0
    whole_heads = hk is not None or (lo == 0 and hi == whole.k_buf.shape[2])
    if H_l % (hi - lo) or (h0 % G and h0 % H_l):
        raise ValueError(f"query heads [{h0}, {h0 + H_l}) do not split "
                         f"evenly over their KV heads (group {G})")

    def attend(c):
        with annotation("decode.attn"):
            o, _ = attn_mod.decode_attention(
                q, _head_view(c, slice(r0, r0 + B_l), lo, hi, whole_heads),
                cur_pos=pos_l, window=window, num_splits=decode_splits,
                plain=plain)
        out.append(o)

    decode_append(whole, k_all, v_all, rules.full(cur_pos),
                  _policy(policy, grid, hk), ccfg, active=rules.full(active),
                  attend=attend, **plain_kw(plain))
    with annotation("decode.attn"):
        o = rules.from_local(grid, out[0].reshape(B_l, -1), (b, hq))
        o = o @ lp["wo"]
    return o, shard_layer_cache(grid, cfg, whole, whole.batch, hk is not None)


def _place_state(grid, cfg, state, batch: int, i: int = 0):
    """A recurrent state of this rank's rows (whole elsewhere) laid out by
    its cache specs."""
    b = rules.batch_axes(grid, batch)
    out = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        spec = rules.cache_spec(grid, cfg, f"layers/{i}/{f.name}",
                                (batch,) + tuple(t.shape[1:]), batch)
        rows = rules.from_local(grid, t, (b,) + (None,) * (t.dim() - 1))
        out[f.name] = rules.place(grid, rows, spec)
    return type(state)(**out)


def recurrent_prefill(mixer_fn, params: dict, cfg, h, ac):
    """A recurrent mixer of ``forward_prefill`` over the grid:
    ``mixer_fn(params, cfg, h) -> (out, state)`` on this rank's rows of
    h (B, S, D) with the mixer's weights whole. Returns (out DTensor, the
    state laid out by its cache specs)."""
    grid, b = ac.grid, ac.batch_axes
    hl = rules.to_local(grid, h, (b, None, None))
    out, state = mixer_fn(rules.map_tree(params, lambda t, _: rules.full(t)),
                          cfg, hl)
    return (rules.from_local(grid, out, (b, None, None)),
            _place_state(grid, cfg, state, h.shape[0]))


def recurrent_decode(step_fn, params: dict, cfg, h, state, ac):
    """A recurrent layer's one-token step of ``decode_step`` over the grid:
    the state gathered whole but for its rows, ``step_fn`` on this rank's
    rows with the mixer's weights whole. Returns (out (B, D) DTensor, the
    new state laid out by its cache specs)."""
    grid, b = ac.grid, ac.batch_axes
    hl = rules.to_local(grid, h, (b, None))
    local = type(state)(**{
        f.name: rules.to_local(grid, t, (b,) + (None,) * (t.dim() - 1))
        for f in dataclasses.fields(state)
        for t in (getattr(state, f.name),)})
    out, new = step_fn(rules.map_tree(params, lambda t, _: rules.full(t)),
                       cfg, hl, local)
    return (rules.from_local(grid, out, (b, None)),
            _place_state(grid, cfg, new, h.shape[0]))

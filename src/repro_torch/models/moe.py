"""Mixture-of-Experts MLP (Mixtral style), as the JAX package's
``repro.models.moe`` on one device.

A top-k softmax router in f32 (its weights stay f32 in every model dtype)
feeds two routines, each used where the JAX package uses it:

- :func:`moe_forward`, the sort-based capacity dispatch over a contiguous
  (B, S, D) sequence (training and the one-shot prefill): each example's
  assignments are ranked within their expert, those at or past the capacity
  dropped (their token keeps only its residual path), and the experts run
  as one batched product over a (B, E, capacity, D) buffer;
- :func:`moe_forward_decode`, the dense all-expert combine over (N, D)
  tokens (the serving step and one-shot decode): every expert computes
  every token and the top-k gates weigh them, so no token is dropped.

Plain torch: the JAX package computes all of it in jnp, outside any
kernel. Under tensor-parallel serving the dense combine splits every
expert's d_ff over the ranks (``group``).

Training over a grid (``ac`` from ``sharding.rules.activation_constraint``)
runs the capacity dispatch on each rank's shards, as the JAX package's two
``shard_map`` regions (moe.py:206-285): on the (data, model) grid each rank
routes its data shard's tokens and computes every expert's d_ff shard,
the f32 expert outputs summed over ``model``; on the expert-parallel grid
(data, expert, tp) the batch splits over (data, expert) too, an
all-to-all over ``expert`` delivers each expert's tokens to its owner,
which computes its d_ff shard (summed over ``tp``), and the reverse
all-to-all brings them home. ``load``, ``dropped`` and ``aux`` are
averaged over the batch axes. Without a grid the block runs as on one
device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init, dtype_of
from repro_torch.obs.trace import annotation
from repro_torch.sharding import rules


class MoEStats(NamedTuple):
    load: torch.Tensor       # (E,) share of the routed assignments per expert
    dropped: torch.Tensor    # () share of the assignments dropped
    aux_loss: torch.Tensor   # () load-balance loss (Switch style)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """{"router" (D, E) f32, "w_gate" / "w_up" (E, D, F), "w_down" (E, F,
    D)}; each expert drawn on its own, so that the f32 draw stays one
    expert's size."""
    dt = dtype_of(cfg.dtype)
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff

    def experts(i, o):
        w = torch.empty((E, i, o), dtype=dt, device=gen.device)
        for e in range(E):
            w[e] = dense_init(gen, i, o, dt)
        return w
    return {"router": dense_init(gen, D, E, torch.float32),
            "w_gate": experts(D, Fd), "w_up": experts(D, Fd),
            "w_down": experts(Fd, D)}


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert and example: the capacity factor times the fair
    share, rounded up to a multiple of 8, as the JAX package's (which
    tokens drop depends on it)."""
    per_expert = tokens_per_group * cfg.num_experts_per_tok / cfg.num_experts
    cap = int(cfg.moe_capacity_factor * per_expert)
    return max(cap - cap % -8, 8)


def route(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """x (..., D) -> (probs (..., E) f32, gates (..., K) f32 renormalised
    over the top k, experts (..., K) int64). Ties go to the lower expert
    index, as ``jax.lax.top_k``'s (a stable descending sort)."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.num_experts_per_tok
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def rank_in_expert(flat_e: torch.Tensor) -> torch.Tensor:
    """flat_e (B, A) expert per assignment -> (B, A) rank of each
    assignment within its expert, in assignment order: a stable sort by
    expert, each run's start carried forward by a cummax, the ranks
    scattered back."""
    B, A = flat_e.shape
    perm = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, perm)
    iota = rules.whole_like(
        torch.arange(A, device=flat_e.device).expand(B, A), flat_e)
    start = torch.cat([rules.whole_like(torch.ones(
        (B, 1), dtype=torch.bool, device=flat_e.device), flat_e),
        sorted_e[:, 1:] != sorted_e[:, :-1]], dim=1)
    run_base = torch.cummax(torch.where(start, iota, -1), dim=1).values
    return torch.zeros_like(perm).scatter(1, perm, iota - run_base)


def dispatch(flat_e: torch.Tensor, num_experts: int, cap: int):
    """(rank, keep, dst), each (B, A): an assignment is kept when its rank
    is below ``cap``; kept ones go to slot expert * cap + rank of the
    dispatch buffer, dropped ones to the extra slot E * cap."""
    rank = rank_in_expert(flat_e)
    keep = rank < cap
    dst = torch.where(keep, flat_e * cap + rank, num_experts * cap)
    return rank, keep, dst


def _dispatch_buffer(params: dict, cfg: ModelConfig, x, x_disp, cap: int):
    """Route x (B, S, D) and fill the (B, E, cap, D) dispatch buffer from
    ``x_disp`` (x's value; the copy whose gradient the experts give) ->
    (probs, gates, experts, keep, dst, buffer)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    A = S * K
    probs, top_p, top_e = route(params, cfg, x)
    _, keep, dst = dispatch(top_e.reshape(B, A), E, cap)
    token_of = rules.whole_like(torch.arange(A, device=x.device) // K, x)
    rows = rules.whole_like(torch.arange(B, device=x.device)[:, None], x)
    buf = x_disp.new_zeros((B, E * cap + 1, D))
    buf[rows, dst] = x_disp[:, token_of]
    return probs, top_p, top_e, keep, dst, buf[:, :-1].reshape(B, E, cap, D)


def _combine(cfg: ModelConfig, eout, keep, dst, top_p, probs, top_e, dtype):
    """The experts' outputs eout (B, E, cap, D) gathered back to the
    tokens and weighed by their gates -> (out (B, S, D), MoEStats)."""
    B, E, cap, D = eout.shape
    K = cfg.num_experts_per_tok
    A = dst.shape[1]
    eflat = eout.reshape(B, E * cap, D)
    safe = dst.clamp_max(E * cap - 1)
    gathered = eflat.gather(1, safe[..., None].expand(B, A, D))
    gathered = torch.where(keep[..., None], gathered, 0.0)
    weighted = gathered * top_p.reshape(B, A, 1).to(dtype)
    out = weighted.reshape(B, A // K, K, D).sum(2).to(dtype)
    load = F.one_hot(top_e, E).float().mean((0, 1, 2))
    aux = E * (load * probs.mean((0, 1))).sum()
    dropped = 1.0 - keep.float().mean()
    return out, MoEStats(load, dropped, aux)


def _moe_block(params: dict, cfg: ModelConfig, x: torch.Tensor, cap: int,
               x_disp=None, reduce=None):
    """Dispatch -> experts -> combine. x: (B, S, D) -> (out, MoEStats).
    ``reduce``: the sum over the ranks that hold the experts' other d_ff
    shards, applied to their f32 outputs (the JAX package's ``psum_axis``);
    ``x_disp``: the dispatch source (default x). The three stages are the
    spans ``moe.dispatch``, ``moe.experts`` and ``moe.combine``."""
    with annotation("moe.dispatch"):
        probs, top_p, top_e, keep, dst, buf = _dispatch_buffer(
            params, cfg, x, x if x_disp is None else x_disp, cap)
    with annotation("moe.experts"):
        act = activation(cfg.act)
        h = act(torch.einsum("becd,edf->becf", buf, params["w_gate"])) * \
            torch.einsum("becd,edf->becf", buf, params["w_up"])
        if reduce is None:
            eout = torch.einsum("becf,efd->becd", h, params["w_down"])
        else:
            eout = reduce(torch.einsum("becf,efd->becd", h.float(),
                                       params["w_down"].float())).to(x.dtype)
    with annotation("moe.combine"):
        return _combine(cfg, eout, keep, dst, top_p, probs, top_e, x.dtype)


def _moe_block_ep(params: dict, cfg: ModelConfig, x, x_disp, cap: int,
                  ep: int, a2a, reduce):
    """The expert-parallel block on one rank's shards (the JAX package's
    ``_moe_block_ep``): x (B_loc, S, D); w_gate / w_up (E / ep, D,
    F_loc), w_down (E / ep, F_loc, D); ``a2a`` the all-to-all over the
    expert axis, ``reduce`` the sum over ``tp``."""
    B, S, D = x.shape
    E = cfg.num_experts
    E_loc = E // ep
    with annotation("moe.dispatch"):
        probs, top_p, top_e, keep, dst, buf = _dispatch_buffer(
            params, cfg, x, x_disp, cap)
        # forward all-to-all: each expert's slots to the rank that holds it
        t = a2a(buf.movedim(1, 0).reshape(ep, E_loc, B, cap, D))
        h_in = t.movedim(1, 0).reshape(E_loc, ep * B * cap, D)
    with annotation("moe.experts"):
        act = activation(cfg.act)
        h = act(torch.matmul(h_in, params["w_gate"])) * \
            torch.matmul(h_in, params["w_up"])
        eo = reduce(torch.matmul(h.float(), params["w_down"].float()))
    with annotation("moe.combine"):
        eo = eo.to(x.dtype).reshape(E_loc, ep, B, cap, D).movedim(1, 0)
        # reverse all-to-all: the outputs home
        eout = a2a(eo).reshape(E, B, cap, D).movedim(1, 0)
        return _combine(cfg, eout, keep, dst, top_p, probs, top_e, x.dtype)


def _mean_stats(grid, stats: MoEStats, axes: tuple) -> MoEStats:
    """Each statistic averaged over the grid axes ``axes`` (a sum, then
    divided by their size: ``jax.lax.pmean``)."""
    n = rules.axis_size(grid, *axes)
    return MoEStats(*(rules.sum_over(grid, v, (None,) * v.dim(), axes) / n
                      for v in stats))


def _model_region(params: dict, cfg: ModelConfig, x, cap: int, grid, bax):
    """The (data, model) region: each rank its data shard's tokens and
    every expert's d_ff shard, the f32 outputs summed over ``model``. The
    router's input keeps a whole gradient over ``model``; the experts'
    input a partial one (each rank's d_ff shard), as each weight's over
    the data axes (each its shard's tokens)."""
    bx = rules.axes_of(bax)
    xs = (bax, None, None)
    p = {"router": rules.to_local(grid, params["router"], (None, None), bx)}
    for k, spec in (("w_gate", (None, None, "model")),
                    ("w_up", (None, None, "model")),
                    ("w_down", (None, "model", None))):
        p[k] = rules.to_local(grid, params[k], spec, bx)
    out, stats = _moe_block(
        p, cfg, rules.to_local(grid, x, xs), cap,
        x_disp=rules.to_local(grid, x, xs, ("model",)),
        reduce=lambda e: rules.sum_over(grid, e, (bax, None, None, None),
                                        ("model",)).to_local())
    return rules.from_local(grid, out, xs), _mean_stats(grid, stats, bx)


def _expert_region(params: dict, cfg: ModelConfig, x, cap: int, grid, bax):
    """The expert-parallel region: the batch split over (data..., expert),
    each rank holding E / ep experts' d_ff shard over ``tp``."""
    bx = rules.axes_of(bax)
    bxe = bx + ("expert",)
    xs = (bxe, None, None)
    p = {"router": rules.to_local(grid, params["router"], (None, None), bxe)}
    for k, spec in (("w_gate", ("expert", None, "tp")),
                    ("w_up", ("expert", None, "tp")),
                    ("w_down", ("expert", "tp", None))):
        p[k] = rules.to_local(grid, params[k], spec, bx)
    out, stats = _moe_block_ep(
        p, cfg, rules.to_local(grid, x, xs),
        rules.to_local(grid, x, xs, ("tp",)), cap,
        rules.grid_shape(grid)["expert"],
        a2a=lambda t: rules.all_to_all(grid, t, "expert"),
        reduce=lambda e: rules.sum_over(grid, e, ("expert", bax, None),
                                        ("tp",)).to_local())
    return rules.from_local(grid, out, xs), _mean_stats(grid, stats, bxe)


def moe_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                capacity: int | None = None, ac=None):
    """x (B, S, D) -> (out (B, S, D), MoEStats), the capacity dispatch per
    example (``capacity`` default :func:`moe_capacity` of S). With ``ac``
    over a grid whose data axes split the batch: the expert-parallel region
    when the grid has an ``expert`` axis that divides the experts (and
    ``tp`` d_ff), else the (data, model) region when ``model`` divides
    d_ff, as the JAX package chooses; otherwise the block as on one
    device (over DTensors, their layouts propagated op by op)."""
    cap = capacity or moe_capacity(cfg, x.shape[1])
    grid = getattr(ac, "grid", None)
    bax = getattr(ac, "batch_axes", None)
    if grid is not None and bax is not None:
        Fd, E = params["w_gate"].shape[-1], cfg.num_experts
        shape = rules.grid_shape(grid)
        if "expert" in shape and E % shape["expert"] == 0 and \
                Fd % shape["tp"] == 0:
            return _expert_region(params, cfg, x, cap, grid, bax)
        if "model" in shape and Fd % shape["model"] == 0:
            return _model_region(params, cfg, x, cap, grid, bax)
    return _moe_block(params, cfg, x, cap)


def _grid_decode(params: dict, cfg: ModelConfig, x, ac):
    """:func:`moe_forward_decode` over a grid (DTensor x (N, D), its rows
    over the data axes), on each rank's shards: the router whole, each
    rank's experts (all of them, or its ``expert`` share) on its slice of
    d_ff, the gate combine of its experts' partial outputs, then one f32
    sum over the axes that split the experts or d_ff (the order of
    :func:`moe_forward_decode`'s)."""
    grid, b = ac.grid, ac.batch_axes
    xl = rules.to_local(grid, x, (b, None))
    _, top_p, top_e = route({"router": rules.full(params["router"])}, cfg,
                            xl)
    gate = torch.zeros((xl.shape[0], cfg.num_experts), dtype=torch.float32,
                       device=xl.device).scatter(1, top_e, top_p)
    w = {k: params[k].to_local() if isinstance(params[k], DTensor)
         else params[k] for k in ("w_gate", "w_up", "w_down")}
    e0 = rules.shard_offset(params["w_gate"], 0) \
        if isinstance(params["w_gate"], DTensor) else 0
    act = activation(cfg.act)
    h = act(torch.matmul(xl, w["w_gate"])) * torch.matmul(xl, w["w_up"])
    eout = torch.matmul(h, w["w_down"])                    # (E_l, N_l, D)
    out = torch.einsum("ebd,be->bd", eout.float(),
                       gate[:, e0:e0 + eout.shape[0]])
    names = list(rules.grid_shape(grid))
    split = tuple(names[i] for i, p in
                  enumerate(getattr(params["w_gate"], "placements", ()))
                  if p.is_shard())
    out = rules.sum_over(grid, out, (b, None), split) if split else \
        rules.from_local(grid, out, (b, None))
    return out.to(x.dtype)


def moe_forward_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       group=None, ac=None) -> torch.Tensor:
    """x (N, D) -> (N, D): the dense all-expert combine (every expert on
    every token, weighed by the top-k gates). Sharded, under tensor
    parallelism (``group``: each rank holds every expert's slice of d_ff)
    or over a grid (DTensor x, ``ac`` the activation constraint;
    :func:`_grid_decode`), every rank runs the router whole (f32), gates
    its partial expert outputs, and the (N, D) f32 combines are summed
    over the ranks. The JAX package sums the (E, N, D) expert outputs
    before the combine: summing after it moves E times fewer bytes and
    differs by rounding only."""
    if isinstance(x, DTensor):
        return _grid_decode(params, cfg, x, ac)
    N = x.shape[0]
    _, top_p, top_e = route(params, cfg, x)
    gate = torch.zeros((N, cfg.num_experts), dtype=torch.float32,
                       device=x.device).scatter(1, top_e, top_p)
    act = activation(cfg.act)
    # the JAX package's einsums "bd,edf->ebf" and "ebf,efd->ebd" as
    # matmuls batched over the experts: torch.einsum folds e into one
    # GEMM's columns for "bd,edf->ebf" and so copies the whole (E, D, F)
    # weight stack on every call (6 GiB for jamba-1.5-large)
    h = act(torch.matmul(x, params["w_gate"])) * \
        torch.matmul(x, params["w_up"])                    # (E, N, F)
    eout = torch.matmul(h, params["w_down"])               # (E, N, D)
    out = torch.einsum("ebd,be->bd", eout.float(), gate)
    if group is not None:
        out = group.all_reduce_sum(out)
    return out.to(x.dtype)

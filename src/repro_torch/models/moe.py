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
expert's d_ff over the ranks (``group``). Expert parallelism (the JAX
package's ``_moe_block_ep``, experts placed on an "expert" mesh axis with
all-to-all dispatch) is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init, dtype_of


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
    iota = torch.arange(A, device=flat_e.device).expand(B, A)
    start = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                  device=flat_e.device),
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


def _moe_block(params: dict, cfg: ModelConfig, x: torch.Tensor, cap: int):
    """Dispatch -> experts -> combine. x: (B, S, D) -> (out, MoEStats)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    A = S * K
    probs, top_p, top_e = route(params, cfg, x)
    _, keep, dst = dispatch(top_e.reshape(B, A), E, cap)

    token_of = torch.arange(A, device=x.device) // K
    buf = x.new_zeros((B, E * cap + 1, D))
    buf[torch.arange(B, device=x.device)[:, None], dst] = x[:, token_of]
    buf = buf[:, :-1].reshape(B, E, cap, D)

    act = activation(cfg.act)
    h = act(torch.einsum("becd,edf->becf", buf, params["w_gate"])) * \
        torch.einsum("becd,edf->becf", buf, params["w_up"])
    eout = torch.einsum("becf,efd->becd", h, params["w_down"])

    eflat = eout.reshape(B, E * cap, D)
    safe = dst.clamp_max(E * cap - 1)
    gathered = eflat.gather(1, safe[..., None].expand(B, A, D))
    gathered = torch.where(keep[..., None], gathered, 0.0)
    weighted = gathered * top_p.reshape(B, A, 1).to(x.dtype)
    out = weighted.reshape(B, S, K, D).sum(2).to(x.dtype)

    load = F.one_hot(top_e, E).float().mean((0, 1, 2))
    aux = E * (load * probs.mean((0, 1))).sum()
    dropped = 1.0 - keep.float().mean()
    return out, MoEStats(load, dropped, aux)


def moe_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                capacity: int | None = None, ac=None):
    """x (B, S, D) -> (out (B, S, D), MoEStats), the capacity dispatch per
    example (``capacity`` default :func:`moe_capacity` of S). ``ac`` (the
    JAX package's activation sharding) is not ported and raises."""
    if ac is not None:
        raise NotImplementedError("the torch port runs the MoE block "
                                  "without sharding: ac is not ported")
    cap = capacity or moe_capacity(cfg, x.shape[1])
    return _moe_block(params, cfg, x, cap)


def moe_forward_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       group=None) -> torch.Tensor:
    """x (N, D) -> (N, D): the dense all-expert combine (every expert on
    every token, weighed by the top-k gates). Under tensor parallelism
    (``group``) each rank holds every expert's slice of d_ff; the router
    runs whole on every rank (f32), and the partial expert outputs are
    summed over the ranks in f32 before the gate combine, as in the JAX
    package (summing after the combine would move E times fewer bytes;
    parity comes first)."""
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
    if group is not None:
        eout = group.all_reduce_sum(eout.float())
    return torch.einsum("ebd,be->bd", eout.float(), gate).to(x.dtype)

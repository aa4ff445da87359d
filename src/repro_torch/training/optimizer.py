"""AdamW with linear warmup and cosine decay, as the JAX package's
``training/optimizer.py``.

The state mirrors the parameters: f32 first and second moments per leaf
and the step count. ``adamw_update`` computes in f32 and casts each new
parameter back to its dtype (bf16 at full width). The schedule and the
bias corrections are f32 tensor arithmetic, as the JAX package's
(``step.astype(f32)``, ``jnp.cos``), not Python doubles. Weight decay
skips the leaves whose name holds one of :data:`NO_DECAY` (norms'
``scale``, the qkv biases), the set the JAX package's mask picks.

Over a grid (DTensor leaves, ``sharding.rules``), each gradient is
taken to f32 and redistributed to its moment's layout (an all-reduce over
the data axes, or with ZeRO-1 moments a reduce-scatter over ``data``),
the update runs on each rank's shards, and each new parameter is
redistributed back to its own layout (with ZeRO-1 an all-gather over
``data``). The moments' own placement is the layout: the port's
counterpart of the JAX package's ``moment_shardings``, which a traced
array inside ``jit`` needs and a DTensor carries.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial

from repro_torch.training.tree import leaves, leaves_with_path, map_leaves, \
    rebuild


class AdamWState(NamedTuple):
    step: int            # optimizer steps taken
    mu: Any              # first moment (f32, like params)
    nu: Any              # second moment (f32)


class AdamWConfig(NamedTuple):
    lr_peak: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    grad_clip: float = 1.0


# substrings of a leaf's name that exempt it from weight decay (the JAX
# package's list; it tests str(path[-1]), "['scale']", the port the name)
NO_DECAY = ("norm", "bias", "scale", "b_gates", "b_igate", "b_fgate",
            "bq", "bk", "bv", "dt_bias", "A_log", "D", "conv_b")


def init_adamw(params) -> AdamWState:
    """Zero f32 moments of each parameter's shape, device and (for a
    DTensor) layout."""
    zeros = lambda p: torch.zeros_like(  # noqa: E731
        p, dtype=torch.float32, requires_grad=False)
    return AdamWState(step=0, mu=map_leaves(zeros, params),
                      nu=map_leaves(zeros, params))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to lr_min_ratio * peak: a () f32
    tensor on the CPU (a scalar to the device's arithmetic)."""
    step = _f32(step)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_peak * (cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) *
                         0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def decay_mask(path: tuple) -> bool:
    """Weight decay on matrices only: not on norms or biases."""
    last = str(path[-1]) if path else ""
    return not any(t in last for t in NO_DECAY)


# leaves are updated in groups of at most this many elements: one
# multi-tensor launch per operation and group (the per-leaf loop launched
# ~60 aten ops per leaf, the host's cost at TINY's size), while the f32
# temporaries of a group stay a few times its size at full width
GROUP_ELEMENTS = 1 << 26
_mul, _add, _sub, _div, _sqrt = (torch._foreach_mul, torch._foreach_add,
                                 torch._foreach_sub, torch._foreach_div,
                                 torch._foreach_sqrt)


def _groups(sizes: list[int]):
    group, total = [], 0
    for i, n in enumerate(sizes):
        if group and total + n > GROUP_ELEMENTS:
            yield group
            group, total = [], 0
        group.append(i)
        total += n
    if group:
        yield group


def _grid_norm(gs: list) -> torch.Tensor:
    """The global norm of DTensor gradients: each rank sums the squares of
    its shards, a leaf whole over a grid axis divided by that axis's size
    (counted once over its copies), and one DTensor reduction sums the
    ranks' totals."""
    mesh = gs[0].device_mesh
    total = 0.0
    for g in gs:
        copies = math.prod(n for n, pl in zip(mesh.shape, g.placements)
                           if not pl.is_shard())
        total = total + g.to_local().float().square().sum() / copies
    return torch.sqrt(DTensor.from_local(
        torch.as_tensor(total, dtype=torch.float32, device=gs[0].device),
        mesh, [Partial()] * mesh.ndim, run_check=False).full_tensor())


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics {"lr", "grad_norm"}). The
    gradient is clipped by its global norm; new parameters keep each
    leaf's dtype and device (they do not require grad). Each elementwise
    operation rounds to f32, in the JAX package's order (multi-tensor
    ``_foreach`` ops over groups of leaves).

    DTensor leaves (training over a grid): each f32 gradient is
    redistributed to its moment's own layout (ZeRO-1 follows from
    moments placed by ``sharding.rules.opt_shardings(..., zero1=True)``),
    the update computed on this rank's shards, and each new parameter
    redistributed to its parameter's layout; the returned moments keep
    the moments' layout."""
    named = leaves_with_path(params)
    ps = [p for _, p in named]
    gs, mus, nus = leaves(grads), leaves(state.mu), leaves(state.nu)
    on_grid = bool(ps) and isinstance(ps[0], DTensor)
    if on_grid:
        mesh = ps[0].device_mesh
        tgt = [m.placements for m in mus]
        gs = [g.float().redistribute(mesh, t) for g, t in zip(gs, tgt)]
        gnorm = _grid_norm(gs)
        p_out = [p.placements for p in ps]
        ps = [p.redistribute(mesh, t).to_local() for p, t in zip(ps, tgt)]
        gs, mus, nus = ([t.to_local() for t in ts] for ts in (gs, mus, nus))
    else:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    # f32 values, exact as Python floats: the device rounds them back
    b1c = float(1.0 - cfg.beta1 ** _f32(step))
    b2c = float(1.0 - cfg.beta2 ** _f32(step))
    lr_f = float(lr)
    new_p, new_mu, new_nu = ([None] * len(ps) for _ in range(3))
    for idx in _groups([p.numel() for p in ps]):
        gf = _mul([gs[i].float() for i in idx], clip)
        mu2 = _add(_mul([mus[i] for i in idx], cfg.beta1),
                   _mul(gf, 1 - cfg.beta1))
        nu2 = _add(_mul([nus[i] for i in idx], cfg.beta2),
                   _mul(_mul(gf, gf), 1 - cfg.beta2))
        del gf
        upd = list(_div(_div(mu2, b1c),
                        _add(_sqrt(_div(nu2, b2c)), cfg.eps)))
        dec = [k for k, i in enumerate(idx) if decay_mask(named[i][0])]
        if dec:
            wd = _mul([ps[idx[k]].float() for k in dec], cfg.weight_decay)
            for k, u in zip(dec, _add([upd[k] for k in dec], wd)):
                upd[k] = u
            del wd
        out = _sub([ps[i].float() for i in idx], _mul(upd, lr_f))
        for k, i in enumerate(idx):
            new_p[i] = out[k].to(ps[i].dtype)
            new_mu[i], new_nu[i] = mu2[k], nu2[k]
    if on_grid:
        def glob(t, pl):
            return DTensor.from_local(t, mesh, pl, run_check=False)
        new_p = [glob(p, t).redistribute(mesh, o)
                 for p, t, o in zip(new_p, tgt, p_out)]
        new_mu = [glob(m, t) for m, t in zip(new_mu, tgt)]
        new_nu = [glob(m, t) for m, t in zip(new_nu, tgt)]
    return (rebuild(params, new_p),
            AdamWState(step=step, mu=rebuild(state.mu, new_mu),
                       nu=rebuild(state.nu, new_nu)),
            {"lr": lr, "grad_norm": gnorm})


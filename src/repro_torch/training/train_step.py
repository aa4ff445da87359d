"""Training step: next-token cross-entropy and AdamW, as the JAX package's
``training/train_step.py``.

The forward is ``transformer.forward_train`` (plain autograd attention,
never a kernel). :func:`value_and_grad` is the counterpart of
``jax.value_and_grad(loss_fn)``: one backward pass by
``torch.autograd.grad`` over every parameter leaf, which leaves the
parameters' ``.grad`` untouched. :func:`train_step` then updates under
``torch.no_grad()`` and returns parameters that require grad again.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward_train
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update)
from repro_torch.training.tree import leaves, rebuild


def cross_entropy(logits, targets, mask) -> torch.Tensor:
    """logits: (B, S, [K,] V); targets: (B, S) or (B, K, S); mask: (B, S)
    -> () f32 mean negative log-likelihood over the masked positions."""
    if logits.dim() == 4:                       # codebooks: (B, S, K, V)
        targets = targets.movedim(1, 2)         # (B, S, K)
        mask = mask[..., None]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    denom = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / denom


def loss_fn(params, cfg: ModelConfig, batch, *, aux_weight: float = 0.01,
            ac=None, cond=None, remat: bool = True):
    """(loss, {"ce", "aux"}) of one batch {"tokens", "targets", "mask"}."""
    logits, aux = forward_train(params, cfg, batch["tokens"], cond=cond,
                                ac=ac, remat=remat)
    ce = cross_entropy(logits, batch["targets"], batch["mask"])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def value_and_grad(params, cfg: ModelConfig, batch, **kw):
    """((loss, parts), grads): the loss and its parts (detached) and the
    gradient of the loss for every leaf of ``params``, in its structure.
    Every leaf must require grad. ``kw``: :func:`loss_fn`'s keywords."""
    with torch.enable_grad():
        loss, parts = loss_fn(params, cfg, batch, **kw)
        grads = torch.autograd.grad(loss, leaves(params))
    return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
            rebuild(params, list(grads)))


def train_step(params, opt_state: AdamWState, batch, *, cfg: ModelConfig,
               opt_cfg: AdamWConfig, aux_weight: float = 0.01, ac=None,
               cond=None):
    """One optimizer step -> (params, opt_state, metrics {"loss", "ce",
    "aux", "lr", "grad_norm"}, () f32 tensors). ``params``' leaves require
    grad, and so do the returned ones."""
    (loss, parts), grads = value_and_grad(params, cfg, batch,
                                          aux_weight=aux_weight, ac=ac,
                                          cond=cond)
    params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
    for p in leaves(params):
        p.requires_grad_(True)
    return params, opt_state, {"loss": loss, **parts, **om}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    aux_weight: float = 0.01, ac=None):
    """A (params, opt_state, batch) -> (params, opt_state, metrics)
    closure."""
    return partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                   aux_weight=aux_weight, ac=ac)


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch of ``training.data`` -> tensors on ``device`` (the
    keys a step reads: tokens, targets, mask)."""
    return {k: torch.from_numpy(batch[k]).to(device)
            for k in ("tokens", "targets", "mask")}

"""Tensor-parallel serving specs, as the manual TP part of the JAX
package's ``repro.sharding.rules`` (its GSPMD training rules, ZeRO-1
``opt_shardings`` and ``activation_constraint`` are not ported).

A spec is the dimension of a leaf that splits over the ``tp`` ranks, or
None for a leaf every rank holds whole. Every leaf is one or the other:

* split over the heads (the KV heads carry their query groups): ``wq``,
  ``wk``, ``wv`` by column and their biases, ``wo`` by row (its output is
  then sum-reduced); the MLP's ``w_gate`` / ``w_up`` by column and
  ``w_down`` by row over ``d_ff``, the MoE experts' too; the page pools'
  K/V payload and int8 scales over the KV-head dimension;
* whole on every rank: the embeddings and lm_head (each rank computes the
  full logits, so sampling needs no gather and the same generator samples
  the same token everywhere), the norms, q/k-norms, the router, and every
  piece of pool metadata (``pos``, ``score``, ``block_table``,
  ``ref_count``, ``cur_page``, ``cur_off``, ``stats``), so each rank runs
  the same allocator and eviction trajectory.

The port holds a plain list of layers (``params["layers"]``,
``ModelCache.layers``), so a dimension here is the JAX package's minus the
leading repetition dimension of its stacked pattern slots.
"""
from __future__ import annotations

import dataclasses

import torch

# a PagedLayerCache's payload fields and their ranks: K/V (N + 1, page, KV,
# hd), int8 scales (N + 1, page, KV); each splits on dimension 2, KV
_POOL_NDIM = {"k_buf": 4, "v_buf": 4, "k_scale_buf": 3, "v_scale_buf": 3}


def tp_param_dim(path: str, shape: tuple) -> int | None:
    """The split dimension of the parameter at ``path`` ("layers/3/attn/wq")
    of ``shape``, or None when every rank holds it whole."""
    name = path.rsplit("/", 1)[-1]
    if name in ("wq", "wk", "wv"):
        return 1                       # column-parallel: whole heads
    if name in ("bq", "bk", "bv"):
        return 0                       # follow wq / wk / wv
    if name == "wo":
        return 0                       # row-parallel -> sum-reduced
    if name in ("w_gate", "w_up"):
        return 2 if len(shape) == 3 else 1     # MoE (E, D, F) / dense (D, F)
    if name == "w_down":
        return 1 if len(shape) == 3 else 0     # MoE (E, F, D) / dense (F, D)
    return None


def _tree(tree, fn, path=""):
    """``fn(leaf, path)`` over a tree of dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(tree, path)


def tp_param_specs(params: dict) -> dict:
    """The split dimension (or None) of every parameter, as a tree shaped
    like ``params``."""
    return _tree(params, lambda t, p: tp_param_dim(p, tuple(t.shape)))


def _cache_leaves(cache):
    """(path, leaf) of every tensor of a ``ModelCache``: the layer caches'
    fields, the cross-attention K/V and ``cur_pos``."""
    for kind in ("layers", "cross"):
        for i, c in enumerate(getattr(cache, kind)):
            for f in dataclasses.fields(c) if c is not None else ():
                if getattr(c, f.name) is not None:
                    yield f"{kind}/{i}/{f.name}", getattr(c, f.name)
    yield "cur_pos", cache.cur_pos


def tp_cache_dim(path: str, shape: tuple) -> int | None:
    """The split dimension of the cache leaf at ``path`` ("layers/0/k_buf"),
    or None: only the page pools' payload splits; the conditioning K/V of
    a cross-attention layer (``cross/...``) and all metadata stay whole."""
    kind, name = path.split("/", 1)[0], path.rsplit("/", 1)[-1]
    if kind == "layers" and _POOL_NDIM.get(name) == len(shape):
        return 2
    return None


def tp_cache_specs(cache) -> dict:
    """{path: split dimension or None} of every tensor of a ``ModelCache``
    (paths as :func:`tp_cache_dim` takes them)."""
    return {path: tp_cache_dim(path, tuple(leaf.shape))
            for path, leaf in _cache_leaves(cache)}


def _slice(t: torch.Tensor, dim: int | None, rank: int, tp: int,
           device=None):
    """Rank ``rank``'s contiguous copy of ``t`` split ``tp`` ways along
    ``dim``, on ``device`` (default ``t``'s); ``t`` itself (moved to
    ``device``) when ``dim`` is None."""
    device = t.device if device is None else device
    if dim is None:
        return t.to(device)
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split {tp} ways")
    return t.narrow(dim, rank * (n // tp), n // tp).to(
        device, memory_format=torch.contiguous_format, copy=True)


def shard_params(params: dict, rank: int, tp: int, device=None) -> dict:
    """Rank ``rank``'s parameters of ``tp`` on ``device`` (default: where
    each leaf lies): a contiguous copy of its slice of each split leaf, the
    whole leaf of the others (the same tensor when it lies on ``device``),
    so the full weights can stay on the host, or be dropped after the
    call."""
    return _tree(params, lambda t, p: _slice(
        t, tp_param_dim(p, tuple(t.shape)), rank, tp, device))


def shard_cache(cache, rank: int, tp: int):
    """Rank ``rank``'s copy of a ``ModelCache``: its slice of the pools'
    K/V heads (and int8 scales), a copy of every other tensor (each rank
    mutates its own metadata in place)."""
    def own(t, path):
        dim = tp_cache_dim(path, tuple(t.shape))
        return t.clone() if dim is None else _slice(t, dim, rank, tp)

    def copy(c, kind):
        return None if c is None else dataclasses.replace(c, **{
            f.name: own(getattr(c, f.name), f"{kind}/0/{f.name}")
            for f in dataclasses.fields(c)
            if getattr(c, f.name) is not None})
    return dataclasses.replace(
        cache, layers=[copy(c, "layers") for c in cache.layers],
        cross=[copy(c, "cross") for c in cache.cross],
        cur_pos=cache.cur_pos.clone())


def validate_tp(cfg, tp: int) -> None:
    """Raise unless ``cfg`` can shard whole heads and d_ff columns at
    degree ``tp`` (the JAX package's checks and messages). Reduced configs
    widen with ``cfg.reduced(tp=tp)``."""
    if tp <= 1:
        return
    problems = []
    if cfg.num_heads % tp:
        problems.append(f"num_heads={cfg.num_heads}")
    if cfg.num_kv_heads % tp:
        problems.append(f"num_kv_heads={cfg.num_kv_heads}")
    if cfg.d_ff and cfg.d_ff % tp:
        problems.append(f"d_ff={cfg.d_ff}")
    if problems:
        raise ValueError(
            f"{cfg.name}: {', '.join(problems)} not divisible by tp={tp}; "
            f"TP shards whole KV heads and d_ff columns (use "
            f"cfg.reduced(tp={tp}) for smoke configs)")
    for spec in cfg.layer_specs():
        if spec.mixer != "attn":
            raise ValueError(
                f"{cfg.name}: TP serving only supports attention mixers "
                f"(got {spec.mixer!r}; recurrent state has no KV-head axis)")
    if cfg.cross_attention:
        raise ValueError(f"{cfg.name}: TP serving does not support "
                         "cross-attention caches yet")

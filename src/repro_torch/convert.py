"""Carry weights and cache state between the JAX package and the port.

Everything crosses as numpy: the tests run ``jax.device_get`` on the JAX
side and hand the numpy trees over, so this module needs neither JAX nor
the JAX package. JAX objects are read by their field names (duck typing).

Parameter layouts agree leaf by leaf (weights (in, out), applied as
``x @ W``); only the stacking differs: JAX stacks each pattern slot over its
repetitions, the port holds a plain list of layers in depth order (layer
``r * period + p`` is repetition r of slot p, then the tail layers). Caches
cross with their int8 values and scales when quantized; a JAX cache from
``forward_prefill`` or ``init_decode_caches`` converts alike, a recurrent
layer's state (``LayerCaches(mamba=|mlstm=|slstm=)``) as the port's
``MambaState``, ``MLSTMState`` or ``SLSTMState``, and a cross-attention
layer's conditioning K/V (``LayerCaches.xattn``, beside its ``kv``) as a
``StaticKVCache`` in ``ModelCache.cross``. musicgen's (K, V, D) embed and
lm_head live outside ``pattern`` and cross as they are.

AdamW state crosses alike (``adamw_state_from_jax``: the moments
unstacked as the weights are), and so does a checkpoint directory that the
JAX package's ``save_checkpoint({"params", "opt"})`` wrote
(``checkpoint_from_jax``, numpy only: bf16 leaves are read as their 2-byte
payload).

Tensor-parallel serving: ``shard_cache_from_jax`` gives rank r's slice of
a JAX ``ModelCache`` (``sharding.rules``: the pools' KV heads split, the
metadata whole), for holding a rank's state to the JAX package's.

Functions that make tensors put them on ``device``: default CUDA, raising
without a card (tests pass ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_cache import PagedLayerCache
from repro_torch.device import resolve_device
from repro_torch.models.attention import StaticKVCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.transformer import ModelCache, init_layer
from repro_torch.models.xlstm import MLSTMState, SLSTMState
from repro_torch.sharding.rules import shard_cache
from repro_torch.training.checkpoint import tensor_from_numpy
from repro_torch.training.optimizer import AdamWState

CACHE_FIELDS = ("k", "v", "pos", "score", "block_table", "ref_count",
                "cur_page", "cur_off", "stats", "k_scale", "v_scale")
# a recurrent state's type by its fields (the JAX package's NamedTuples
# carry the same names)
STATE_TYPES = {tuple(f.name for f in dataclasses.fields(t)): t
               for t in (MambaState, MLSTMState, SLSTMState)}
# the JAX package's LayerCaches field of each mixer's decode state
LAYER_CACHE_FIELDS = ("kv", "mamba", "mlstm", "slstm")


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = tensor_from_numpy(a)
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _map(tree, fn, key=None):
    """``fn(leaf, key)`` over a tree of dicts and lists, ``key`` the name
    of the dict entry that holds the leaf."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, key) for v in tree]
    return fn(tree, key)


@functools.cache
def f32_leaf_names(cfg: ModelConfig) -> frozenset:
    """Names of the parameters a bf16 model holds in f32: the MoE router,
    mamba's ``A_log``, ``D`` and ``dt_bias``, the xLSTM gates' weights and
    biases and the sLSTM's ``r_*`` (those of ``cfg``'s layer kinds), read
    off the port's own initialisers (held to the JAX package's dtypes by
    tests/test_torch_families.py) on a narrow bf16 copy of ``cfg``, on the
    CPU."""
    tiny = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    names = set()
    for spec in {(s.mixer, s.mlp): s for s in cfg.layer_specs()}.values():
        _map(init_layer(gen, tiny, spec, "cpu"), lambda t, key: names.add(
            key) if t.dtype == torch.float32 else None)
    return frozenset(names)


def params_from_jax(tree: dict, cfg: ModelConfig, device=None,
                    dtype=None) -> dict:
    """JAX ``init_model`` tree (numpy leaves) -> the port's parameters (MoE
    expert stacks (R, E, D, F) unstack as every leaf does). ``dtype`` casts
    every leaf but those the JAX package holds in f32 in a bf16 model
    (:func:`f32_leaf_names`), which stay f32."""
    device = resolve_device(device)
    layers = [_map(tree["pattern"][p], lambda a, _, r=r: np.asarray(a)[r])
              for r in range(cfg.full_pattern_reps)
              for p in range(cfg.pattern_period)] + list(tree["tail"])
    out = {k: v for k, v in tree.items() if k not in ("pattern", "tail")}
    out["layers"] = layers
    keep = f32_leaf_names(cfg) if dtype is not None else frozenset()
    return _map(out, lambda a, key: _tensor(
        a, device, None if key in keep else dtype))


def adamw_state_from_jax(state, cfg: ModelConfig,
                         device=None) -> AdamWState:
    """A JAX ``AdamWState`` (numpy leaves; read by its fields) -> the
    port's: mu / nu unstacked into the port's list of layers, step an
    int."""
    return AdamWState(step=int(np.asarray(state.step)),
                      mu=params_from_jax(state.mu, cfg, device),
                      nu=params_from_jax(state.nu, cfg, device))


def _unflatten_keys(flat: dict) -> dict:
    """{"a/0/b": leaf} -> nested dicts, a node whose keys are all digits
    made a list (the JAX package's key paths)."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        *parts, last = key.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    return listify(root)


def checkpoint_from_jax(ckpt_dir: str, step: int, cfg: ModelConfig,
                        name: str = "state", device=None) -> dict:
    """A checkpoint the JAX package's ``save_checkpoint(ckpt_dir, step,
    {"params": params, "opt": opt_state}, name)`` wrote -> {"params": the
    port's parameters, "opt": the port's ``AdamWState``}. Reads the npz
    with numpy alone: keys ``params/pattern/<slot>/...`` (each leaf stacked
    over the slot's repetitions), ``params/tail/<i>/...`` and the state's
    fields ``opt/.step``, ``opt/.mu/...``, ``opt/.nu/...``; an empty list
    (no tail layers) writes no key."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", f"{name}.npz")
    with np.load(path) as data:
        tree = _unflatten_keys({k: data[k] for k in data.files})
    for sub in (tree["params"], tree["opt"][".mu"], tree["opt"][".nu"]):
        sub.setdefault("pattern", [])
        sub.setdefault("tail", [])
    opt = tree["opt"]
    return {"params": params_from_jax(tree["params"], cfg, device),
            "opt": AdamWState(step=int(opt[".step"]),
                              mu=params_from_jax(opt[".mu"], cfg, device),
                              nu=params_from_jax(opt[".nu"], cfg, device))}


def layer_cache_from_jax(c, device=None) -> PagedLayerCache:
    """One JAX ``PagedLayerCache`` (numpy fields) -> the port's, adding the
    trash row (to the int8 scales too)."""
    device = resolve_device(device)
    k, v = np.asarray(c.k), np.asarray(c.v)
    pos, score = np.asarray(c.pos), np.asarray(c.score)
    trash = lambda a, fill: np.concatenate(
        [a, np.full((1,) + a.shape[1:], fill, a.dtype)])
    scale = lambda a: None if a is None else \
        _tensor(trash(np.asarray(a), 0), device)
    return PagedLayerCache(
        k_buf=_tensor(trash(k, 0), device),
        v_buf=_tensor(trash(v, 0), device),
        pos_buf=_tensor(trash(pos, -1), device),
        score_buf=_tensor(trash(score, -np.inf), device),
        block_table=_tensor(c.block_table, device),
        ref_count=_tensor(c.ref_count, device),
        cur_page=_tensor(c.cur_page, device),
        cur_off=_tensor(c.cur_off, device),
        stats=None if c.stats is None else _tensor(c.stats, device),
        k_scale_buf=scale(c.k_scale),
        v_scale_buf=scale(c.v_scale))


def _state_fields(c) -> tuple:
    """Field names of a recurrent state, the port's or the JAX package's."""
    if dataclasses.is_dataclass(c):
        return tuple(f.name for f in dataclasses.fields(c))
    return tuple(c._fields)


def state_from_jax(st, device=None):
    """A JAX recurrent state (``MambaState``, ``MLSTMState`` or
    ``SLSTMState``, numpy fields) -> the port's, by its field names."""
    device = resolve_device(device)
    names = _state_fields(st)
    return STATE_TYPES[names](**{f: _tensor(getattr(st, f), device)
                                 for f in names})


def layer_cache_to_numpy(c) -> dict:
    """A layer cache -> {field: ndarray}: over CACHE_FIELDS for a page pool
    (stats and the scales None when off), over its own fields for a
    recurrent state or a ``StaticKVCache``. Accepts the port's cache or a
    JAX one with numpy-able fields."""
    out = {}
    names = CACHE_FIELDS if hasattr(c, "block_table") else _state_fields(c)
    for f in names:
        a = getattr(c, f)
        if a is None:
            out[f] = None
        elif isinstance(a, torch.Tensor):
            out[f] = a.detach().float().cpu().numpy() \
                if a.dtype == torch.bfloat16 else a.detach().cpu().numpy()
        else:
            out[f] = np.asarray(a)
    return out


def _layer_state(lc):
    """The populated field of a JAX ``LayerCaches``: the page pool of an
    attention layer, the state of a recurrent one."""
    return next(getattr(lc, f) for f in LAYER_CACHE_FIELDS
                if getattr(lc, f) is not None)


def _depth_order(mc, period: int, pick) -> list:
    """``pick(lc)`` (a NamedTuple of numpy leaves, or None) of every JAX
    ``LayerCaches`` of a JAX ``ModelCache`` in depth order, pattern slots
    unstacked."""
    reps = np.asarray(_layer_state(mc.pattern[0])[0]).shape[0] \
        if mc.pattern else 0
    unstack = lambda c, r: None if c is None else type(c)(  # noqa: E731
        *[None if a is None else np.asarray(a)[r] for a in c])
    return [unstack(pick(mc.pattern[p]), r) for r in range(reps)
            for p in range(period)] + [pick(lc) for lc in mc.tail]


def jax_cache_layers(mc, period: int) -> list:
    """A JAX ``ModelCache`` (numpy leaves) -> per-layer JAX layer caches
    (``PagedLayerCache``, or a recurrent layer's state) in depth order
    (pattern slots unstacked)."""
    return _depth_order(mc, period, _layer_state)


def jax_cache_cross(mc, period: int) -> list:
    """A JAX ``ModelCache`` -> per layer in depth order, its
    cross-attention ``StaticKVCache`` (``LayerCaches.xattn``) or None."""
    return _depth_order(mc, period, lambda lc: lc.xattn)


def cache_from_jax(mc, cfg: ModelConfig, device=None) -> ModelCache:
    """A JAX ``ModelCache`` (numpy leaves) -> the port's ``ModelCache``,
    the cross-attention layers' conditioning K/V in ``cross``."""
    device = resolve_device(device)
    layers = [layer_cache_from_jax(c, device) if hasattr(c, "block_table")
              else state_from_jax(c, device)
              for c in jax_cache_layers(mc, cfg.pattern_period)]
    cross = [None if x is None else
             StaticKVCache(k=_tensor(x.k, device), v=_tensor(x.v, device))
             for x in jax_cache_cross(mc, cfg.pattern_period)]
    return ModelCache(layers=layers, cur_pos=_tensor(mc.cur_pos, device),
                      cross=cross)


def shard_cache_from_jax(mc, cfg: ModelConfig, rank: int, tp: int,
                         device=None) -> ModelCache:
    """Rank ``rank``'s slice (of ``tp``) of a JAX ``ModelCache`` (numpy
    leaves): its KV heads of every pool, the metadata whole."""
    return shard_cache(cache_from_jax(mc, cfg, device), rank, tp)


def cache_to_numpy(cache: ModelCache) -> dict:
    """The port's ``ModelCache`` -> {"layers": [field dicts], "cross":
    [{"k", "v"} of a cross-attention layer, else None], "cur_pos"}."""
    return {"layers": [layer_cache_to_numpy(c) for c in cache.layers],
            "cross": [None if c is None else layer_cache_to_numpy(c)
                      for c in cache.cross],
            "cur_pos": cache.cur_pos.cpu().numpy()}

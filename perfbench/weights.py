"""The weights of a run, made from the seed on the device in a few large
calls: one flat buffer per dtype filled by ``normal_`` in chunks of 2**30
elements with a ``torch.Generator`` on the device, cut into the leaves of
the port's parameter tree (its structure read from ``init_model`` on the
meta device), each leaf scaled in place. Both the program and the
reference read these very tensors.

Scales by leaf: RMSNorm scales 1; the embedding and the head N(0, 0.02^2);
every other matrix N(0, 1 / fan_in), fan_in its second-to-last axis (the
router, in f32, alike).
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30          # elements per draw: 32-bit indexing inside each


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _rebuild(tree):
    if isinstance(tree, dict):
        return {k: _rebuild(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v) for v in tree]
    return None


def scale_of(path: tuple, shape: tuple) -> float | None:
    """The leaf's standard deviation; None for a norm scale (ones)."""
    if path[-1] in ("scale",):
        return None
    if path[-1] in ("bias",):
        return 0.0
    if path[0] in ("embed", "lm_head"):
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def make_params(cfg, seed: int, device) -> dict:
    """The parameter tree of ``cfg`` on ``device``, drawn from ``seed``."""
    from repro_torch.models.transformer import init_model
    meta = init_model(cfg, seed=0, device="meta")
    leaves = list(_leaves(meta))
    out = _rebuild(meta)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    by_dtype: dict = {}
    for path, t in leaves:
        by_dtype.setdefault(t.dtype, []).append((path, t))
    for dtype, group in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        flat = torch.empty(sum(t.numel() for _, t in group), dtype=dtype,
                           device=device)
        for a in range(0, flat.numel(), CHUNK):
            flat[a:a + CHUNK].normal_(generator=gen)
        at = 0
        for path, t in group:
            leaf = flat[at:at + t.numel()].view(t.shape)
            at += t.numel()
            s = scale_of(path, tuple(t.shape))
            if s is None:
                leaf.fill_(1.0)
            else:
                leaf.mul_(s)
            _set(out, path, leaf)
    return out


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(params))

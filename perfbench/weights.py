"""The weights of a run, made from the seed on the device in a few large
calls: one flat buffer per dtype filled by ``normal_`` in chunks of 2**30
elements with a ``torch.Generator`` on the device, cut into the leaves of
the port's parameter tree (its structure read from ``init_model`` on the
meta device), each leaf scaled in place. Both the program and the
reference read these very tensors.

Rules by leaf: norm scales 1; biases 0; the embedding and the head N(0,
0.02^2); every other leaf of two or more axes N(0, 1 / fan_in), fan_in its
second-to-last axis (the router, in f32, alike). A Mamba mixer's leaves as
``models/mamba.py:init_mamba`` makes them, each from its own draws:
``conv_b`` 0, ``D`` 1, ``A_log`` the S4D-real log(1..d_state) of every
channel, ``dt_bias`` the inverse softplus of a dt log-uniform in [1e-3,
1e-1] (u the normal CDF of the leaf's draws); ``conv_w``, ``x_proj``,
``dt_proj`` by the rule of matrices. Any other leaf of one axis raises.
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


ONES = ("scale", "q_norm", "k_norm", "out_norm", "D")
ZEROS = ("bias", "bq", "bk", "bv", "conv_b", "b_gates", "b_igate", "b_fgate")
DT_RANGE = (1e-3, 1e-1)


def _dt_bias(z: torch.Tensor) -> torch.Tensor:
    """Standard normal draws -> softplus^-1 of dt, log-uniform in
    ``DT_RANGE``."""
    u = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    lo, hi = (math.log(d) for d in DT_RANGE)
    return torch.log(torch.expm1(torch.exp(lo + u * (hi - lo))))


def init_leaf(path: tuple, leaf: torch.Tensor) -> None:
    """The leaf's values, in place, from its standard normal draws."""
    name = path[-1]
    if name in ONES:
        leaf.fill_(1.0)
    elif name in ZEROS:
        leaf.zero_()
    elif name == "A_log":
        ds = leaf.shape[-1]
        leaf.copy_(torch.log(torch.arange(1, ds + 1, dtype=leaf.dtype,
                                          device=leaf.device)))
    elif name == "dt_bias":
        leaf.copy_(_dt_bias(leaf))
    elif path[0] in ("embed", "lm_head"):
        leaf.mul_(0.02)
    elif leaf.dim() >= 2:
        leaf.mul_(1.0 / math.sqrt(leaf.shape[-2]))
    else:
        where = ".".join(map(str, path))
        raise ValueError(f"no rule for the weights of {where} "
                         f"{tuple(leaf.shape)}")


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
            init_leaf(path, leaf)
            _set(out, path, leaf)
    return out


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(params))

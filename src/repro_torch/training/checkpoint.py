"""Checkpoints: flat-key .npz snapshots of the port's trees, with the JAX
package's contract (``training/checkpoint.py``): an atomic write (a
temporary file renamed into place), ``<ckpt_dir>/step_XXXXXXXX/<name>.npz``
beside ``<name>.keys.json`` (the sorted keys), the latest step found by
directory name, and an exact restore into a template tree.

Keys are the leaves' paths joined by '/', as the JAX package writes them:
dict keys, list indices, ``.field`` for a NamedTuple's fields
(``opt/.mu/layers/0/attn/wq``). Tensors are written as numpy arrays; a
Python int (``AdamWState.step``) as a () int32 array.

bf16 leaves are written as their raw 2-byte payload, numpy's ``V2`` dtype:
the bytes and the dtype the JAX package writes for an ``ml_dtypes``
bfloat16 array. ``np.load`` reads them back without ``ml_dtypes``, which
the port does not import; :func:`tensor_from_numpy` views them as
``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch.training.tree import key_of, leaves_with_path, rebuild

BF16_PAYLOAD = np.dtype("V2")


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy array on the host; bf16 as its ``V2`` payload."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_PAYLOAD)
    return t.numpy()


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array -> a CPU tensor; a 2-byte ``V2`` payload (or an
    ``ml_dtypes`` bfloat16 array) bit for bit as ``torch.bfloat16``."""
    a = np.asarray(a)
    if a.dtype == BF16_PAYLOAD or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaf_to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return tensor_to_numpy(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    raise TypeError(f"no checkpoint form for a leaf of type "
                    f"{type(leaf).__name__}")


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key_of(path): _leaf_to_numpy(leaf)
            for path, leaf in leaves_with_path(tree)}


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    name: str = "state") -> str:
    """Atomic save of ``tree`` under <ckpt_dir>/step_<step>/<name>.npz;
    returns that path."""
    step_dir = _step_dir(ckpt_dir, step)
    os.makedirs(step_dir, exist_ok=True)
    flat = _flatten(tree)
    final = os.path.join(step_dir, f"{name}.npz")
    fd, tmp = tempfile.mkstemp(dir=step_dir, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, final)
        fd, tmp = tempfile.mkstemp(dir=step_dir, suffix=".tmp.json")
        with os.fdopen(fd, "w") as f:
            json.dump(sorted(flat), f)
        os.replace(tmp, os.path.join(step_dir, f"{name}.keys.json"))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return final


def _restore(arr: np.ndarray, like, key: str):
    if isinstance(like, torch.Tensor):
        if arr.shape != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                             f"template {tuple(like.shape)}")
        t = tensor_from_numpy(arr).to(device=like.device, dtype=like.dtype)
        return t.requires_grad_(like.requires_grad)
    if isinstance(like, int):
        return int(arr)
    raise TypeError(f"{key}: no restore for a template leaf of type "
                    f"{type(like).__name__}")


def load_checkpoint(ckpt_dir: str, step: int, like, name: str = "state"):
    """Restore into the structure of ``like``: each tensor leaf takes its
    template's shape (checked), dtype, device and ``requires_grad``; each
    int leaf is an int."""
    path = os.path.join(_step_dir(ckpt_dir, step), f"{name}.npz")
    with np.load(path) as data:
        return rebuild(like, [_restore(data[key_of(p)], leaf, key_of(p))
                              for p, leaf in leaves_with_path(like)])


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None

"""Counters and the roofline of the dry run: one eager step of the port
on the ``meta`` device over a fake process group of the grid's size,
counted as it runs (the counterpart of the JAX package's
``repro.launch.analysis``, which reads a compiled artifact).

No kernel runs on ``meta``: attention and the pools' walks are counted as
their plain torch versions, as the JAX dry run counts its plain jnp path.
The fake group's collectives move nothing and reduce nothing: they are
recorded, not performed.

Two dispatch modes count one step (:class:`StepCounter`):

- **FLOPs** (``torch.utils.flop_counter``'s registry: mm, addmm, bmm,
  baddbmm, convolutions, SDPA), **global**: an operation on DTensors is
  counted once at its global shapes; an operation on plain tensors (a
  region computed on local shards, or DTensor's own reshuffles) is
  counted once per rank that runs it, the grid's size (every rank runs
  every region), as the JAX package multiplies a ``shard_map`` body by its
  manual axes (analysis.py:84-92).
- **Bytes**, global the same way: operand + result bytes per aten
  operation, with the JAX package's two rules (analysis.py:120-130): an
  in-place update (``index_put_``, the scatters, ``index_copy_``,
  ``index_add_``) costs 2 x (indices + updates), a gather (``index``,
  ``gather``, ``index_select``, ``embedding``) 2 x output + indices.
  Views and collectives cost nothing. An unfused bound, as the JAX one.
- **Per device** (the inner mode, which also sees the local operations
  DTensor runs for its DTensor operations): this rank's own FLOPs and
  bytes, every collective it issues (the functional collectives, by op,
  group size and result bytes; DTensor's Shard -> Shard exchange counted
  as the all-to-all DTensor asked for, not its all-gather fall-back on a
  "cpu" mesh), and the live bytes of the storages the step creates, whose
  peak is the step's temporary memory.

:class:`Roofline` keeps the JAX package's fields and JSON layout.
``flops_per_device`` / ``bytes_per_device`` are the global counts over the
ranks; ``xla_flops_per_device`` / ``xla_bytes_per_device`` carry rank 0's
own counts: there is no compiler in between. ``compile_seconds`` is the
step's wall seconds under the counters. The terms use the H100 datasheet
figures of ``launch.mesh`` (not measured), each collective's bytes over
NVLink or InfiniBand by its group's place on the nodes.
"""
from __future__ import annotations

import json
import weakref
from collections import Counter
from dataclasses import asdict, dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import (GPUS_PER_NODE, HBM_BW, IB_BW,
                                     NVLINK_BW, PEAK_FLOPS_BF16)

_UPDATES = {"index_put_", "index_put", "scatter_", "scatter",
            "scatter_add_", "scatter_add", "scatter_reduce_",
            "scatter_reduce", "index_copy_", "index_copy", "index_add_",
            "index_add", "masked_scatter_", "masked_scatter"}
_GATHERS = {"index", "gather", "index_select", "embedding"}
# functional collective -> the JAX package's collective name
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all",
                "broadcast": "broadcast"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten operation moves (module docstring)."""
    if getattr(func, "is_view", False):
        return 0
    name = func._overloadpacket.__name__
    ins = _tensors((args, kwargs))
    if name in _UPDATES:
        return 2 * sum(_nbytes(t) for t in ins[1:])
    if name in _GATHERS:
        return 2 * sum(_nbytes(t) for t in _tensors(out)) + \
            sum(_nbytes(t) for t in ins[1:])
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                              for t in _tensors(out))


def op_flops(func, args, kwargs, out) -> int:
    fn = flop_registry.get(func._overloadpacket)
    return int(fn(*args, **kwargs, out_val=out)) if fn is not None else 0


def _collective(func) -> str | None:
    ns = func._overloadpacket._qualified_op_name.split("::")[0]
    if ns not in ("_c10d_functional", "_c10d_functional_autograd",
                  "_dtensor"):
        return None
    return _COLLECTIVES.get(func._overloadpacket.__name__, "other")


def _group_ranks(func, args) -> list[int]:
    """The global ranks of the group a functional collective runs over."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    if func._overloadpacket.__name__ == "shard_dim_alltoall":
        name = args[-1]
    else:
        name = next(a for a in reversed(args) if isinstance(a, str))
    return dist.get_process_group_ranks(_resolve_process_group(name))


def ring_traffic(op: str, result_bytes: float, n: int) -> float:
    """Bytes one device moves for a collective of ``n`` participants whose
    result is ``result_bytes``: the JAX package's ring factors
    (``parse_collectives``, analysis.py:195-221; a broadcast moves its
    result, as a permute there)."""
    frac = (n - 1) / n if n > 1 else 0.0
    if op == "all-gather":
        return result_bytes * frac
    if op == "all-reduce":
        return 2 * result_bytes * frac
    if op == "reduce-scatter":
        return result_bytes * n * frac
    if op == "all-to-all":
        return result_bytes * frac
    return float(result_bytes)


def intra_node(ranks) -> bool:
    """Whether a group's ranks lie on one NVLink node."""
    return len({r // GPUS_PER_NODE for r in ranks}) == 1


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)        # op -> count
    result_bytes: dict = field(default_factory=dict)  # op -> sum result bytes
    traffic_bytes: float = 0.0                        # ring-model bytes/device
    seconds: float = 0.0                              # over NVLink / IB


def collective_stats(records) -> CollectiveStats:
    """Per-op counts, result bytes and ring traffic of recorded collectives
    ``(op, group ranks, dtype, shape, result bytes)``; ``seconds`` moves
    each one's traffic over NVLink inside a node, InfiniBand across."""
    st = CollectiveStats()
    for op, ranks, _, _, rbytes in records:
        n = len(ranks)
        traffic = ring_traffic(op, rbytes, n)
        st.counts[op] = st.counts.get(op, 0) + 1
        st.result_bytes[op] = st.result_bytes.get(op, 0) + rbytes
        st.traffic_bytes += traffic
        st.seconds += traffic / (NVLINK_BW if intra_node(ranks) else IB_BW)
    return st


def collective_lines(records, top: int = 20) -> list:
    """The ``top`` collectives by result bytes: (bytes, op, group size,
    "dtype[shape]")."""
    rows = [(rb, op, len(ranks), f"{dt}{list(shape)}")
            for op, ranks, dt, shape, rb in records]
    rows.sort(key=lambda r: -r[0])
    return rows[:top]


def collective_set(records) -> dict:
    """Per-op counts and result bytes, and the sorted multiset of
    ``op group=N dtype[shape]`` signatures: the JAX package's
    ``collective_set`` layout."""
    counts, result_bytes, sigs = Counter(), Counter(), []
    for op, ranks, dt, shape, rb in records:
        counts[op] += 1
        result_bytes[op] += rb
        sigs.append(f"{op} group={len(ranks)} {dt}{list(shape)}")
    return {"counts": dict(sorted(counts.items())),
            "result_bytes": dict(sorted(result_bytes.items())),
            "signatures": sorted(sigs)}


class _Device(TorchDispatchMode):
    """The inner mode: every operation this rank runs on plain tensors."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = 0
        self.records = []
        self.live = self.peak = 0
        self.quiet = False
        self.off = 0
        self._seen: dict = {}

    def _free(self, key, n):
        self._seen.pop(key, None)
        self.live -= n

    def _track(self, out, args, kwargs):
        # a view or an in-place result shares an input's storage, which
        # is an argument of the step or already counted
        ins = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen or key in ins:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor run its local ops
        out = func(*args, **kwargs)
        if self.off:
            return out
        op = _collective(func)
        if op is not None:
            if op != "other" and not self.quiet:
                res = _tensors(out)[0]
                self.records.append((op, _group_ranks(func, args),
                                     str(res.dtype).replace("torch.", ""),
                                     tuple(res.shape), _nbytes(res)))
        else:
            self.flops += op_flops(func, args, kwargs, out)
            self.bytes += op_bytes(func, args, kwargs, out)
        self._track(out, args, kwargs)
        return out


class _Global(TorchDispatchMode):
    """The outer mode: DTensor operations once at their global shapes,
    plain ones once per rank."""

    def __init__(self, world: int):
        super().__init__()
        self.world = world
        self.flops = self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _collective(func) is None:
            w = 1 if any(issubclass(t, DTensor) for t in types) \
                else self.world
            self.flops += w * op_flops(func, args, kwargs, out)
            self.bytes += w * op_bytes(func, args, kwargs, out)
        return out


def local_bytes(tree) -> int:
    """This rank's bytes of every tensor of ``tree`` (a DTensor's local
    shard; dicts, lists, tuples and dataclasses walked)."""
    import dataclasses
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(local_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


class StepCounter:
    """``with StepCounter(world) as c: out = step(...)`` counts the step
    (module docstring): ``c.flops`` / ``c.bytes`` global, ``c.device_flops``
    / ``c.device_bytes`` / ``c.records`` / ``c.temp_bytes`` this rank's."""

    def __init__(self, world: int):
        self._dev, self._glob = _Device(), _Global(world)

    def _alltoall(self, input, gather_dim, shard_dim, mesh, mesh_dim):
        """DTensor's Shard -> Shard exchange, recorded as the all-to-all
        it asks for (on a "cpu" mesh DTensor runs it as an all-gather and
        a chunk, which is not recorded)."""
        self._dev.quiet = True
        try:
            out = self._orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            self._dev.quiet = False
        self._dev.records.append((
            "all-to-all", dist.get_process_group_ranks(
                mesh.get_group(mesh_dim)),
            str(out.dtype).replace("torch.", ""), tuple(out.shape),
            _nbytes(out)))
        return out

    def _shapes_only(self, prop, op_schema):
        """DTensor's shape inference, which runs each operation once more
        on stand-ins of its global shapes: not this rank's work, not
        counted."""
        self._dev.off += 1
        try:
            return self._orig_meta(prop, op_schema)
        finally:
            self._dev.off -= 1

    def __enter__(self):
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self._orig = placement_types.shard_dim_alltoall
        placement_types.shard_dim_alltoall = self._alltoall
        self._orig_meta = ShardingPropagator._propagate_tensor_meta_non_cached
        ShardingPropagator._propagate_tensor_meta_non_cached = \
            lambda prop, schema: self._shapes_only(prop, schema)
        self._dev.__enter__()
        self._glob.__enter__()
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self._glob.__exit__(*exc)
        self._dev.__exit__(*exc)
        placement_types.shard_dim_alltoall = self._orig
        ShardingPropagator._propagate_tensor_meta_non_cached = self._orig_meta

    flops = property(lambda self: self._glob.flops)
    bytes = property(lambda self: self._glob.bytes)
    device_flops = property(lambda self: self._dev.flops)
    device_bytes = property(lambda self: self._dev.bytes)
    records = property(lambda self: self._dev.records)
    temp_bytes = property(lambda self: self._dev.peak)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    policy: str
    kind: str
    chips: int
    flops_per_device: float        # global counted FLOPs / chips
    bytes_per_device: float        # global counted bytes / chips
    xla_flops_per_device: float    # rank 0's own counted FLOPs
    xla_bytes_per_device: float    # rank 0's own counted bytes
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_flops_ratio: float      # MODEL_FLOPS / (flops_per_device * chips)
    collective_counts: dict
    memory_analysis: dict
    compile_seconds: float
    notes: str = ""


def analyze(counter: StepCounter, *, arch: str, shape: str, mesh_name: str,
            policy: str, kind: str, chips: int, model_flops: float,
            seconds: float, argument_bytes: int, output_bytes: int,
            notes: str = "") -> Roofline:
    """The roofline of one counted step: compute = FLOPs per device over
    the bf16 peak, memory = bytes per device over HBM, collective = each
    collective's ring traffic over NVLink or InfiniBand."""
    flops = counter.flops / chips
    byts = counter.bytes / chips
    coll = collective_stats(counter.records)
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = byts / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll.seconds}
    total = flops * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, policy=policy, kind=kind,
        chips=chips, flops_per_device=flops, bytes_per_device=byts,
        xla_flops_per_device=float(counter.device_flops),
        xla_bytes_per_device=float(counter.device_bytes),
        collective_bytes=coll.traffic_bytes, compute_s=compute_s,
        memory_s=memory_s, collective_s=coll.seconds,
        dominant=max(terms, key=terms.get), model_flops=model_flops,
        useful_flops_ratio=(model_flops / total) if total else 0.0,
        collective_counts={k: [coll.counts[k], coll.result_bytes[k]]
                           for k in coll.counts},
        memory_analysis={"argument_size_in_bytes": int(argument_bytes),
                         "output_size_in_bytes": int(output_bytes),
                         "temp_size_in_bytes": int(counter.temp_bytes)},
        compile_seconds=seconds, notes=notes)


def save_roofline(path: str, r: Roofline) -> None:
    with open(path, "w") as f:
        json.dump(asdict(r), f, indent=1)


def model_flops_estimate(cfg, shape_cfg) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for training, 2 N D
    for a prefill; decode: D = one token per request."""
    n = cfg.active_param_count()
    if shape_cfg.kind == "train":
        return 6.0 * n * shape_cfg.seq_len * shape_cfg.global_batch
    if shape_cfg.kind == "prefill":
        return 2.0 * n * shape_cfg.seq_len * shape_cfg.global_batch
    return 2.0 * n * shape_cfg.global_batch

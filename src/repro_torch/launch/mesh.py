"""Process groups and grids of the torch port, as the JAX package's
``repro.launch.mesh``: one process per rank over ``torch.distributed``,
where the JAX package runs one program over a device mesh.

**Tensor-parallel serving.** :func:`make_tp_group` initialises the
default process group of world size ``tp`` (or checks the one already
initialised, as under ``torchrun``) and gives this rank its device. Its
:class:`TPGroup` is the only way the serving step issues a collective:
sum and mean all-reduces over the group, each counted by kind
(``TPGroup.counts``), so a step's collectives can be read off and held to
:func:`step_collectives`, the inventory the JAX package's
``inspect_collectives --serve-tp`` reads from the compiled step.

**Training over a grid.** :func:`make_grid` joins (or checks) a process
group of the grid's size and lays a named ``DeviceMesh`` over it, as
``jax.make_mesh``: its :class:`Grid` carries the ordered axis sizes
(``Grid.shape``, read by ``sharding.rules`` as the JAX rules read
``Mesh.shape``) and the mesh the DTensors live on.
:func:`make_debug_grid` and :func:`make_production_grid` are the
counterparts of ``make_debug_mesh`` and ``make_production_mesh`` (both
layouts); :func:`abstract_grid` is a grid of shapes only, for the rules.

The backend follows from the device: NCCL for one GPU per rank, gloo on
the CPU or when ranks share a GPU (fewer CUDA devices than ranks: NCCL
refuses two ranks on one device); gloo all-reduces CUDA tensors itself,
staging them through the host.

:func:`run_ranks` runs a function on every rank of a fresh group, one
spawned process each, joined through a ``FileStore`` in a temporary
directory (no port to clash over).
"""
from __future__ import annotations

import math
import os
import pickle
import tempfile
from collections import Counter
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclass
class TPGroup:
    """This rank's place in the tensor-parallel group: ``rank`` of ``size``
    on ``device``; ``counts`` the collectives issued, by kind."""
    rank: int
    size: int
    device: torch.device
    counts: Counter = field(default_factory=Counter)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in ``t``'s dtype; ``t`` must be a
        fresh tensor of the caller's: it is reduced in place and
        returned."""
        self.counts["all_reduce_sum"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks: the sum divided by the size,
        as ``jax.lax.pmean``; in place, as :meth:`all_reduce_sum`."""
        self.counts["all_reduce_mean"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t.div_(self.size)


def _join(world: int, what: str, *, rank, store, device,
          timeout: timedelta) -> tuple[int, torch.device]:
    """Initialise the default process group of world size ``world``, or
    check the one already initialised; set this rank's device. Returns
    (rank, device). ``what`` names the caller in the errors."""
    dev = resolve_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= world else "gloo")
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(
                f"{what} needs a process group of world size {world}; the "
                f"initialised one has world size {dist.get_world_size()}")
    elif store is not None:
        if rank is None:
            raise ValueError(f"{what}: joining a store needs this "
                             f"process's rank")
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
    else:
        missing = [v for v in _ENV if v not in os.environ]
        if missing:
            raise ValueError(
                f"{what} needs a process group of world size {world}: pass "
                f"rank= and store=, or run under torchrun (missing "
                f"{', '.join(missing)})")
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"{what} needs a process group of world size "
                             f"{world}; WORLD_SIZE is "
                             f"{os.environ['WORLD_SIZE']}")
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return rank, dev


def make_tp_group(tp: int, *, rank: int | None = None, store=None,
                  device=None,
                  timeout: timedelta = timedelta(minutes=5)) -> TPGroup:
    """Initialise the default process group of world size ``tp``, or check
    the one already initialised, and set this rank's device.

    Without an initialised group, ``store`` (a ``torch.distributed`` store,
    e.g. a ``FileStore`` every rank opens on one path) and ``rank`` join it;
    without a store the ``torchrun`` environment (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE) does. ``device``: "cpu", or default CUDA, where rank r
    takes ``cuda:{r % device_count}`` and makes it the current device.
    Raises, naming what is missing, when no group of world size ``tp`` can
    be had."""
    rank, dev = _join(tp, f"tp={tp}", rank=rank, store=store, device=device,
                      timeout=timeout)
    return TPGroup(rank=rank, size=tp, device=dev)


@dataclass
class Grid:
    """A named grid of ranks: ``shape`` {axis: size} in the grid's order
    (the JAX ``Mesh.shape``), ``mesh`` the ``DeviceMesh`` over the ranks
    (None for a grid of shapes only), ``device`` this rank's device."""
    shape: dict
    mesh: object = None
    device: torch.device | None = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def abstract_grid(shape: tuple, axes: tuple) -> Grid:
    """A grid of shapes only (no process group), for the sharding rules:
    the counterpart of ``jax.sharding.AbstractMesh``."""
    if len(shape) != len(axes):
        raise ValueError(f"grid shape {shape} and axes {axes} differ in "
                         f"length")
    return Grid(shape=dict(zip(axes, shape)))


def make_grid(shape: tuple, axes: tuple, *, rank: int | None = None,
              store=None, device=None,
              timeout: timedelta = timedelta(minutes=5)) -> Grid:
    """A grid of ``shape`` over axes ``axes`` (``jax.make_mesh``): joins or
    checks the default process group of world size prod(shape), as
    :func:`make_tp_group` (which raises, naming the world size, when the
    group has another), and lays a ``DeviceMesh`` with ``mesh_dim_names``
    ``axes`` over its ranks in row-major order."""
    from torch.distributed.device_mesh import init_device_mesh
    grid = abstract_grid(tuple(shape), tuple(axes))
    _, dev = _join(grid.size, f"grid {tuple(shape)} over {tuple(axes)}",
                   rank=rank, store=store, device=device, timeout=timeout)
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        _stage_functional_collectives()
    grid.mesh = init_device_mesh(dev.type, tuple(shape),
                                 mesh_dim_names=tuple(axes))
    grid.device = dev
    return grid


# the functional collectives DTensor issues, each with the tensor it sends
# first in its arguments
_FUNCTIONAL = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce", "all_to_all_single", "broadcast")
_STAGING: list = []


def _stage_functional_collectives() -> None:
    """Ranks sharing one card over gloo: the functional collectives DTensor
    issues (``torch.ops._c10d_functional``) take a CUDA tensor through the
    host, the same collective run on a host copy and its result copied
    back (gloo's all-gather of CUDA tensors crashed the process, torch
    2.11.0+cu128). Installed once per process, and only where the grid
    is gloo over CUDA: NCCL grids never see it."""
    if _STAGING:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in _FUNCTIONAL:
        op = getattr(torch.ops._c10d_functional, name).default

        def staged(x, *args, _op=op):
            out = _op(x.cpu(), *args)
            out = torch.ops._c10d_functional.wait_tensor(out)
            return out.to(x.device)
        lib.impl(name, staged, "CUDA")
    _STAGING.append(lib)


def make_debug_grid(data: int = 1, model: int = 1, **kw) -> Grid:
    """A (data, model) grid over data * model ranks (tests): the
    counterpart of ``make_debug_mesh``. ``kw``: :func:`make_grid`'s."""
    return make_grid((data, model), ("data", "model"), **kw)


def production_grid_shape(multi_pod: bool = False,
                          layout: str = "2d") -> tuple[tuple, tuple]:
    """(shape, axes) of the production grids, as ``make_production_mesh``:
    (16, 16) over (data, model), (2, 16, 16) with a pod axis; the
    expert-parallel layout ``"ep"`` factors the same ranks as (16, 8, 2)
    over (data, expert, tp), (2, 16, 8, 2) with pods."""
    if layout == "ep":
        if multi_pod:
            return (2, 16, 8, 2), ("pod", "data", "expert", "tp")
        return (16, 8, 2), ("data", "expert", "tp")
    if layout != "2d":
        raise ValueError(f"layout {layout!r}: '2d' or 'ep'")
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_grid(*, multi_pod: bool = False, layout: str = "2d",
                         **kw) -> Grid:
    """The production grid (:func:`production_grid_shape`) over a
    process group of its size (256 or 512 ranks); raises, naming that
    size, when the group has another. ``kw``: :func:`make_grid`'s."""
    return make_grid(*production_grid_shape(multi_pod, layout), **kw)


def _rank_main(rank: int, fn, tp: int, args: tuple, device,
               timeout: timedelta, tmp: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // tp))
    group = make_tp_group(tp, rank=rank,
                          store=dist.FileStore(os.path.join(tmp, "store"), tp),
                          device=device, timeout=timeout)
    try:
        out = fn(group, *args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


def run_ranks(fn, tp: int, *args, device=None,
              timeout: timedelta = timedelta(minutes=5)) -> list:
    """``fn(group, *args)`` on each of ``tp`` ranks, one spawned process
    each (``fn`` importable, ``args`` and the results picklable), each
    rank's CPU threads a 1/tp share of the cores; returns the ranks'
    results in rank order. A rank that raises fails the call (the others
    are stopped), as does a collective that waits past ``timeout``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=tp, join=True,
                 args=(fn, tp, args, device, timeout, tmp))
        out = []
        for r in range(tp):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# the score-mean all-reduces each policy's hooks issue per attention layer,
# (write_score, post_write, chunk_prefill_evict); a hook runs only in a
# step that has rows for it (decode rows: post_write, prefill rows:
# chunk_prefill_evict). JAX pmeans each of mean_h ||V|| and mean_h ||K||
# (repro/core/importance.py:26-48, :81-102); the port stacks the two into
# one all-reduce.
SCORE_REDUCTIONS = {
    "paged_eviction": (1, 0, 0),   # vk_ratio_score on write; the stored or
    #                                fused page scores when evicting
    "full": (0, 0, 0),
    "streaming_llm": (0, 0, 0),    # recency
    "inverse_key_l2": (1, 0, 0),   # -mean_h ||K|| on write
    "keydiff": (0, 1, 1),          # the cosine mean at eviction time
}


def step_collectives(cfg, policy: str, *, has_decode: bool,
                     has_prefill: bool, fused_scores: bool,
                     metrics: bool) -> Counter:
    """The collectives of one tensor-parallel engine step, by kind, as the
    JAX package's compiled step holds them (all-reduces only):

    - per attention layer: a sum after ``wo`` (repro/models/transformer.py:
      424-425), a sum after the MLP's ``w_down`` or the MoE experts' (f32,
      before the gate combine in the JAX package, after it in the port;
      repro/models/mlp.py:27-28,
      repro/models/moe.py:310-311), the policy's score means
      (:data:`SCORE_REDUCTIONS`), and with ``fused_scores`` a mean of the
      kernels' per-head norms for the page scores
      (repro/kernels/ops.py:36-43);
    - per step: a sum of the devstats vector, when ``metrics``
      (repro/serving/engine.py:269-276)."""
    write, post, chunk = SCORE_REDUCTIONS[policy]
    out = Counter()
    for spec in cfg.layer_specs():
        out["all_reduce_sum"] += 1 + (spec.mlp != "none")
        out["all_reduce_mean"] += (write + post * has_decode
                                   + chunk * has_prefill + fused_scores)
    out["all_reduce_sum"] += metrics
    return +out


# --- hardware constants: the roofline's denominators --------------------
# NVIDIA H100 SXM5 80GB, 700 W: datasheet figures, not measured. The dry
# run's node model puts GPUS_PER_NODE ranks on one NVLink node, ranks laid
# out row-major over the grid: a collective whose group lies inside one
# node moves its bytes over NVLink, any other over InfiniBand (one 400
# Gb/s NDR link per GPU). On the (16, 16) grid both axes leave the node
# (a "model" group spans 16 consecutive ranks, two nodes).
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12                # HBM3 bytes/s per GPU
NVLINK_BW = 450e9               # NVLink bytes/s per direction per GPU
IB_BW = 50e9                    # InfiniBand bytes/s per GPU
GPUS_PER_NODE = 8

"""The process group of tensor-parallel serving, as the JAX package's
``make_tp_mesh`` (``repro.launch.mesh``): one process per rank over
``torch.distributed``, where the JAX package runs one program over a
(1, tp) device mesh.

:func:`make_tp_group` initialises the default process group of world size
``tp`` (or checks the one already initialised, as under ``torchrun``) and
gives this rank its device. Its :class:`TPGroup` is the only way the port
issues a collective: sum and mean all-reduces over the group, each counted
by kind (``TPGroup.counts``), so a step's collectives can be read off and
held to :func:`step_collectives`, the inventory the JAX package's
``inspect_collectives --serve-tp`` reads from the compiled step.

The backend follows from the device: NCCL for one GPU per rank, gloo on
the CPU or when ranks share a GPU (fewer CUDA devices than ranks: NCCL
refuses two ranks on one device); gloo all-reduces CUDA tensors itself,
staging them through the host.

:func:`run_ranks` runs a function on every rank of a fresh group, one
spawned process each, joined through a ``FileStore`` in a temporary
directory (no port to clash over).
"""
from __future__ import annotations

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
    dev = resolve_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= tp else "gloo")
    if dist.is_initialized():
        if dist.get_world_size() != tp:
            raise ValueError(
                f"tp={tp} needs a process group of world size {tp}; the "
                f"initialised one has world size {dist.get_world_size()}")
    elif store is not None:
        if rank is None:
            raise ValueError(f"tp={tp}: joining a store needs this "
                             f"process's rank")
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=tp, timeout=timeout)
    else:
        missing = [v for v in _ENV if v not in os.environ]
        if missing:
            raise ValueError(
                f"tp={tp} needs a process group of world size {tp}: pass "
                f"rank= and store=, or run under torchrun (missing "
                f"{', '.join(missing)})")
        if int(os.environ["WORLD_SIZE"]) != tp:
            raise ValueError(f"tp={tp} needs a process group of world size "
                             f"{tp}; WORLD_SIZE is {os.environ['WORLD_SIZE']}")
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return TPGroup(rank=rank, size=tp, device=dev)


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
      before the gate combine; repro/models/mlp.py:27-28,
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

"""Sharding rules of the torch port, as the JAX package's
``repro.sharding.rules``: the GSPMD training rules over a (data, model)
grid, and the manual specs of tensor-parallel serving.

**Training over a grid** (:func:`param_spec` and below). A spec is a tuple
with one entry per dimension of a leaf: None (whole), a grid axis name,
or a tuple of names (the dimension split over their product, the first
name the major one), as a JAX ``PartitionSpec``. :func:`placements` turns
one into DTensor placements over the grid's ``DeviceMesh``. The rules are
the JAX package's, divisibility-checked, falling back to replication:
vocab-sharded ``embed`` / ``lm_head``; the mLSTM's (di, di) projections
split by row; ``wq`` by the heads and ``wk`` / ``wv`` by the KV heads when
they divide the model axes, ``wo`` by row; the dense MLP and the MoE
experts over d_ff, or on the expert-parallel grid (data, expert, tp) the
experts over ``expert`` and d_ff over ``tp``; mamba's d_inner; everything
else (norms, biases, the router, the recurrent gates) replicated. The
model axes are "model" on the (data, model) grid and ("expert", "tp") on
the expert-parallel one, where the dense layers split over both.

The port holds a plain list of layers (``params["layers"]``), so a spec
has no leading repetition dimension: the JAX package's spec of a stacked
pattern leaf minus its first entry. ZeRO-1 (:func:`opt_shardings`) takes
the first whole dimension of a moment that divides ``data``, as the JAX
package's ``zshard``; on a stacked leaf that can be JAX's repetition
dimension, which the port's leaf does not have, so there the two choose
different dimensions of the same size of shard.

**Tensor-parallel serving** (:func:`tp_param_dim` and below). A spec is
the dimension of a leaf that splits over the ``tp`` ranks, or None for a
leaf every rank holds whole. Every leaf is one or the other:

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
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

# ---------------------------------------------------------------------------
# training over a grid: the GSPMD rules
# ---------------------------------------------------------------------------


def axes_of(entry) -> tuple:
    """The grid axes of one spec entry: () for None, a name, or names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def grid_shape(grid) -> dict:
    """{axis name: size} of a grid, or of a ``DeviceMesh`` with named
    dimensions."""
    if hasattr(grid, "mesh_dim_names"):
        return dict(zip(grid.mesh_dim_names, grid.mesh.shape))
    return grid.shape


def axis_size(grid, *names: str) -> int:
    shape = grid_shape(grid)
    return math.prod(shape[n] for n in names if n in shape)


def batch_axes(grid, batch: int):
    """Largest data-parallel axis (or pair) that divides ``batch``:
    ("pod", "data") when the grid has a pod axis and both divide it,
    "data", or None."""
    shape = grid_shape(grid)
    if "pod" in shape and batch % axis_size(grid, "pod", "data") == 0:
        return ("pod", "data")
    if batch % axis_size(grid, "data") == 0:
        return "data"
    return None


def model_axes(grid):
    """The tensor-parallel axis: "model" on the (data, model) grid, the
    pair ("expert", "tp") on the expert-parallel one, or None."""
    shape = grid_shape(grid)
    if "model" in shape:
        return "model"
    if "expert" in shape:
        return ("expert", "tp")
    return None


def model_size(grid) -> int:
    return axis_size(grid, *axes_of(model_axes(grid)))


def param_spec(grid, cfg, path: str, shape: tuple) -> tuple:
    """The spec of the parameter at ``path`` ("layers/3/attn/wq") of
    ``shape``: the JAX package's ``_param_spec`` (rules.py:77-135) without
    the leading repetition dimension."""
    n = len(shape)
    msz, MA = model_size(grid), model_axes(grid)
    m = lambda d: msz > 1 and shape[d] % msz == 0  # noqa: E731
    name = path.rsplit("/", 1)[-1]
    whole = (None,) * n

    def spec(*dims):
        return tuple(dims) + (None,) * (n - len(dims))

    H, KV = cfg.num_heads, cfg.num_kv_heads
    if name in ("embed", "lm_head"):          # (V, D) or (K, V, D): vocab
        return spec(*[None] * (n - 2), MA) if m(n - 2) else whole
    if name in ("wq", "wk", "wv") and "mlstm" in path:
        # the mLSTM's inner (di, di) projections: by row
        return spec(MA) if m(0) else whole
    if name == "wq":
        return spec(None, MA) if H % msz == 0 and m(1) else whole
    if name in ("wk", "wv"):
        return spec(None, MA) if KV % msz == 0 and m(1) else whole
    if name == "wo":
        return spec(MA) if H % msz == 0 and m(0) else whole
    gshape = grid_shape(grid)
    E = cfg.num_experts
    ep = "expert" in gshape and E and E % gshape["expert"] == 0
    if name in ("w_gate", "w_up"):
        if n == 3:                            # MoE (E, D, F)
            if ep and shape[2] % gshape["tp"] == 0:
                return spec("expert", None, "tp")   # expert-parallel
            return spec(None, None, MA) if m(2) else whole
        return spec(None, MA) if m(1) else whole
    if name == "w_down":
        if n == 3:                            # MoE (E, F, D)
            if ep and shape[1] % gshape["tp"] == 0:
                return spec("expert", "tp", None)
            return spec(None, MA, None) if m(1) else whole
        return spec(MA) if m(0) else whole
    if name in ("in_proj", "up_proj", "dt_proj", "w_gates"):
        return spec(None, MA) if m(1) else whole
    if name in ("out_proj", "down_proj", "x_proj"):
        return spec(MA) if m(0) else whole
    if name == "conv_w":                      # (dc, di)
        return spec(None, MA) if m(1) else whole
    if name == "A_log":                       # (di, ds)
        return spec(MA) if m(0) else whole
    if name in ("D", "dt_bias", "conv_b"):    # (di,)
        return spec(MA) if m(0) else whole
    # norms, biases, the router, gates, recurrent matrices
    return whole


def param_shardings(grid, cfg, params) -> dict:
    """The spec of every parameter, as a tree shaped like ``params`` (of
    tensors, meta tensors included)."""
    return map_tree(params, lambda t, p: param_spec(grid, cfg, p,
                                                 tuple(t.shape)))


def data_shardings(grid, batch_tree):
    """Every leaf's leading (batch) dimension over the data axes that
    divide it, the rest whole."""
    def rule(t, _):
        if t.dim() == 0:
            return ()
        return (batch_axes(grid, t.shape[0]),) + (None,) * (t.dim() - 1)
    return map_tree(batch_tree, rule)


def zero1_spec(grid, spec: tuple, shape: tuple) -> tuple:
    """``spec`` with its first whole dimension that ``data`` divides (and
    is at least as large as) split over ``data``: the JAX package's
    ``zshard`` on the port's leaf (no repetition dimension)."""
    dsz = axis_size(grid, "data")
    out = list(spec)
    for i, n in enumerate(shape):
        if out[i] is None and dsz > 1 and n % dsz == 0 and n >= dsz:
            out[i] = "data"
            break
    return tuple(out)


def opt_shardings(grid, cfg, opt_shape, params_shardings,
                  zero1: bool = False):
    """An ``AdamWState`` of specs: the moments mirror the parameters'
    specs, the step count is whole. ``zero1``: each moment also split over
    ``data`` (:func:`zero1_spec`)."""
    from repro_torch.training.optimizer import AdamWState
    if not zero1:
        return AdamWState(step=(), mu=params_shardings, nu=params_shardings)

    def z(tree):
        return _zip_tree(params_shardings, tree,
                         lambda s, t: zero1_spec(grid, s, tuple(t.shape)))
    return AdamWState(step=(), mu=z(opt_shape.mu), nu=z(opt_shape.nu))


def _zip_tree(specs, tree, fn):
    """``fn(spec, leaf)`` over a tree of specs and a tree of tensors of
    the same structure (dicts and lists; a spec is a tuple)."""
    if isinstance(tree, dict):
        return {k: _zip_tree(specs[k], v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_tree(s, v, fn) for s, v in zip(specs, tree)]
    return fn(specs, tree)


def placements(grid, spec: tuple, partial: tuple = ()) -> list:
    """DTensor placements over the grid's mesh dimensions of ``spec``:
    Shard(d) on each axis that dimension d names, Partial() on the axes of
    ``partial`` (a value still to be summed over them), Replicate() on the
    rest. A dimension split over several axes names them in the grid's
    order (the first the major one), as DTensor lays them out."""
    names = list(grid_shape(grid))
    for e in spec:
        idx = [names.index(a) for a in axes_of(e)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: {e} is not in the grid's axis "
                             f"order {names}")
    out = []
    for ax in names:
        dims = [d for d, e in enumerate(spec) if ax in axes_of(e)]
        if ax in partial:
            out.append(Partial())
        elif dims:
            out.append(Shard(dims[0]))
        else:
            out.append(Replicate())
    return out


def _mesh(grid):
    return grid if hasattr(grid, "mesh_dim_names") else grid.mesh


def place(grid, t: torch.Tensor, spec: tuple) -> DTensor:
    """``t`` as a DTensor laid out by ``spec``: a DTensor redistributed
    (collectives as the layouts need), a plain tensor (the same whole
    value on every rank) cut to this rank's shard without a collective.
    A plain tensor on another device than the grid's (weights drawn on
    the host) is cut there, and only the shard moves to the grid's
    device."""
    pl = placements(grid, spec)
    mesh = _mesh(grid)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    if t.device.type != mesh.device_type:
        # the rules split only dimensions their axes divide; a meta tensor
        # (the dry run) keeps its shard on meta
        local = _cut(mesh, t, pl)
        if t.device.type != "meta":
            local = local.to(mesh.device_type)
        return DTensor.from_local(local.contiguous(), mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def _cut(mesh, t: torch.Tensor, pl: list) -> torch.Tensor:
    """This rank's chunk of ``t`` (a view) under placements ``pl``: the
    dimensions split over several mesh dimensions split major first."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if p.is_shard():
            t = t.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return t


def distribute(grid, tree, specs):
    """Every leaf of ``tree`` placed by its spec (:func:`place`); a leaf
    that requires grad gives a leaf DTensor that does too."""
    def one(s, t):
        req = t.requires_grad
        out = place(grid, t.detach(), s)
        return out.requires_grad_(req) if req else out
    return _zip_tree(specs, tree, one)


def full(t):
    """The whole value of a DTensor on every rank (a collective every
    rank must join); any other value as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def to_local(grid, x, spec: tuple, grad_partial: tuple = ()):
    """This rank's shard of ``x`` laid out by ``spec``, entering a region
    computed on local shards (the JAX package's ``shard_map``). Its
    gradient is taken as partial over the axes of ``grad_partial``: those
    whose ranks hold the same ``x`` but use it on different shards of the
    work (e.g. a weight used on each data shard's tokens), so that their
    gradients are summed where they meet a whole one."""
    return place(grid, x, spec).to_local(
        grad_placements=placements(grid, spec, grad_partial))


def from_local(grid, t: torch.Tensor, spec: tuple,
               partial: tuple = ()) -> DTensor:
    """A region's local result ``t`` as a DTensor laid out by ``spec``,
    still to be summed over the axes of ``partial``."""
    return DTensor.from_local(t, _mesh(grid),
                              placements(grid, spec, partial),
                              run_check=False)


def sum_over(grid, t: torch.Tensor, spec: tuple, axes: tuple) -> DTensor:
    """The sum over the grid axes ``axes`` of a region's local ``t`` (one
    all-reduce, differentiable), laid out by ``spec``: the JAX package's
    ``psum`` inside a ``shard_map``."""
    return from_local(grid, t, spec, axes).redistribute(
        _mesh(grid), placements(grid, spec))


def all_to_all(grid, t: torch.Tensor, axis: str) -> torch.Tensor:
    """A region's local ``t`` exchanged over grid axis ``axis``: block i
    of dim 0 (a multiple of the axis's size) goes to the rank at index i
    along the axis, which receives every rank's block in their order
    (``jax.lax.all_to_all`` with split and concat axis 0). The functional
    collective, differentiable (the gradient takes the reverse exchange),
    so a gloo grid over CUDA stages it through the host with the rest
    (``launch.mesh.make_grid``)."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd, wait_tensor)
    return wait_tensor(all_to_all_single_autograd(
        t.contiguous(), None, None, _mesh(grid).get_group(axis)))


def pointwise(fn, x):
    """``fn`` (elementwise) of ``x``; of a DTensor on each rank's shard
    (a partial one summed first), for an op DTensor has no rule for
    (``logsigmoid``'s backward)."""
    if not isinstance(x, DTensor):
        return fn(x)
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False)


def vocab_embedding(table: DTensor, tokens) -> DTensor:
    """``table[tokens]`` of a DTensor table (V, D) split over its vocab
    rows: each rank gathers the tokens its rows hold (zero elsewhere) and
    one sum over the vocab axes completes every row, as GSPMD lowers a
    vocab-sharded gather. Written out because DTensor's own rule for it
    cannot take a table split over two grid axes (the expert-parallel
    grid's ("expert", "tp")). The tokens' layout (their batch split)
    carries over to the result."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, tpl = table.device_mesh, table.placements
    vocab = [i for i, p in enumerate(tpl) if p.is_shard(0)]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tpl_tok = [Replicate() if i in vocab else p
               for i, p in enumerate(tokens.placements)]
    tok = tokens.redistribute(mesh, tpl_tok).to_local().long()
    (n, _), (lo, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, tpl)
    # a rank's rows take the gradient of its tokens only
    w = table.to_local(grad_placements=[
        p if i in vocab else
        (Partial() if tpl_tok[i].is_shard() else Replicate())
        for i, p in enumerate(tpl)])
    idx = tok - lo
    ok = (idx >= 0) & (idx < n)
    out = torch.where(ok[..., None], w[idx.clamp(0, n - 1)], 0.0)
    pl = [Partial() if i in vocab else p for i, p in enumerate(tpl_tok)]
    return DTensor.from_local(out, mesh, pl, run_check=False).redistribute(
        mesh, [Replicate() if p.is_partial() else p for p in pl])


def shard_offset(t: DTensor, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of a
    DTensor."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)[1][dim]


def whole_like(t: torch.Tensor, like) -> torch.Tensor:
    """A plain ``t`` made alike on every rank (positions, masks, initial
    states) as a replicated DTensor on ``like``'s grid, so that it may
    meet ``like``; ``t`` itself when ``like`` is not a DTensor. Nothing
    else is taken as replicated: any other plain tensor that meets a
    DTensor raises."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def activation_constraint(grid, batch: int, seq_parallel: bool = False):
    """An ``ac`` callable for the training forward: pins a layer's input
    (B, S, D) / (B, D) to the batch split over the data axes, whole
    elsewhere (DTensor ``redistribute``, differentiable; the JAX package's
    ``with_sharding_constraint``).

    ``seq_parallel``: a (B, S, D) input also splits S over the model axes
    (Megatron's sequence parallelism): per-token norms run on the split,
    and each mixer's input is gathered back (the redistribution DTensor
    picks when an operation needs the whole sequence).

    ``ac.inner(x)``: (B, ..., C) with the batch on dim 0 and C over the
    model axes when they divide it; ``ac.time(x)``: (S, B, ..., C), the
    batch on dim 1. ``ac.grid`` and ``ac.batch_axes`` name the grid and
    the batch axes, for the regions computed on local shards (attention,
    the MoE block, the mamba mixer)."""
    b = batch_axes(grid, batch)
    msz, MA = model_size(grid), model_axes(grid)

    def ac(x):
        if seq_parallel and x.dim() >= 3 and msz > 1 and \
                x.shape[1] % msz == 0:
            return place(grid, x, (b, MA) + (None,) * (x.dim() - 2))
        return place(grid, x, (b,) + (None,) * (x.dim() - 1))

    def last(x):
        return MA if msz > 1 and x.shape[-1] % msz == 0 else None

    def inner(x):
        return place(grid, x, (b,) + (None,) * (x.dim() - 2) + (last(x),))

    def time(x):
        return place(grid, x,
                     (None, b) + (None,) * (x.dim() - 3) + (last(x),))

    ac.inner, ac.time = inner, time
    ac.grid, ac.batch_axes = grid, b
    return ac


def pin_inner(ac):
    """A module's inner pin: ``ac.inner`` when ``ac`` has one, else the
    identity."""
    return getattr(ac, "inner", None) or (lambda x: x)


def pin_time(ac):
    return getattr(ac, "time", None) or (lambda x: x)


# ---------------------------------------------------------------------------
# training over a grid: the cache and step-input specs
# ---------------------------------------------------------------------------

# the port's names of a PagedLayerCache's fields -> the JAX package's; the
# port's pool buffers carry the trash row N, which the JAX leaves lack
_JAX_NAME = {"k_buf": "k", "v_buf": "v", "pos_buf": "pos",
             "score_buf": "score", "k_scale_buf": "k_scale",
             "v_scale_buf": "v_scale"}


def _dp_axes(grid, n: int) -> tuple:
    """The data axes over which a pool dimension of ``n`` pages splits
    evenly: ("pod", "data"), ("data",) or ()."""
    shape = grid_shape(grid)
    if "pod" in shape and n % axis_size(grid, "pod", "data") == 0:
        return ("pod", "data")
    if axis_size(grid, "data") > 1 and n % axis_size(grid, "data") == 0:
        return ("data",)
    return ()


def _pool_dim0(grid, n: int, take_model: bool):
    """The spec entry of the pool's page dimension: its data axes, with
    the model axes folded in after them when ``take_model`` (the KV heads
    do not split over the model axes) and they divide it too."""
    dp = _dp_axes(grid, n)
    msz = model_size(grid)
    if take_model and msz > 1:
        ma = axes_of(model_axes(grid))
        if n % axis_size(grid, *(dp + ma)) == 0:
            dp = dp + ma
    return None if not dp else (dp[0] if len(dp) == 1 else dp)


def cache_spec(grid, cfg, path: str, shape: tuple, batch: int) -> tuple:
    """The spec of the cache leaf at ``path`` of ``shape`` (paths as
    :func:`tp_cache_specs` gives them: "layers/0/k_buf", "cross/1/k",
    "cur_pos"): the JAX package's ``_cache_spec`` (rules.py:150-236) on
    the port's leaves, which have no repetition dimension.

    A page pool's buffers (``k_buf``, ``v_buf``, ``pos_buf``,
    ``score_buf``, the int8 scales) hold N + 1 rows; their spec is that
    of the N pool rows, and over a grid the trash row is left out
    (:func:`place_cache`): a region that writes the pool builds its
    whole buffer with a fresh trash row, so per-rank bytes are the JAX
    rule's exactly. The pool's pages split over the data axes, with the
    model axes folded in when the KV heads do not divide them, else the
    KV heads over the model axes; ``pos`` / ``score`` / ``ref_count``
    follow the pages; ``stats`` is whole; ``block_table`` and the
    write heads split over the batch; the conditioning K/V over the batch
    and the KV heads; the recurrent states over the batch and their
    inner width."""
    kind, name = path.split("/", 1)[0], path.rsplit("/", 1)[-1]
    b = batch_axes(grid, batch)
    n = len(shape)
    msz, MA = model_size(grid), model_axes(grid)
    kv_div = msz > 1 and cfg.num_kv_heads % msz == 0
    m = lambda d: msz > 1 and shape[d] % msz == 0  # noqa: E731

    def spec(*dims):
        return tuple(dims) + (None,) * (n - len(dims))

    if kind == "layers" and name in _JAX_NAME:
        pages = shape[0] - 1
        d0 = _pool_dim0(grid, pages, take_model=not kv_div)
        if n == 4:                               # K/V (N, page, KV, hd)
            return spec(d0, None, MA if kv_div else None)
        if n == 3:                               # int8 scales (N, page, KV)
            return spec(d0, None, MA if kv_div else None)
        return spec(d0)                          # pos / score (N, page)
    if kind == "cross":                          # (B, Sc, KV, hd)
        return spec(b, None, MA if kv_div else None)
    if name == "ref_count":
        return spec(_pool_dim0(grid, shape[0], take_model=not kv_div))
    if name == "stats":
        return spec()
    if name == "block_table":
        return spec(b)
    if name in ("cur_page", "cur_off", "cur_pos"):
        return spec(b)
    if name == "conv":                           # (B, dc - 1, di)
        return spec(b, None, MA if n == 3 and m(2) else None)
    if name == "ssm":                            # (B, di, ds)
        return spec(b, MA if m(1) else None)
    if name == "C":                              # mLSTM (B, H, hd, hd)
        return spec(b, None, MA if m(2) else None)
    if name == "n" and n == 3:                   # mLSTM (B, H, hd)
        return spec(b, None, MA if m(2) else None)
    if name == "m" and n == 2 and shape[1] <= 128:   # mLSTM (B, H)
        return spec(b)
    if name in ("c", "h", "n", "m") and n == 2:  # sLSTM (B, D)
        return spec(b, MA if m(1) else None)
    return spec(b)


def cache_shardings(grid, cfg, cache, batch: int) -> dict:
    """{path: spec} of every tensor of a ``ModelCache`` (paths as
    :func:`tp_cache_specs`), by :func:`cache_spec`."""
    return {path: cache_spec(grid, cfg, path, tuple(leaf.shape), batch)
            for path, leaf in _cache_leaves(cache)}


def place_cache(grid, cfg, cache, batch: int):
    """A ``ModelCache`` (e.g. from ``init_decode_caches``, whole on every
    rank, or on "meta") laid out over the grid by :func:`cache_shardings`:
    every tensor a DTensor, each pool buffer without its trash row."""
    specs = cache_shardings(grid, cfg, cache, batch)

    def one(path, t):
        name = path.rsplit("/", 1)[-1]
        if path.startswith("layers/") and name in _JAX_NAME:
            t = t[:-1]
        return place(grid, t, specs[path])

    def copy(c, kind, i):
        return None if c is None else dataclasses.replace(c, **{
            f.name: one(f"{kind}/{i}/{f.name}", getattr(c, f.name))
            for f in dataclasses.fields(c)
            if getattr(c, f.name) is not None})
    return dataclasses.replace(
        cache, layers=[copy(c, "layers", i)
                       for i, c in enumerate(cache.layers)],
        cross=[copy(c, "cross", i) for i, c in enumerate(cache.cross)],
        cur_pos=one("cur_pos", cache.cur_pos))


def whole_cache(cache):
    """The one-device ``ModelCache`` of a cache laid out over a grid
    (:func:`place_cache`): every DTensor gathered whole (a collective
    every rank must join), each pool buffer given back its trash row
    (zero K/V, position -1, score -inf). A plain cache is returned as
    it is."""
    if not isinstance(cache.cur_pos, DTensor):
        return cache

    def copy(c, paged):
        return None if c is None else dataclasses.replace(c, **{
            f.name: with_trash_row(f.name if paged else "",
                                   full(getattr(c, f.name)))
            for f in dataclasses.fields(c)
            if getattr(c, f.name) is not None})
    from repro_torch.core.paged_cache import PagedLayerCache
    return dataclasses.replace(
        cache, layers=[copy(c, isinstance(c, PagedLayerCache))
                       for c in cache.layers],
        cross=[copy(c, False) for c in cache.cross],
        cur_pos=full(cache.cur_pos))


def with_trash_row(name: str, t: torch.Tensor) -> torch.Tensor:
    """A pool buffer ``name`` of N rows given its trash row (zero K/V and
    scales, position -1, score -inf); any other field as it is."""
    if name not in _JAX_NAME:
        return t
    fill = {"pos_buf": -1, "score_buf": -torch.inf}.get(name, 0)
    return torch.cat([t, torch.full_like(t[:1], fill)])


def step_input_shardings(grid, cfg, batch: int, chunk: int) -> dict:
    """The specs of the unified step's operands and the chunked-prefill
    kernel's tile layouts, as the JAX package's ``step_input_shardings``
    (rules.py:250-301): the batch over the data axes; the query heads,
    the decode partials' and the epilogue norms' KV heads over the model
    axes when they divide them; ``block_table`` and ``page_scores`` over
    the batch only. ``chunk`` (the step's T) does not change a spec."""
    b = batch_axes(grid, batch)
    msz, MA = model_size(grid), model_axes(grid)
    heads = MA if msz > 1 and cfg.num_heads % msz == 0 else None
    kv = MA if msz > 1 and cfg.num_kv_heads % msz == 0 else None
    return {
        "tokens": (b, None),
        "n_tok": (b,),
        "mask": (b,),
        "share_src": (b,),
        "share_pages": (b,),
        "q": (b, None, heads, None),
        "q_pos": (b, None),
        "block_table": (b, None),
        "page_scores": (b, None),
        "decode_partials": (b, kv, None, None, None),
        "epilogue_norms": (b, kv, None, None),
    }


# ---------------------------------------------------------------------------
# tensor-parallel serving: the manual specs
# ---------------------------------------------------------------------------

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


def map_tree(tree, fn, path=""):
    """``fn(leaf, path)`` over a tree of dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(tree, path)


def tp_param_specs(params: dict) -> dict:
    """The split dimension (or None) of every parameter, as a tree shaped
    like ``params``."""
    return map_tree(params, lambda t, p: tp_param_dim(p, tuple(t.shape)))


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
    return map_tree(params, lambda t, p: _slice(
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

"""Selective SSM (Mamba) mixer: jamba's recurrent layer, computed in plain
torch as the JAX package computes it in plain jnp (it has no Pallas kernel,
so the port has no CUDA one).

Training (``mamba_forward``): a per-token scan over the sequence carrying
the (B, d_inner, d_state) f32 state, in windows of W = 256, 64 or 1 tokens
(by S % W), each window recomputed in the backward pass
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` of its
inner scan), so that autograd keeps only the window-boundary states.
``mamba_prefill`` is the same scan returning the final state, and
``mamba_decode_step`` the O(1) one-token update.

The JAX package's scan step discretises each token inside the loop; the
port computes a window's discretisation (exp(dt A) and dt x B, (W, B,
d_inner, d_state) f32) and its outputs (h C) outside the token loop, so
that a token costs two tensor ops, not eight: the same arithmetic, one
window's tensors materialised (the JAX package avoids materialising them
for the whole sequence; so do the windows).

dtypes where the JAX package puts them: the depthwise conv runs in the
activations' dtype in ``mamba_forward`` and ``mamba_prefill`` but in f32 in
``mamba_decode_step`` (cast back after the SiLU); the SSM is f32 throughout;
``A_log``, ``D`` and ``dt_bias`` are f32 in a bf16 model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, dtype_of
from repro_torch.sharding import rules


@dataclass
class MambaState:
    conv: torch.Tensor   # (B, d_conv - 1, d_inner): trailing inputs window
    ssm: torch.Tensor    # (B, d_inner, d_state) f32


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt_ = dtype_of(cfg.dtype)
    D, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dr, dc = cfg.resolved_dt_rank, cfg.mamba_d_conv
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    # S4D-real initialization for A
    a = torch.arange(1, ds + 1, **f32).expand(di, ds)
    in_proj = dense_init(gen, D, 2 * di, dt_)
    conv_w = (torch.randn((dc, di), generator=gen, **f32) * 0.2).to(dt_)
    x_proj = dense_init(gen, di, dr + 2 * ds, dt_)
    dt_proj = dense_init(gen, dr, di, dt_)
    u = torch.rand((di,), generator=gen, **f32)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dt_, device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.log(torch.expm1(dt0.clamp_min(1e-4))),
        "A_log": torch.log(a),
        "D": torch.ones((di,), **f32),
        "out_proj": dense_init(gen, di, D, dt_),
    }


def _ssm_inputs(params: dict, cfg: ModelConfig, xc: torch.Tensor,
                reduce=None):
    """xc: (..., di) post-conv activations -> dt (..., di), Bt, Ct (...,
    ds), all f32. ``reduce``: the sum over the ranks that hold xc's other
    channels (a grid's model axes), applied to ``xc @ x_proj``."""
    dr, ds = cfg.resolved_dt_rank, cfg.mamba_d_state
    proj = xc @ params["x_proj"]
    proj = (proj if reduce is None else reduce(proj)).float()
    dt_in, Bt, Ct = proj.split([dr, ds, ds], dim=-1)
    # jax.nn.softplus: F.softplus returns x itself above its threshold of
    # 20, where log1p(exp(x)) - x < exp(-20) ~ 2e-9, below f32's resolution
    # there (one ulp of 20 is 1.9e-6)
    dt = F.softplus(dt_in @ params["dt_proj"].float() + params["dt_bias"])
    return dt, Bt, Ct


def _conv_silu(params: dict, xin: torch.Tensor, dc: int) -> torch.Tensor:
    """Depthwise causal conv1d over (B, S, di) then SiLU, in xin's dtype."""
    S = xin.shape[1]
    xp = F.pad(xin, (0, 0, dc - 1, 0))
    xc = sum(xp[:, i:i + S] * params["conv_w"][i] for i in range(dc))
    return F.silu(xc + params["conv_b"])


def _scan(h, dt, Bt, Ct, xcf, A):
    """The selective scan over time-major inputs dt, xcf (W, B, di), Bt, Ct
    (W, B, ds) from the state h (B, di, ds): (final h, ys (W, B, di))."""
    dA = torch.exp(dt[..., None] * A)                      # (W, B, di, ds)
    dBx = (dt * xcf)[..., None] * Bt[:, :, None, :]
    hs = []
    # unbind, not dA[t]: a select's backward writes a whole zero tensor
    for dA_t, dBx_t in zip(dA.unbind(0), dBx.unbind(0)):
        h = dA_t * h + dBx_t
        hs.append(h)
    return h, torch.einsum("wbds,wbs->wbd", torch.stack(hs), Ct)


def _windows(S: int, W: int):
    return [slice(s0, min(s0 + W, S)) for s0 in range(0, S, W)]


def _scan_inputs(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """The projections and conv shared by the forward and the prefill:
    (xin, z, time-major (dt, Bt, Ct, xcf), xcf (B, S, di) f32)."""
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)          # (B, S, di)
    xc = _conv_silu(params, xin, cfg.mamba_d_conv)
    dt, Bt, Ct = _ssm_inputs(params, cfg, xc)                 # f32
    xcf = xc.float()
    xs = tuple(a.transpose(0, 1) for a in (dt, Bt, Ct, xcf))
    return xin, z, xs, xcf


def _mamba_out(params: dict, ys, xcf, z, dtype) -> torch.Tensor:
    y = ys.transpose(0, 1) + xcf * params["D"]
    return (y.to(dtype) * F.silu(z)) @ params["out_proj"]


def _scan_all(h, xs, A, S: int):
    """The windowed scan of :func:`mamba_forward` over time-major inputs
    -> ys (S, B, di)."""
    W = 256 if S % 256 == 0 else (64 if S % 64 == 0 else 1)
    ys = []
    if W > 1:
        for w in _windows(S, W):
            h, y = checkpoint(_scan, h, *(a[w] for a in xs), A,
                              use_reentrant=False)
            ys.append(y)
    else:
        # the JAX package's one scan, nothing recomputed (in windows of
        # 256 here only to bound the window tensors)
        for w in _windows(S, 256):
            h, y = _scan(h, *(a[w] for a in xs), A)
            ys.append(y)
    return torch.cat(ys)


# the mixer's weights, by the dims that hold d_inner (the model axes
# split them when they divide d_inner)
_DI_DIMS = {"conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj": 1,
            "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}


def _grid_forward(params: dict, cfg: ModelConfig, x, ac):
    """:func:`mamba_forward` over a grid (DTensor x). ``x @ in_proj`` and
    its split into xin and z are DTensor operations, each half pinned by
    ``pin_inner(ac)`` (the batch over the data axes, d_inner over the
    model axes when they divide it), as the JAX package pins them. The
    rest runs on each rank's shards, since the conv, the discretisation
    and the scan are independent per (example, channel); their local
    layouts are those the JAX package's ``pin_inner`` / ``pin_time`` give
    them. Two sums over the model axes are all it needs: of ``xc @
    x_proj`` (whose gradient each rank's channels give in part) and of
    the output projection (left pending for the residual add). The
    weights' gradients are partial over the batch axes (each rank its
    examples)."""
    grid, b = ac.grid, ac.batch_axes
    di = cfg.mamba_d_inner
    msz = rules.model_size(grid)
    mdi = rules.model_axes(grid) if msz > 1 and di % msz == 0 else None
    model, spec = rules.axes_of(mdi), (b, None, mdi)
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    pi = rules.pin_inner(ac)
    xin, z = (rules.to_local(grid, pi(t), spec) for t in (xin, z))
    p = {}
    for k, d in _DI_DIMS.items():
        s = [None] * params[k].dim()
        s[d] = mdi
        p[k] = rules.to_local(grid, params[k], tuple(s), rules.axes_of(b))
    xc = _conv_silu(p, xin, cfg.mamba_d_conv)
    pspec = (b, None, None)

    def reduce(t):
        return rules.sum_over(grid, t, pspec, model).to_local(
            grad_placements=rules.placements(grid, pspec, model))
    dt, Bt, Ct = _ssm_inputs(p, cfg, xc, reduce if model else None)
    xcf = xc.float()
    xs = tuple(a.transpose(0, 1) for a in (dt, Bt, Ct, xcf))
    h = torch.zeros((xin.shape[0], xin.shape[-1], cfg.mamba_d_state),
                    dtype=torch.float32, device=xin.device)
    ys = _scan_all(h, xs, -torch.exp(p["A_log"]), x.shape[1])
    out = _mamba_out(p, ys, xcf, z, x.dtype)
    return rules.from_local(grid, out, pspec, model)


def mamba_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  ac=None) -> torch.Tensor:
    """Full-sequence selective scan, the training route. x: (B, S, D) ->
    (B, S, D). Windows of W = 256 or 64 tokens (the largest dividing S; 1
    otherwise, then one scan without recomputation), each recomputed in the
    backward pass. Over a grid (DTensor x) it runs on each rank's shards
    (:func:`_grid_forward`), pinned by ``ac`` (default: the grid's own
    constraint for this batch)."""
    B, S, _ = x.shape
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    if isinstance(x, DTensor):
        if ac is None:
            ac = rules.activation_constraint(x.device_mesh, B)
        return _grid_forward(params, cfg, x, ac)
    _, z, xs, xcf = _scan_inputs(params, cfg, x)
    A = -torch.exp(params["A_log"])                           # (di, ds)
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    return _mamba_out(params, _scan_all(h, xs, A, S), xcf, z, x.dtype)


def mamba_init_state(cfg: ModelConfig, batch: int, dtype, device
                     ) -> MambaState:
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return MambaState(
        conv=torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
        ssm=torch.zeros((batch, di, ds), dtype=torch.float32, device=device))


def mamba_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """Like :func:`mamba_forward` (one scan, nothing recomputed) but also
    returns the final recurrent state so that decode can continue. x: (B,
    S, D) -> (out, MambaState). The conv window is the last d_conv - 1
    inputs of x, whatever they are (padding included: no mask reaches
    here, as in the JAX package)."""
    B, S, _ = x.shape
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    xin, z, xs, xcf = _scan_inputs(params, cfg, x)
    A = -torch.exp(params["A_log"])
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for w in _windows(S, 256):          # windows bound the window tensors
        h, y = _scan(h, *(a[w] for a in xs), A)
        ys.append(y)
    out = _mamba_out(params, torch.cat(ys), xcf, z, x.dtype)
    conv = xin[:, S - (dc - 1):].clone(memory_format=torch.contiguous_format)
    return out, MambaState(conv=conv, ssm=h)


def mamba_decode_step(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      state: MambaState):
    """Single-token update. x: (B, D) -> (out (B, D), new state)."""
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)          # (B, di)
    window = torch.cat([state.conv, xin[:, None, :]], dim=1)   # (B, dc, di)
    xc = torch.einsum("bcd,cd->bd", window.float(),
                      params["conv_w"].float())
    xc = F.silu(xc + params["conv_b"].float()).to(x.dtype)
    dt, Bt, Ct = _ssm_inputs(params, cfg, xc)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[..., None] * A)                          # (B, di, ds)
    xcf = xc.float()
    h = dA * state.ssm + (dt * xcf)[..., None] * Bt[:, None, :]
    y = torch.einsum("bds,bs->bd", h, Ct) + xcf * params["D"]
    out = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    return out, MambaState(conv=window[:, 1:], ssm=h)

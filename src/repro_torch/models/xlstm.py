"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory with recurrent gate feedback), computed in plain torch as
the JAX package computes them in plain jnp (it has no Pallas kernel, so the
port has no CUDA one).

mLSTM over a sequence takes the chunkwise-parallel form
(``mlstm_chunkwise``): quadratic within a chunk, the matrix state handed
from chunk to chunk. Decode is the exact O(1) recurrent step, the depthwise
conv window carried in the state. Both use the same log-space
stabilization: the stabilizer m starts at -inf, and ``torch.maximum``
propagates it as ``jnp.maximum`` does.

sLSTM feeds its hidden state back through the gates, so it runs token by
token, with block-diagonal per-head recurrent matrices.

No KV cache exists in either block: the states below are the decode cache,
of a constant size. Gate weights and biases and the ``r_*`` matrices are
f32 in a bf16 model, as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init, dtype_of
from repro_torch.sharding import rules

_CONV = 4  # depthwise causal conv kernel width on the q/k branch


@dataclass
class MLSTMState:
    C: torch.Tensor     # (B, H, hd, hd) f32 stabilized matrix memory
    n: torch.Tensor     # (B, H, hd) f32 stabilized normalizer
    m: torch.Tensor     # (B, H) f32 running log-stabilizer
    conv: torch.Tensor  # (B, _CONV - 1, di) trailing conv inputs


@dataclass
class SLSTMState:
    c: torch.Tensor     # (B, D) f32 cell
    n: torch.Tensor     # (B, D) f32 normalizer
    h: torch.Tensor     # (B, D) f32 hidden (feeds back into the gates)
    m: torch.Tensor     # (B, D) f32 stabilizer


def _inner(cfg: ModelConfig) -> int:
    return int(cfg.xlstm_proj_factor * cfg.d_model)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg.dtype)
    D, H, di = cfg.d_model, cfg.num_heads, _inner(cfg)
    if di % H:
        raise ValueError(f"mLSTM inner width {di} is not a multiple of the "
                         f"{H} heads")
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    up_proj = dense_init(gen, D, 2 * di, dt)
    conv_w = (torch.randn((_CONV, di), generator=gen, **f32) * 0.2).to(dt)
    return {
        "up_proj": up_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "wq": dense_init(gen, di, di, dt),
        "wk": dense_init(gen, di, di, dt),
        "wv": dense_init(gen, di, di, dt),
        "w_igate": dense_init(gen, di, H, torch.float32, scale=0.01),
        "b_igate": torch.full((H,), -3.0, **f32),
        "w_fgate": dense_init(gen, di, H, torch.float32, scale=0.01),
        "b_fgate": torch.full((H,), 3.0, **f32),
        "out_norm": torch.ones((di,), dtype=dt, device=dev),
        "down_proj": dense_init(gen, di, D, dt),
    }


def _mlstm_up(params: dict, x: torch.Tensor):
    """x: (B, S, D) -> u, z: (B, S, di)."""
    return (x @ params["up_proj"]).chunk(2, dim=-1)


def _conv_seq(params: dict, u: torch.Tensor, conv_state=None):
    """Depthwise causal conv over the sequence then SiLU. u: (B, S, di);
    conv_state: optional (B, _CONV - 1, di) trailing inputs from the
    past."""
    S = u.shape[1]
    if conv_state is None:
        up = F.pad(u, (0, 0, _CONV - 1, 0))
    else:
        up = torch.cat([conv_state.to(u.dtype), u], dim=1)
    xc = sum(up[:, i:i + S] * params["conv_w"][i] for i in range(_CONV))
    return F.silu(xc + params["conv_b"])


def _qkv_gates_from(params: dict, cfg: ModelConfig, u, xc):
    """u, xc: (B, S, di) -> q, k, v (B, S, H, hd) f32, log-gates i, f (B,
    S, H)."""
    B, S, di = u.shape
    H = cfg.num_heads
    hd = di // H
    q = (xc @ params["wq"]).reshape(B, S, H, hd).float()
    k = ((xc @ params["wk"]) / math.sqrt(hd)).reshape(B, S, H, hd).float()
    v = (u @ params["wv"]).reshape(B, S, H, hd).float()
    xcf = xc.float()
    ig = xcf @ params["w_igate"] + params["b_igate"]
    fg = rules.pointwise(F.logsigmoid,
                         xcf @ params["w_fgate"] + params["b_fgate"])
    return q, k, v, ig, fg


def _head_norm(h: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMS norm per head over hd, then flatten the heads. h: (B, S, H, hd)
    f32."""
    ms = h.square().mean(-1, keepdim=True)
    out = h * torch.rsqrt(ms + eps)
    B, S, H, hd = h.shape
    return out.reshape(B, S, H * hd) * scale.float()


def mlstm_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> MLSTMState:
    H, di = cfg.num_heads, _inner(cfg)
    hd = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        C=torch.zeros((batch, H, hd, hd), **f32),
        n=torch.zeros((batch, H, hd), **f32),
        m=torch.full((batch, H), -torch.inf, **f32),
        conv=torch.zeros((batch, _CONV - 1, di), dtype=dtype, device=device))


def _new_conv(state: MLSTMState, u: torch.Tensor) -> torch.Tensor:
    return torch.cat([state.conv.to(u.dtype), u], dim=1)[:, -(_CONV - 1):]


def _mlstm_chunk(C, n, m, qc, kc, vc, igc, fgc, tri):
    """One chunk of W tokens from the state (C, n, m): (C, n, m, h (B, W,
    H, hd))."""
    b = torch.cumsum(fgc, dim=1)                          # cumulative log decay
    b_tot = b[:, -1]                                      # (B, H)
    # intra-chunk log weights D[t, s] = b_t - b_s + i_s for s <= t
    Dts = b[:, :, None, :] - b[:, None, :, :] + igc[:, None, :, :]
    Dts = torch.where(tri[None, :, :, None], Dts, -torch.inf)
    m_intra = Dts.amax(2)                                 # (B, W, H)
    m_state = m[:, None, :] + b                           # (B, W, H)
    m_t = torch.maximum(m_state, m_intra)
    m_t = torch.where(torch.isneginf(m_t), 0.0, m_t)      # all-empty guard
    w_state = torch.exp(m_state - m_t)                    # (B, W, H)
    h_inter = torch.einsum("bwhd,bhde->bwhe", qc, C) * w_state[..., None]
    n_inter = torch.einsum("bwhd,bhd->bwh", qc, n) * w_state
    P = torch.exp(Dts - m_t[:, :, None, :])               # (B, t, s, H)
    qk = torch.einsum("bthd,bshd->btsh", qc, kc)
    h_intra = torch.einsum("btsh,btsh,bshe->bthe", P, qk, vc)
    n_intra = torch.einsum("btsh,btsh->bth", P, qk)
    num = h_inter + h_intra
    den = torch.maximum((n_inter + n_intra).abs(), torch.exp(-m_t))
    h_out = num / den[..., None]
    # ---- state handoff ----
    decay_s = igc + (b_tot[:, None, :] - b)               # (B, W, H)
    m_new = torch.maximum(m + b_tot, decay_s.amax(1))
    w_old = torch.exp(m + b_tot - m_new)
    w_src = torch.exp(decay_s - m_new[:, None, :])
    C = w_old[..., None, None] * C + \
        torch.einsum("bwh,bwhd,bwhe->bhde", w_src, kc, vc)
    n = w_old[..., None] * n + torch.einsum("bwh,bwhd->bhd", w_src, kc)
    return C, n, m_new, h_out


def mlstm_chunkwise(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    state: MLSTMState | None = None, chunk: int = 256,
                    return_state: bool = False):
    """Chunkwise-parallel mLSTM. x: (B, S, D) -> (B, S, D) [, final state].
    Chunks of W = min(chunk, S) tokens; S must be a multiple of W (raises
    otherwise, never pads)."""
    B, S, _ = x.shape
    H, di = cfg.num_heads, _inner(cfg)
    hd = di // H
    W = min(chunk, S)
    if S % W:
        raise ValueError(f"mlstm_chunkwise: sequence length {S} is not a "
                         f"multiple of the chunk {W}")
    NC = S // W
    u, z = _mlstm_up(params, x)
    xc = _conv_seq(params, u, None if state is None else state.conv)
    q, k, v, ig, fg = _qkv_gates_from(params, cfg, u, xc)
    if state is None:
        st = mlstm_init_state(cfg, B, x.dtype, x.device)
        state = MLSTMState(*(rules.whole_like(t, x)
                             for t in (st.C, st.n, st.m, st.conv)))
    chunks = [a.reshape(B, NC, W, *a.shape[2:]) for a in (q, k, v, ig, fg)]
    tri = rules.whole_like(torch.tril(torch.ones(
        (W, W), dtype=torch.bool, device=x.device)), x)
    C, n, m = state.C, state.n, state.m
    hs = []
    for c in range(NC):
        C, n, m, h = _mlstm_chunk(C, n, m, *(a[:, c] for a in chunks), tri)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, S, H, hd)
    out = _head_norm(h, params["out_norm"]).to(x.dtype)
    out = (out * F.silu(z)) @ params["down_proj"]
    if return_state:
        return out, MLSTMState(C, n, m, _new_conv(state, u))
    return out


def mlstm_decode_step(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      state: MLSTMState):
    """x: (B, D) -> (out (B, D), new state). Exact recurrent step."""
    u, z = _mlstm_up(params, x[:, None, :])                # (B, 1, di)
    xc = _conv_seq(params, u, state.conv)                  # conv window exact
    q, k, v, ig, fg = _qkv_gates_from(params, cfg, u, xc)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                    # (B, H, hd) f32
    ig, fg = ig[:, 0], fg[:, 0]                            # (B, H)
    m_new = torch.maximum(fg + state.m, ig)
    fprime = torch.exp(fg + state.m - m_new)
    iprime = torch.exp(ig - m_new)
    # the JAX package's einsums "bhd,bhe->bhde", "bhd,bhde->bhe" and
    # "bhd,bhd->bh" as the outer product and batched matmuls they lower to
    C = fprime[..., None, None] * state.C + \
        iprime[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = fprime[..., None] * state.n + iprime[..., None] * k
    qr = q[..., None, :]                                   # (B, H, 1, hd)
    num = (qr @ C)[..., 0, :]
    den = torch.maximum((qr @ n[..., None])[..., 0, 0].abs(),
                        torch.exp(-m_new))
    h = num / den[..., None]                               # (B, H, hd)
    hn = _head_norm(h[:, None], params["out_norm"])[:, 0].to(x.dtype)
    out = (hn * F.silu(z[:, 0])) @ params["down_proj"]
    return out, MLSTMState(C, n, m_new, _new_conv(state, u))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg.dtype)
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    di = _inner(cfg)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    w_gates = dense_init(gen, D, 4 * D, dt)                # z, i, f, o stacked
    r = {name: torch.randn((H, hd, hd), generator=gen, **f32) / math.sqrt(hd)
         for name in ("r_z", "r_i", "r_f", "r_o")}
    return {
        "w_gates": w_gates,
        "b_gates": torch.cat([torch.zeros((2 * D,), **f32),
                              torch.full((D,), 3.0, **f32),  # forget bias
                              torch.zeros((D,), **f32)]),
        **r,
        "out_norm": torch.ones((D,), dtype=dt, device=dev),
        "up_proj": dense_init(gen, D, 2 * di, dt),
        "down_proj": dense_init(gen, di, D, dt),
    }


def _recurrent_weights(params: dict) -> torch.Tensor:
    """The four gates' per-head recurrent matrices side by side: (H, hd,
    4 hd)."""
    return torch.cat([params[k] for k in ("r_z", "r_i", "r_f", "r_o")], -1)


def _slstm_cell(params: dict, cfg: ModelConfig, wx_t: torch.Tensor,
                state: SLSTMState, R: torch.Tensor) -> SLSTMState:
    """One sLSTM step. wx_t: (B, 4D) precomputed input contribution; R:
    :func:`_recurrent_weights`, so that the four recurrent products (the
    JAX package's einsum "bhd,hde->bhe" per gate) are one batched
    matmul."""
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    B = wx_t.shape[0]
    rec = torch.bmm(state.h.reshape(B, H, hd).transpose(0, 1), R)
    rz, ri, rf, ro = rec.reshape(H, B, 4, hd).permute(2, 1, 0, 3).reshape(
        4, B, D).unbind(0)                                  # each (B, D)
    z_in, i_in, f_in, o_in = (wx_t.float() + params["b_gates"]).chunk(4, -1)
    z = torch.tanh(z_in + rz)
    ig = i_in + ri                                          # log-space
    fg = rules.pointwise(F.logsigmoid, f_in + rf)
    o = torch.sigmoid(o_in + ro)
    m_new = torch.maximum(fg + state.m, ig)
    iprime = torch.exp(ig - m_new)
    fprime = torch.exp(fg + state.m - m_new)
    c = fprime * state.c + iprime * z
    n = fprime * state.n + iprime
    h = o * c / n.clamp_min(1e-6)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm_init_state(cfg: ModelConfig, batch: int, device=None
                     ) -> SLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    shape = (batch, cfg.d_model)
    return SLSTMState(c=torch.zeros(shape, **f32), n=torch.zeros(shape, **f32),
                      h=torch.zeros(shape, **f32),
                      m=torch.full(shape, -torch.inf, **f32))


def _slstm_out(params: dict, cfg: ModelConfig, h_seq: torch.Tensor, x_dtype):
    """Head-group norm + gated up/down FFN. h_seq: (B, S, D) f32."""
    B, S, D = h_seq.shape
    H = cfg.num_heads
    hf = h_seq.reshape(B, S, H, D // H)
    ms = hf.square().mean(-1, keepdim=True)
    hn = (hf * torch.rsqrt(ms + 1e-6)).reshape(B, S, D)
    hn = (hn * params["out_norm"].float()).to(x_dtype)
    u, g = (hn @ params["up_proj"]).chunk(2, dim=-1)
    return (activation(cfg.act)(g) * u) @ params["down_proj"]


def slstm_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  state: SLSTMState | None = None,
                  return_state: bool = False):
    """Sequential sLSTM over a sequence. x: (B, S, D)."""
    B = x.shape[0]
    wx = x @ params["w_gates"]                             # (B, S, 4D)
    st = state
    if st is None:
        st = slstm_init_state(cfg, B, x.device)
        st = SLSTMState(*(rules.whole_like(t, x)
                          for t in (st.c, st.n, st.h, st.m)))
    R = _recurrent_weights(params)
    hs = []
    # unbind, not wx[:, t]: a select's backward writes a whole zero tensor
    for wx_t in wx.unbind(1):
        st = _slstm_cell(params, cfg, wx_t, st, R)
        hs.append(st.h)
    out = _slstm_out(params, cfg, torch.stack(hs, 1), x.dtype)
    if return_state:
        return out, st
    return out


def slstm_decode_step(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      state: SLSTMState):
    """x: (B, D) -> (out, new state)."""
    st = _slstm_cell(params, cfg, x @ params["w_gates"], state,
                     _recurrent_weights(params))
    out = _slstm_out(params, cfg, st.h[:, None, :], x.dtype)[:, 0]
    return out, st

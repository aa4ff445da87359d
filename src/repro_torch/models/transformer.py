"""Decoder stack: the unified mixed-batch serving step, the one-shot
prefill -> compress -> decode path, and the training forward.

``forward_step`` is the serving hot path, as in the JAX package: up to T
tokens per request in one step (decode rows append 1, prefilling rows a
prompt chunk), written straight into each layer's shared page pool,
attended write-then-attend through block tables, then Alg.3 eviction on
decode rows and incremental Alg.2 compression on prefill rows.

``forward_prefill`` + ``decode_step`` are the paper's own experiment (the
offline / whole-prompt path): a contiguous forward over the whole prompt
(the flash kernel), each layer's K/V compressed to the budget by Alg.2 and
paged (``compress_and_page``), then one token per step under Alg.3.
With ``ac`` the same two loops run over a (data, model) grid, each layer
branching into ``grid_oneshot``'s regions where its work differs.

``forward_train`` gives logits over the whole sequence through plain
autograd attention (``common.causal_attention``), never a kernel, as the
JAX package trains with ``use_pallas=False``; its recurrent layers take
``mamba_forward``, ``mlstm_chunkwise`` and ``slstm_forward``. The serving
and one-shot entry points run under ``torch.no_grad()``: parameters handed
over from the trainer still require grad, and the pools are written in
place.

Layout: the JAX package stacks each pattern slot's parameters over its
repetitions (``pattern``/``tail``) for ``lax.scan``; the port holds a plain
list of layers in depth order (``convert.params_from_jax`` maps one onto the
other) and loops. Caches are in place: the step mutates the layer caches it
is given and returns the same :class:`ModelCache`. Each layer's cache is
the state of its mixer: a ``PagedLayerCache`` for attention, a
``MambaState``, ``MLSTMState`` or ``SLSTMState`` for a recurrent layer (the
JAX package's ``LayerCaches``).

Served: RMSNorm or LayerNorm, qk-norm, global / local / sliding-window
attention layers, mamba, mLSTM and sLSTM layers (plain torch, as the JAX
package's plain jnp: the serving step runs them token by token over the
chunk, ``_scan_recurrent``), a dense gated MLP, an MoE MLP or none per
layer, logit soft-capping. An MoE layer takes the capacity dispatch
(``moe_forward``) over a contiguous sequence (training and the one-shot
prefill) and the dense all-expert combine (``moe_forward_decode``) in the
serving step and one-shot decode, each where the JAX package takes it, so a
MoE model's served and one-shot logits differ as they do there.
Cross-attention (musicgen): each attention layer's self-attention is
followed by a cross-attention block (``norm_x``, ``xattn``) over the static
K/V of the conditioning (``attention.StaticKVCache``, never evicted),
built from ``cond`` by ``forward_prefill`` and ``forward_train``, carried
in ``ModelCache.cross`` beside the layer caches; codebooks take (B, K, S)
tokens, sum the K embeddings and give (..., K, vocab) logits.

As in the JAX package, ``forward_prefill`` gives a recurrent mixer no mask:
a right-padded prompt runs its padding through the recurrence, and the
final state (mamba's conv window too) carries it into decode.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import CacheConfig, LayerSpec, ModelConfig
from repro_torch.core.decode import decode_append
from repro_torch.core.paged_cache import (
    PagedLayerCache,
    adopt_prefix,
    append_chunk,
    append_plan,
    init_layer_cache,
    release_rows,
    row_intact_prefix_pages,
)
from repro_torch.core.policies import EvictionPolicy
from repro_torch.core.prefill import compress_and_page
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import grid_oneshot
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (apply_norm, dtype_of, embed_init,
                                       init_norm, soft_cap)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward, moe_forward_decode
from repro_torch.sharding import rules
from repro_torch.sharding.rules import map_tree, vocab_embedding, whole_like


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

MIXER_INIT = {"attn": attn_mod.init_attention, "mamba": mamba_mod.init_mamba,
              "mlstm": xlstm_mod.init_mlstm, "slstm": xlstm_mod.init_slstm}


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               device) -> dict:
    """{"norm1", mixer ("attn" | "mamba" | "mlstm" | "slstm")[, "xattn",
    "norm_x"][, "norm2", "mlp" | "moe"]} by the layer's spec, as the JAX
    package's ``init_layer`` (an xLSTM layer has no MLP; an attention
    layer of a cross-attention model has the cross-attention block); norms
    follow ``cfg.norm``."""
    dt = dtype_of(cfg.dtype)
    p = {"norm1": init_norm(cfg.norm, cfg.d_model, dt, device),
         spec.mixer: MIXER_INIT[spec.mixer](gen, cfg)}
    if spec.mixer == "attn" and cfg.cross_attention:
        p["xattn"] = attn_mod.init_attention(gen, cfg, cross=True)
        p["norm_x"] = init_norm(cfg.norm, cfg.d_model, dt, device)
    if spec.mlp != "none":
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, dt, device)
        if spec.mlp == "moe":
            p["moe"] = init_moe(gen, cfg)
        else:
            p["mlp"] = init_mlp(gen, cfg)
    return p


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default CUDA; raises without a card; "meta" gives shapes only):
    {"embed", "layers": [...],
    "final_norm"[, "lm_head"]}, embed and lm_head (K, V, D) with K > 1
    codebooks. The draws differ from the JAX package's (tests hand its
    tree over with ``convert.params_from_jax`` instead)."""
    cfg.validate()
    device = resolve_device(device)
    if device.type == "meta":
        # shapes and dtypes only, at any size: the same draws traced on
        # fake tensors, then given as meta tensors
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            fake = init_model(cfg, seed, "cpu")
        return map_tree(fake, lambda t, _: torch.empty(
            t.shape, dtype=t.dtype, device="meta"))
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = dtype_of(cfg.dtype)

    def table():
        if cfg.num_codebooks > 1:
            return torch.stack([embed_init(gen, cfg.vocab_size, cfg.d_model,
                                           dt)
                                for _ in range(cfg.num_codebooks)])
        return embed_init(gen, cfg.vocab_size, cfg.d_model, dt)

    params: dict = {"embed": table()}
    params["layers"] = [init_layer(gen, cfg, spec, device)
                        for spec in cfg.layer_specs()]
    params["final_norm"] = init_norm(cfg.norm, cfg.d_model, dt, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = table()
    return params


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens (B, [S]) -> (B, [S,] D). With K codebooks (embed (K, V, D)),
    tokens (B, K, [S]) -> the sum over k of codebook k's embedding of
    tokens[:, k], as the JAX package's per-codebook ``vmap``."""
    if isinstance(params["embed"], DTensor):
        # a table split over its vocab rows: the gather by rows, summed
        if cfg.num_codebooks == 1:
            return vocab_embedding(params["embed"], tokens)
        return torch.stack([vocab_embedding(params["embed"][k], tokens[:, k])
                            for k in range(cfg.num_codebooks)]).sum(0)
    if cfg.num_codebooks > 1:
        idx = tokens.long().movedim(1, 0)                    # (K, B[, S])
        book = torch.arange(idx.shape[0], device=idx.device)
        return params["embed"][book.view(-1, *[1] * (idx.dim() - 1)),
                               idx].sum(0)
    return params["embed"][tokens.long()]


def lm_logits(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """x: (B, [S,] D) -> f32 logits (B, [S,] vocab), or (B, [S,] K, vocab)
    with K codebooks, soft-capped by ``cfg.logit_soft_cap`` when it is
    set."""
    x = apply_norm(params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if cfg.num_codebooks > 1:
        out = (x @ head.flatten(0, 1).T).unflatten(-1, head.shape[:2])
    else:
        out = x @ head.T
    return soft_cap(out.float(), cfg.logit_soft_cap)


def cross_block(lp: dict, cfg: ModelConfig, x, xc):
    """x (B, S, D) + the cross-attention of norm_x(x) to the conditioning
    K/V ``xc`` (a ``StaticKVCache``); x itself when ``xc`` is None."""
    if xc is None:
        return x
    return x + attn_mod.cross_attention_forward(
        lp["xattn"], cfg, apply_norm(lp["norm_x"], x), xc)


def mlp_block(lp: dict, cfg: ModelConfig, spec: LayerSpec, x,
              dense_combine: bool, group=None, ac=None):
    """The layer's second half: x + MLP(norm2(x)) -> (x, MoE aux loss or
    None). An MoE layer takes the dense all-expert combine over every token
    of x when ``dense_combine`` (the serving step and one-shot decode), else
    the capacity dispatch per example of x (B, S, D) (the one-shot prefill
    and training), as the JAX package's call sites do. A layer without an
    MLP (``spec.mlp == "none"``, xLSTM) passes x through. ``group``: the
    tensor-parallel group of the serving step, whose ranks hold d_ff
    slices (dense MLP or dense combine); their outputs are summed.
    ``ac``: the activation constraint of a grid, handed to the MoE
    block."""
    if spec.mlp == "none":
        return x, None
    h = apply_norm(lp["norm2"], x)
    if spec.mlp != "moe":
        return x + mlp_forward(lp["mlp"], cfg, h, group), None
    if dense_combine:
        out = moe_forward_decode(lp["moe"], cfg, h.reshape(-1, h.shape[-1]),
                                 group, ac=ac)
        return x + out.reshape(h.shape), None
    out, stats = moe_forward(lp["moe"], cfg, h, ac=ac)
    return x + out, stats.aux_loss


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------

def forward_train(params: dict, cfg: ModelConfig, tokens, cond=None,
                  ac=None, remat: bool = True):
    """tokens (B, S) [or (B, K, S) with codebooks] -> (logits (B, S,
    [K,] vocab) f32, aux () f32), as the JAX package's ``forward_train``
    with ``use_pallas=False``: attention by
    :func:`~repro_torch.models.common.causal_attention` on every device.
    ``cond`` (B, cond_len, D): the conditioning of the cross-attention
    layers (None skips those blocks, as in the JAX package).
    ``remat``: recompute each layer in the backward pass
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` of
    the scanned layer), so that autograd keeps one (B, S, D) input per
    layer. ``aux`` is the sum of the MoE layers' load-balance losses (0
    without MoE layers).

    Over a grid (DTensor parameters and tokens, ``sharding.rules``) the
    same code runs on every rank. ``ac`` (``rules.activation_constraint``)
    pins each layer's input, as the JAX package's ``layer_forward`` does,
    and reaches the MoE block (computed on local shards, over the model
    or the expert axes) and the mamba scan."""
    cfg.validate()
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    positions = whole_like(torch.arange(S, dtype=torch.int32,
                                        device=x.device).expand(B, S), x)
    aux = whole_like(torch.zeros((), dtype=torch.float32, device=x.device),
                     x)
    for lp, spec in zip(params["layers"], cfg.layer_specs()):
        def layer(x, lp=lp, spec=spec):
            xc = None if cond is None or "xattn" not in lp else \
                attn_mod.make_cross_cache(lp["xattn"], cfg, cond)
            x, a, _ = layer_forward(lp, cfg, spec, x, positions, cross=xc,
                                    train=True, ac=ac)
            return (x,) if a is None else (x, a)
        out = checkpoint(layer, x, use_reentrant=False) if remat \
            else layer(x)
        x = out[0]
        if len(out) > 1:
            aux = aux + out[1]
    return lm_logits(params, cfg, x), aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

@dataclass
class ModelCache:
    layers: list          # per layer, in depth order: its PagedLayerCache
    #                       or MambaState / MLSTMState / SLSTMState
    cur_pos: torch.Tensor  # (B,) int32: next token position per request
    cross: list | None = None  # per layer: the StaticKVCache over the
    #                            conditioning of a cross-attention layer,
    #                            else None (given as None: no layer has one)

    def __post_init__(self):
        if self.cross is None:
            self.cross = [None] * len(self.layers)


def paged_layers(layers: list) -> list[PagedLayerCache]:
    """The attention layers' page pools among a model's layer caches
    (``ModelCache.layers``), in depth order."""
    return [c for c in layers if isinstance(c, PagedLayerCache)]


# a recurrent mixer's one-token step: (params, cfg, x (B, D), state) ->
# (out (B, D), new state)
RECURRENT_STEP = {"mamba": mamba_mod.mamba_decode_step,
                  "mlstm": xlstm_mod.mlstm_decode_step,
                  "slstm": xlstm_mod.slstm_decode_step}
# a recurrent mixer's whole-prompt forward that also gives its final state:
# (params, cfg, x (B, S, D)) -> (out, state)
RECURRENT_PREFILL = {
    "mamba": mamba_mod.mamba_prefill,
    "mlstm": lambda p, c, x: xlstm_mod.mlstm_chunkwise(p, c, x,
                                                       return_state=True),
    "slstm": lambda p, c, x: xlstm_mod.slstm_forward(p, c, x,
                                                     return_state=True)}


def recurrent_init_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                         dtype, device):
    """A recurrent layer's empty state (``dtype``: the conv windows')."""
    if spec.mixer == "mamba":
        return mamba_mod.mamba_init_state(cfg, batch, dtype, device)
    if spec.mixer == "mlstm":
        return xlstm_mod.mlstm_init_state(cfg, batch, dtype, device)
    return xlstm_mod.slstm_init_state(cfg, batch, device)


def _assign(state, new) -> None:
    """Write ``new``'s fields into the recurrent ``state`` in place."""
    for f in fields(state):
        getattr(state, f.name).copy_(getattr(new, f.name))


def _layer_cache_shapes(cfg: ModelConfig, spec: LayerSpec, seq_len: int,
                        policy: EvictionPolicy, ccfg: CacheConfig,
                        chunk_tokens: int = 0) -> int:
    """Block-table width of one layer (window-aware): the policy's slab,
    plus ceil(chunk / page) slots of chunked-prefill headroom."""
    window = attn_mod.spec_window(cfg, spec)
    hint = seq_len if not window else min(seq_len, window + ccfg.page_size)
    pages = policy.slab_pages(ccfg, hint)
    if chunk_tokens:
        total = -(-seq_len // ccfg.page_size)
        extra = -(-chunk_tokens // ccfg.page_size)
        pages = policy._round_slab(ccfg, min(pages + extra, max(total, pages)))
    return pages


def init_decode_caches(cfg: ModelConfig, batch: int, seq_len: int,
                       policy: EvictionPolicy, ccfg: CacheConfig, dtype=None,
                       chunk_tokens: int = 0, track_stats: bool = False,
                       device=None, tp: int = 1) -> ModelCache:
    """Empty per-layer caches on ``device`` (default CUDA; raises without a
    card): a page pool (N = batch * P pages) per attention layer,
    ``ccfg.dtype`` "int8" making quantized pools, and an empty state per
    recurrent layer; with cross-attention, each attention layer's
    conditioning K/V, zero (B, cond_len, KV, hd), in ``cache.cross``. A
    recurrent state and the conditioning K/V take the model's dtype, never
    the pools': a recurrent one-token step returns the conv window in the
    activations' dtype, which an int8 state would truncate, and
    ``make_cross_cache`` gives the activations' dtype (the JAX package's
    carry the pools' dtype and run only where that is the
    activations'). ``tp``: the pools of one rank of tensor-parallel
    serving, KV/tp heads each (the metadata whole)."""
    cfg.validate()
    device = resolve_device(device)
    dt = dtype or dtype_of(ccfg.dtype)
    act = dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim
    layers = [
        init_layer_cache(batch, _layer_cache_shapes(cfg, spec, seq_len,
                                                    policy, ccfg,
                                                    chunk_tokens),
                         ccfg.page_size, cfg.num_kv_heads // tp, hd, dt,
                         track_stats=track_stats, device=device)
        if spec.mixer == "attn" else
        recurrent_init_state(cfg, spec, batch, act, device)
        for spec in cfg.layer_specs()]
    cross = None
    if cfg.cross_attention:
        zeros = lambda: torch.zeros(  # noqa: E731
            (batch, cfg.cond_len, cfg.num_kv_heads, hd), dtype=act,
            device=device)
        cross = [attn_mod.StaticKVCache(k=zeros(), v=zeros())
                 if spec.mixer == "attn" else None
                 for spec in cfg.layer_specs()]
    return ModelCache(layers=layers,
                      cur_pos=torch.zeros((batch,), dtype=torch.int32,
                                          device=device),
                      cross=cross)


# ---------------------------------------------------------------------------
# unified mixed-batch step
# ---------------------------------------------------------------------------

def _scan_recurrent(step_fn, state, init_state, h_seq, n_tok, reset_mask,
                    n_host):
    """Run a one-token step over a (B, T, D) chunk, token by token, as the
    JAX package's ``_scan_recurrent``: rows past their ``n_tok`` freeze
    their state and emit zeros; ``reset_mask`` rows (None: no row) start
    from ``init_state`` (a slot handed to a new request; an xLSTM state is
    not all zero: its stabilizer m starts at -inf; unused without
    ``reset_mask``). ``state`` is updated in place, like the pools. Returns
    the outputs (B, T, D).

    ``n_host``, a host copy of ``n_tok``, spares the tokens past the
    longest row (every row frozen, zero outputs): they are not run."""
    B, T = h_seq.shape[:2]
    n_run = int(n_host.max())

    def rows(mask, a):
        return mask.reshape((B,) + (1,) * (a.ndim - 1))

    def select(mask, new, old):
        return type(old)(**{f.name: torch.where(
            rows(mask, getattr(old, f.name)), getattr(new, f.name),
            getattr(old, f.name)) for f in fields(old)})

    st = state
    if reset_mask is not None:
        st = select(reset_mask, type(init_state)(**{
            f.name: getattr(init_state, f.name).to(getattr(st, f.name).dtype)
            for f in fields(st)}), st)
    act = torch.arange(T, device=h_seq.device)[:, None] < n_tok[None, :]
    outs = []
    for t, h_t in enumerate(h_seq.unbind(1)[:n_run]):
        out, new = step_fn(h_t, st)
        st = select(act[t], new, st)
        outs.append(torch.where(act[t][:, None], out, 0.0))
    if n_run < T:
        outs += [torch.zeros_like(h_seq[:, 0])] * (T - n_run)
    _assign(state, st)
    return torch.stack(outs, 1)


def _step_recurrent(lp: dict, cfg: ModelConfig, spec: LayerSpec, x, state,
                    n_tok, reset_mask, n_host):
    """One recurrent layer (mamba, mLSTM or sLSTM) + its MLP, if any, of
    the unified step; ``state`` updated in place. ``n_host``: the host
    copy of ``n_tok``."""
    h = apply_norm(lp["norm1"], x)
    step = RECURRENT_STEP[spec.mixer]
    init = None if reset_mask is None else recurrent_init_state(
        cfg, spec, x.shape[0], x.dtype, x.device)
    m = _scan_recurrent(
        lambda h_t, st: step(lp[spec.mixer], cfg, h_t, st), state, init, h,
        n_tok, reset_mask, n_host)
    return mlp_block(lp, cfg, spec, x + m, dense_combine=True)[0]


def _step_layer(lp: dict, cfg: ModelConfig, spec: LayerSpec, x, kvc, xc, *,
                positions, n_tok, policy: EvictionPolicy, ccfg: CacheConfig,
                decode_mask, prefill_mask, reset_mask, share_src, share_pages,
                times: list[int], has_decode: bool, has_prefill: bool,
                has_reset: bool, decode_splits: int, fused_scores: bool,
                plain_kernels: bool, want_taps: bool = False, group=None):
    """One attention (+ cross-attention to ``xc`` when not None) + MLP
    layer of the unified step. x: (B, T, D);
    positions: (B, T) int32 with -1 past each row's ``n_tok``. The
    ``has_*`` flags come from host copies of the masks and skip hooks that
    would be identities (the JAX package skips them under ``lax.cond``).
    Returns (x, tap): with ``want_taps`` (the regret shadow probes,
    obs/regret.py) tap holds this step's k and v, the q used, the attention
    output before the projection, and ``live_pos``, the cache's positions
    after the append and before the eviction (a gathered copy: the eviction
    mutates the pool in place); else tap is None and nothing more runs.
    ``group``: the tensor-parallel group (this rank's heads, pool and d_ff
    slice); ``o @ wo`` is summed over its ranks before the residual, as the
    MLP's output is."""
    B, T, _ = x.shape
    h = apply_norm(lp["norm1"], x)
    q, k, v = attn_mod.project_qkv(lp["attn"], cfg, h,
                                   positions.clamp_min(0))
    if kvc.stats is not None:
        kvc.stats.zero_()
    if has_reset:
        release_rows(kvc, reset_mask)
        adopt_prefix(kvc, share_src, share_pages, enable=reset_mask)
    score = policy.write_score(k, v, positions)
    append_chunk(kvc, k, v, positions, score, n_tok, times=times)
    window = attn_mod.spec_window(cfg, spec)
    o, pscores = attn_mod.step_attention(
        q, kvc, q_pos=positions, window=window, decode_splits=decode_splits,
        want_scores=fused_scores, plain=plain_kernels, group=group)
    tap = None
    if want_taps:
        tap = {"k": k, "v": v, "q": q, "o": o, "live_pos": kvc.pos_view()}
    if has_decode:
        policy.post_write(kvc, ccfg, active=decode_mask, page_scores=pscores)
    if has_prefill:
        policy.chunk_prefill_evict(kvc, ccfg, active=prefill_mask,
                                   window=window, page_scores=pscores)
    o = o.reshape(B, T, -1) @ lp["attn"]["wo"]
    if group is not None:
        o = group.all_reduce_sum(o)
    x = cross_block(lp, cfg, x + o, xc)
    return mlp_block(lp, cfg, spec, x, dense_combine=True,
                     group=group)[0], tap


@torch.no_grad()
def forward_step(params: dict, cfg: ModelConfig, tokens, n_tok,
                 cache: ModelCache, policy: EvictionPolicy, ccfg: CacheConfig,
                 decode_mask=None, prefill_mask=None, reset_mask=None,
                 share_src=None, share_pages=None, decode_splits: int = 1,
                 fused_scores: bool = False, plain_kernels: bool = False,
                 want_taps: bool = False, group=None):
    """Unified mixed-batch step, as ``transformer.forward_step`` of the JAX
    package. tokens (B, T) int32 (row b's live tokens are tokens[b,
    :n_tok[b]]), or (B, K, T) with K codebooks; n_tok (B,); the masks
    (B,) bool; share_src / share_pages (B,) int32 prefix-sharing
    adoptions on reset rows. ``fused_scores``:
    rank page eviction by the kernels' norm epilogue. ``plain_kernels``:
    run the kernels' plain versions on the card (a test switch).

    Updates ``cache`` in place and returns (logits (B, [K,] vocab) f32 at
    each row's last live token, cache); a cross-attention layer attends to
    its ``cache.cross`` K/V. One host read per step: the attention
    layers' write heads and the masks, from which each attention layer's
    page-boundary plan for ``append_chunk`` is computed. A recurrent layer
    runs its one-token step over the chunk (:func:`_scan_recurrent`).
    ``want_taps`` (obs/regret.py) also returns the taps {"layers":
    [per-layer tap of :func:`_step_layer`, None for a recurrent layer],
    "positions": (B, T)} as a third value; False runs exactly the ops of a
    step without it.

    ``group`` (a ``launch.mesh.TPGroup``): tensor-parallel serving, the
    step of one rank; ``params`` and ``cache`` are its shards
    (``sharding.rules``), every other input whole, and ``policy`` built
    with the same group. Every rank must take the same branches, so that
    they issue the same collectives in the same order: the ``has_*`` flags
    and the page plans come from the replicated metadata and masks."""
    x = embed_tokens(params, cfg, tokens)
    B, T = x.shape[0], x.shape[1]
    dev = x.device
    if decode_mask is None:
        decode_mask = torch.zeros((B,), dtype=torch.bool, device=dev)
    if prefill_mask is None:
        prefill_mask = (n_tok > 0) & ~decode_mask
    if reset_mask is None:
        reset_mask = torch.zeros((B,), dtype=torch.bool, device=dev)
    if share_src is None:
        share_src = torch.full((B,), -1, dtype=torch.int32, device=dev)
    if share_pages is None:
        share_pages = torch.zeros((B,), dtype=torch.int32, device=dev)
    page = ccfg.page_size
    cur_pos = torch.where(reset_mask, share_pages * page, cache.cur_pos)
    t = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    positions = torch.where(t < n_tok[:, None], cur_pos[:, None] + t, -1)

    # the one host read: the attention layers' heads and the step's masks
    pools = paged_layers(cache.layers)
    host = torch.cat([torch.stack([c.cur_off, c.head_mapped().int()])
                      .reshape(-1) for c in pools] +
                     [n_tok.int(), decode_mask.int(), prefill_mask.int(),
                      reset_mask.int()]).cpu().numpy()
    L = len(pools)
    heads = iter(host[:2 * B * L].reshape(L, 2, B))
    n_h, dec_h, pre_h, reset_h = host[2 * B * L:].reshape(4, B)
    flags = dict(has_decode=bool(dec_h.any()), has_prefill=bool(pre_h.any()),
                 has_reset=bool(reset_h.any()))
    taps = []
    for lp, spec, kvc, xc in zip(params["layers"], cfg.layer_specs(),
                                 cache.layers, cache.cross):
        if spec.mixer != "attn":
            x = _step_recurrent(lp, cfg, spec, x, kvc, n_tok,
                                reset_mask if flags["has_reset"] else None,
                                n_h)
            taps.append(None)
            continue
        off, mapped = next(heads)
        # release / adopt park a reset row's head full: it rolls at t == 0
        off = np.where(reset_h > 0, page, off)
        times = append_plan(kvc, off, mapped, n_h, T)
        x, tap = _step_layer(lp, cfg, spec, x, kvc, xc, positions=positions,
                             n_tok=n_tok, policy=policy, ccfg=ccfg,
                             decode_mask=decode_mask,
                             prefill_mask=prefill_mask,
                             reset_mask=reset_mask, share_src=share_src,
                             share_pages=share_pages, times=times,
                             decode_splits=decode_splits,
                             fused_scores=fused_scores,
                             plain_kernels=plain_kernels,
                             want_taps=want_taps, group=group, **flags)
        taps.append(tap)
    last = (n_tok.long() - 1).clamp_min(0)
    x_last = x[torch.arange(B, device=dev), last]
    logits = lm_logits(params, cfg, x_last)
    cache.cur_pos = cur_pos + n_tok.to(torch.int32)
    if want_taps:
        return logits, cache, {"layers": taps, "positions": positions}
    return logits, cache


def collect_step_stats(cache: ModelCache):
    """Sum every attention layer's devstats vector -> (NSTATS,) int32, or
    None when the caches do not track stats (or there is no attention
    layer). Call after the step."""
    vecs = [c.stats for c in paged_layers(cache.layers)
            if c.stats is not None]
    if not vecs:
        return None
    return torch.stack(vecs).sum(0, dtype=torch.int32)


def intact_prefix_pages(cache: ModelCache, row: int) -> torch.Tensor:
    """() int32: leading full prompt pages of batch row ``row`` intact in
    EVERY attention layer (min over them): the device half of the
    prefix-sharing admission probe. 0 when no layer is attention (a
    recurrent state cannot be adopted page-wise)."""
    runs = [row_intact_prefix_pages(c, row)
            for c in paged_layers(cache.layers)]
    if not runs:
        return torch.zeros((), dtype=torch.int32, device=cache.cur_pos.device)
    return torch.stack(runs).min()


# ---------------------------------------------------------------------------
# one-shot path: contiguous prefill that builds the paged caches, then
# single-token decode steps
# ---------------------------------------------------------------------------

def layer_forward(lp: dict, cfg: ModelConfig, spec: LayerSpec, x, positions,
                  plain_kernels: bool = False, train: bool = False,
                  return_state: bool = False, cross=None, ac=None):
    """One layer (mixer [+ cross-attention to ``cross``, a
    ``StaticKVCache``, when given] + MLP) over a contiguous sequence.
    Returns (x, MoE aux loss or None, extras): extras is (k, v) with k
    post-RoPE for attention, the final recurrent state of a recurrent
    mixer when ``return_state`` (``mamba_prefill``, ``mlstm_chunkwise`` or
    ``slstm_forward`` returning it; else ``mamba_forward`` and the others
    without it, and None). ``train``: attention by the training route
    (``attention_forward``'s), never a kernel. ``ac``: the activation
    constraint over a grid, which pins x first and reaches the attention,
    mamba and MoE blocks (a recurrent mixer's final state:
    ``grid_oneshot.recurrent_prefill``)."""
    if ac is not None:
        x = ac(x)
    h = apply_norm(lp["norm1"], x)
    extras = None
    if spec.mixer == "attn":
        a, extras = attn_mod.attention_forward(lp["attn"], cfg, spec, h,
                                               positions, plain=plain_kernels,
                                               train=train, ac=ac)
    elif return_state:
        fn = RECURRENT_PREFILL[spec.mixer]
        a, extras = fn(lp[spec.mixer], cfg, h) if ac is None else \
            grid_oneshot.recurrent_prefill(fn, lp[spec.mixer], cfg, h, ac)
    elif spec.mixer == "mamba":
        a = mamba_mod.mamba_forward(lp["mamba"], cfg, h, ac=ac)
    else:
        fwd = (xlstm_mod.mlstm_chunkwise if spec.mixer == "mlstm" else
               xlstm_mod.slstm_forward)
        a = fwd(lp[spec.mixer], cfg, h)
    x = cross_block(lp, cfg, x + a, cross)
    x, aux = mlp_block(lp, cfg, spec, x, dense_combine=False, ac=ac)
    return x, aux, extras


def _on_grid(ac, t):
    """A plain input ``t`` (the same on every rank) split over the batch
    axes of ``ac``'s grid; ``t`` itself without a grid or as a DTensor."""
    if ac is None or t is None or isinstance(t, DTensor):
        return t
    return rules.place(ac.grid, t, (ac.batch_axes,) + (None,) * (t.dim() - 1))


def _prefill_layer(lp: dict, cfg: ModelConfig, spec: LayerSpec, x, positions,
                   valid, cond, policy: EvictionPolicy, ccfg: CacheConfig,
                   seq_len_hint: int, plain_kernels: bool, ac=None):
    """Layer forward that also builds its decode cache: Alg.2 and paging
    for attention, the final state for a recurrent mixer (which sees no
    ``valid`` mask, as in the JAX package). Returns (x, the layer's cache,
    its conditioning K/V from ``cond`` or None). Over a grid (``ac``) the
    compression and paging run as ``grid_oneshot.compress_and_page`` and
    the caches come out laid out by ``rules.cache_shardings``."""
    if spec.mixer != "attn":
        x, _, state = layer_forward(lp, cfg, spec, x, positions,
                                    return_state=True, ac=ac)
        return x, state, None
    xc = None if cond is None or "xattn" not in lp else \
        attn_mod.make_cross_cache(lp["xattn"], cfg, cond)
    x, _, (k, v) = layer_forward(lp, cfg, spec, x, positions, plain_kernels,
                                 cross=xc, ac=ac)
    window = attn_mod.spec_window(cfg, spec)
    hint = seq_len_hint if not window else min(seq_len_hint,
                                               window + ccfg.page_size)
    kv_valid = valid
    if window:
        # windowed layers never attend past the window again: drop the
        # out-of-window tokens at paging time (keeps the slab small)
        cur = torch.where(valid, positions, -1).amax(-1, keepdim=True)
        kv_valid = valid & (positions > cur - window)
    if ac is None:
        cache = compress_and_page(k, v, positions, kv_valid, policy, ccfg,
                                  seq_len_hint=hint,
                                  cache_dtype=dtype_of(ccfg.dtype))
    else:
        cache = grid_oneshot.compress_and_page(
            cfg, k, v, positions, kv_valid, policy, ccfg, hint,
            dtype_of(ccfg.dtype), ac)
        if xc is not None:
            xc = grid_oneshot.place_cross(cfg, xc, ac)
    return x, cache, xc


def _last_valid(x, valid, ac):
    """(x at each row's last valid token (B, D), valid tokens per row (B,)
    int32); over a grid picked on each rank's rows."""
    if ac is not None:
        b = ac.batch_axes
        x = rules.to_local(ac.grid, x, (b, None, None))
        valid = rules.to_local(ac.grid, valid, (b, None))
    n_valid = valid.sum(-1, dtype=torch.int32)
    last = (n_valid.long() - 1).clamp_min(0)
    x_last = x[torch.arange(x.shape[0], device=x.device), last]
    if ac is not None:
        x_last = rules.from_local(ac.grid, x_last, (b, None))
        n_valid = rules.from_local(ac.grid, n_valid, (b,))
    return x_last, n_valid


@torch.no_grad()
def forward_prefill(params: dict, cfg: ModelConfig, tokens,
                    policy: EvictionPolicy, ccfg: CacheConfig, valid=None,
                    total_seq_hint: int | None = None,
                    plain_kernels: bool = False, cond=None, ac=None):
    """Process whole prompts, compress each layer's K/V by Alg.2 and page
    it (a recurrent layer keeps its final state): tokens (B, S) int32, or
    (B, K, S) with K codebooks; ``cond`` (B, cond_len, D): the
    conditioning, whose K/V each cross-attention layer builds and keeps in
    ``cache.cross`` (None: those blocks are skipped, as in the JAX
    package); ``valid`` (B, S) bool marks right-padded prompts' real
    tokens (the attention layers' only: a recurrent mixer runs the padding
    too, as in the JAX package). ``total_seq_hint``: expected prompt +
    generation length, which sizes the page slabs (default S). The caches
    live on ``tokens``' device. Returns (last valid token's logits (B,
    vocab) f32, or (B, K, vocab) with codebooks, and the ModelCache).

    ``ac`` (``rules.activation_constraint``): the prefill over a grid, the
    parameters DTensors placed by ``rules.param_shardings``, each layer's
    input pinned by ``ac``, attention and compression as regions on local
    shards (``grid_oneshot``); the logits come out a DTensor."""
    cfg.validate()
    x = embed_tokens(params, cfg, _on_grid(ac, tokens))
    B, S = x.shape[0], x.shape[1]
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    if valid is None:
        valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    positions, valid, cond = (_on_grid(ac, t)
                              for t in (positions, valid, cond))
    positions = torch.where(valid, positions, -1)
    hint = total_seq_hint or S
    layers, cross = [], []
    for lp, spec in zip(params["layers"], cfg.layer_specs()):
        x, c, xc = _prefill_layer(lp, cfg, spec, x, positions, valid, cond,
                                  policy, ccfg, hint, plain_kernels, ac)
        layers.append(c)
        cross.append(xc)
    x_last, n_valid = _last_valid(x, valid, ac)
    logits = lm_logits(params, cfg, x_last)
    return logits, ModelCache(layers=layers, cur_pos=n_valid, cross=cross)


def _decode_layer(lp: dict, cfg: ModelConfig, spec: LayerSpec, x, kvc, xc,
                  cur_pos, policy: EvictionPolicy, ccfg: CacheConfig, active,
                  decode_splits: int, fused_scores: bool,
                  plain_kernels: bool, ac=None):
    """One layer, one token. x: (B, D). A recurrent layer steps every row,
    ``active`` or not, as the JAX package's ``_decode_layer`` does; an
    attention layer with conditioning K/V ``xc`` attends to it after its
    self-attention. Returns (x, the layer's cache): the same cache updated
    in place, or over a grid (``ac``, x pinned first) its new layout, the
    attention with the pool's bookkeeping and the recurrent mixer run as
    regions on local shards (``grid_oneshot``)."""
    if ac is not None:
        x = ac(x)
    h = apply_norm(lp["norm1"], x)
    if spec.mixer != "attn":
        if ac is None:
            m, new = RECURRENT_STEP[spec.mixer](lp[spec.mixer], cfg, h, kvc)
            _assign(kvc, new)
        else:
            m, kvc = grid_oneshot.recurrent_decode(
                RECURRENT_STEP[spec.mixer], lp[spec.mixer], cfg, h, kvc, ac)
        return mlp_block(lp, cfg, spec, x + m, dense_combine=True,
                         ac=ac)[0], kvc
    window = attn_mod.spec_window(cfg, spec)
    if kvc.stats is not None:
        kvc.stats.zero_()
    if ac is None:
        q, k, v = attn_mod.decode_project_qkv(lp["attn"], cfg, h, cur_pos)
        out = []

        def attend(c):
            o, pscores = attn_mod.decode_attention(
                q, c, cur_pos=cur_pos, window=window,
                num_splits=decode_splits, want_scores=fused_scores,
                plain=plain_kernels)
            out.append(o)
            return pscores

        decode_append(kvc, k, v, cur_pos, policy, ccfg, active=active,
                      attend=attend)
        m = out[0].reshape(x.shape[0], -1) @ lp["attn"]["wo"]
    else:
        m, kvc = grid_oneshot.decode_attention(
            lp["attn"], cfg, h, kvc, cur_pos, active, policy, ccfg, window,
            decode_splits, plain_kernels, ac)
    x = x + m
    if xc is not None:
        x = cross_block(lp, cfg, x[:, None], xc)[:, 0]
    return mlp_block(lp, cfg, spec, x, dense_combine=True, ac=ac)[0], kvc


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, tokens, cache: ModelCache,
                policy: EvictionPolicy, ccfg: CacheConfig, active=None,
                decode_splits: int = 1, fused_scores: bool = False,
                plain_kernels: bool = False, ac=None):
    """One decode step of every request: tokens (B,) [or (B, K) with K
    codebooks] -> (logits (B, [K,] vocab) f32, cache), the cache updated in
    place. ``active`` (B,) bool: rows that take a token. ``decode_splits``
    / ``fused_scores`` / ``plain_kernels``: see :func:`forward_step`.
    ``ac``: the step over a grid, the cache laid out by
    ``rules.place_cache`` or from a grid ``forward_prefill``; its layer
    caches are replaced by their new layouts. ``fused_scores`` over a grid
    raises: a rank holding part of a KV head's query group would count
    its norms twice."""
    if ac is not None and fused_scores:
        raise NotImplementedError(
            "fused_scores over a grid: a rank holding part of a KV head's "
            "query group would count its norms twice; rank pages by the "
            "stored scores")
    x = embed_tokens(params, cfg, _on_grid(ac, tokens))
    if active is None:
        active = torch.ones((x.shape[0],), dtype=torch.bool,
                            device=x.device)
    active = _on_grid(ac, active)
    cur_pos = cache.cur_pos
    for i, (lp, spec, xc) in enumerate(zip(params["layers"],
                                           cfg.layer_specs(), cache.cross)):
        x, cache.layers[i] = _decode_layer(
            lp, cfg, spec, x, cache.layers[i], xc, cur_pos, policy, ccfg,
            active, decode_splits, fused_scores, plain_kernels, ac)
    logits = lm_logits(params, cfg, x)
    cache.cur_pos = torch.where(active, cur_pos + 1, cur_pos)
    if ac is not None:
        cache.cur_pos = rules.place(ac.grid, cache.cur_pos, (ac.batch_axes,))
    return logits, cache

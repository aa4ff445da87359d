"""Decoder stack: the unified mixed-batch serving step and the one-shot
prefill -> compress -> decode path.

``forward_step`` is the serving hot path, as in the JAX package: up to T
tokens per request in one step (decode rows append 1, prefilling rows a
prompt chunk), written straight into each layer's shared page pool,
attended write-then-attend through block tables, then Alg.3 eviction on
decode rows and incremental Alg.2 compression on prefill rows.

``forward_prefill`` + ``decode_step`` are the paper's own experiment (the
offline / whole-prompt path): a contiguous forward over the whole prompt
(the flash kernel), each layer's K/V compressed to the budget by Alg.2 and
paged (``compress_and_page``), then one token per step under Alg.3.

Layout: the JAX package stacks each pattern slot's parameters over its
repetitions (``pattern``/``tail``) for ``lax.scan``; the port holds a plain
list of layers in depth order (``convert.params_from_jax`` maps one onto the
other) and loops. Caches are in place: the step mutates the layer caches it
is given and returns the same :class:`ModelCache`.

This slice serves dense pure-attention stacks (RMSNorm, attention, SwiGLU
MLP); ``check_supported`` rejects the rest.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import CacheConfig, LayerSpec, ModelConfig
from repro_torch.core.decode import decode_append
from repro_torch.core.paged_cache import (
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
from repro_torch.models.common import (apply_norm, dtype_of, embed_init,
                                       init_norm)
from repro_torch.models.mlp import init_mlp, mlp_forward


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of a config this slice does not serve yet."""
    cfg.validate()
    missing = []
    if any(s.mixer != "attn" or s.mlp != "dense" for s in cfg.layer_specs()):
        missing.append("non-attention mixers / MoE MLPs")
    if cfg.qk_norm:
        missing.append("qk-norm")
    if cfg.cross_attention:
        missing.append("cross-attention")
    if cfg.num_codebooks > 1:
        missing.append("codebooks")
    if cfg.norm != "rmsnorm" or cfg.act != "silu":
        missing.append(f"{cfg.norm} / {cfg.act}")
    if cfg.logit_soft_cap:
        missing.append("logit soft-capping")
    if missing:
        raise NotImplementedError(f"{cfg.name}: the torch port does not "
                                  f"serve {', '.join(missing)} yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default CUDA; raises without a card): {"embed", "layers": [...],
    "final_norm"[, "lm_head"]}. The draws differ from the JAX package's
    (tests hand its tree over with ``convert.params_from_jax`` instead)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = dtype_of(cfg.dtype)
    params: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt)}
    params["layers"] = [
        {"norm1": init_norm(cfg.d_model, dt, device),
         "attn": attn_mod.init_attention(gen, cfg),
         "norm2": init_norm(cfg.d_model, dt, device),
         "mlp": init_mlp(gen, cfg)}
        for _ in range(cfg.num_layers)]
    params["final_norm"] = init_norm(cfg.d_model, dt, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
    return params


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D)."""
    return params["embed"][tokens.long()]


def lm_logits(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """x: (B, [S,] D) -> f32 logits (B, [S,] vocab)."""
    x = apply_norm(params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return (x @ head.T).float()


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

@dataclass
class ModelCache:
    layers: list          # one PagedLayerCache per layer, in depth order
    cur_pos: torch.Tensor  # (B,) int32: next token position per request


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
                       device=None) -> ModelCache:
    """Empty per-layer caches (pool N = batch * P pages each) on ``device``
    (default CUDA; raises without a card); ``ccfg.dtype`` "int8" makes
    quantized pools."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = dtype or dtype_of(ccfg.dtype)
    hd = cfg.resolved_head_dim
    layers = [
        init_layer_cache(batch, _layer_cache_shapes(cfg, spec, seq_len,
                                                    policy, ccfg,
                                                    chunk_tokens),
                         ccfg.page_size, cfg.num_kv_heads, hd, dt,
                         track_stats=track_stats, device=device)
        for spec in cfg.layer_specs()]
    return ModelCache(layers=layers,
                      cur_pos=torch.zeros((batch,), dtype=torch.int32,
                                          device=device))


# ---------------------------------------------------------------------------
# unified mixed-batch step
# ---------------------------------------------------------------------------

def _step_layer(lp: dict, cfg: ModelConfig, spec: LayerSpec, x, kvc, *,
                positions, n_tok, policy: EvictionPolicy, ccfg: CacheConfig,
                decode_mask, prefill_mask, reset_mask, share_src, share_pages,
                times: list[int], has_decode: bool, has_prefill: bool,
                has_reset: bool, decode_splits: int, fused_scores: bool,
                plain_kernels: bool, want_taps: bool = False):
    """One attention + MLP layer of the unified step. x: (B, T, D);
    positions: (B, T) int32 with -1 past each row's ``n_tok``. The
    ``has_*`` flags come from host copies of the masks and skip hooks that
    would be identities (the JAX package skips them under ``lax.cond``).
    Returns (x, tap): with ``want_taps`` (the regret shadow probes,
    obs/regret.py) tap holds this step's k and v, the q used, the attention
    output before the projection, and ``live_pos``, the cache's positions
    after the append and before the eviction (a gathered copy: the eviction
    mutates the pool in place); else tap is None and nothing more runs."""
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
        want_scores=fused_scores, plain=plain_kernels)
    tap = None
    if want_taps:
        tap = {"k": k, "v": v, "q": q, "o": o, "live_pos": kvc.pos_view()}
    if has_decode:
        policy.post_write(kvc, ccfg, active=decode_mask, page_scores=pscores)
    if has_prefill:
        policy.chunk_prefill_evict(kvc, ccfg, active=prefill_mask,
                                   window=window, page_scores=pscores)
    x = x + o.reshape(B, T, -1) @ lp["attn"]["wo"]
    h2 = apply_norm(lp["norm2"], x)
    return x + mlp_forward(lp["mlp"], cfg, h2), tap


def forward_step(params: dict, cfg: ModelConfig, tokens, n_tok,
                 cache: ModelCache, policy: EvictionPolicy, ccfg: CacheConfig,
                 decode_mask=None, prefill_mask=None, reset_mask=None,
                 share_src=None, share_pages=None, decode_splits: int = 1,
                 fused_scores: bool = False, plain_kernels: bool = False,
                 want_taps: bool = False):
    """Unified mixed-batch step, as ``transformer.forward_step`` of the JAX
    package. tokens (B, T) int32 (row b's live tokens are tokens[b,
    :n_tok[b]]); n_tok (B,); the masks (B,) bool; share_src / share_pages
    (B,) int32 prefix-sharing adoptions on reset rows. ``fused_scores``:
    rank page eviction by the kernels' norm epilogue. ``plain_kernels``:
    run the kernels' plain versions on the card (a test switch).

    Updates ``cache`` in place and returns (logits (B, vocab) f32 at each
    row's last live token, cache). One host read per step: the layers'
    write heads and the masks, from which each layer's page-boundary plan
    for ``append_chunk`` is computed. ``want_taps`` (obs/regret.py) also
    returns the taps {"layers": [per-layer tap of :func:`_step_layer`],
    "positions": (B, T)} as a third value; False runs exactly the ops of a
    step without it."""
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

    # the one host read: per-layer heads and the step's masks
    host = torch.cat([torch.stack([c.cur_off, c.head_mapped().int()])
                      .reshape(-1) for c in cache.layers] +
                     [n_tok.int(), decode_mask.int(), prefill_mask.int(),
                      reset_mask.int()]).cpu().numpy()
    L = len(cache.layers)
    heads = host[:2 * B * L].reshape(L, 2, B)
    n_h, dec_h, pre_h, reset_h = host[2 * B * L:].reshape(4, B)
    flags = dict(has_decode=bool(dec_h.any()), has_prefill=bool(pre_h.any()),
                 has_reset=bool(reset_h.any()))
    taps = []
    for lp, spec, kvc, (off, mapped) in zip(params["layers"],
                                            cfg.layer_specs(), cache.layers,
                                            heads):
        # release / adopt park a reset row's head full: it rolls at t == 0
        off = np.where(reset_h > 0, page, off)
        times = append_plan(kvc, off, mapped, n_h, T)
        x, tap = _step_layer(lp, cfg, spec, x, kvc, positions=positions,
                             n_tok=n_tok, policy=policy, ccfg=ccfg,
                             decode_mask=decode_mask,
                             prefill_mask=prefill_mask,
                             reset_mask=reset_mask, share_src=share_src,
                             share_pages=share_pages, times=times,
                             decode_splits=decode_splits,
                             fused_scores=fused_scores,
                             plain_kernels=plain_kernels,
                             want_taps=want_taps, **flags)
        taps.append(tap)
    last = (n_tok.long() - 1).clamp_min(0)
    x_last = x[torch.arange(B, device=dev), last]
    logits = lm_logits(params, cfg, x_last)
    cache.cur_pos = cur_pos + n_tok.to(torch.int32)
    if want_taps:
        return logits, cache, {"layers": taps, "positions": positions}
    return logits, cache


def collect_step_stats(cache: ModelCache):
    """Sum every layer's devstats vector -> (NSTATS,) int32, or None when the
    caches do not track stats. Call after the step."""
    vecs = [c.stats for c in cache.layers if c.stats is not None]
    if not vecs:
        return None
    return torch.stack(vecs).sum(0, dtype=torch.int32)


def intact_prefix_pages(cache: ModelCache, row: int) -> torch.Tensor:
    """() int32: leading full prompt pages of batch row ``row`` intact in
    EVERY layer (min over layers): the device half of the prefix-sharing
    admission probe."""
    return torch.stack([row_intact_prefix_pages(c, row)
                        for c in cache.layers]).min()


# ---------------------------------------------------------------------------
# one-shot path: contiguous prefill that builds the paged caches, then
# single-token decode steps
# ---------------------------------------------------------------------------

def layer_forward(lp: dict, cfg: ModelConfig, spec: LayerSpec, x, positions,
                  plain_kernels: bool = False):
    """One attention + dense-MLP layer over a contiguous sequence.
    Returns (x, (k, v)) with k post-RoPE."""
    h = apply_norm(lp["norm1"], x)
    a, kv = attn_mod.attention_forward(lp["attn"], cfg, spec, h, positions,
                                       plain=plain_kernels)
    x = x + a
    return x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["norm2"], x)), kv


def _prefill_layer(lp: dict, cfg: ModelConfig, spec: LayerSpec, x, positions,
                   valid, policy: EvictionPolicy, ccfg: CacheConfig,
                   seq_len_hint: int, plain_kernels: bool):
    """Layer forward that also builds its decode cache (Alg.2)."""
    x, (k, v) = layer_forward(lp, cfg, spec, x, positions, plain_kernels)
    window = attn_mod.spec_window(cfg, spec)
    hint = seq_len_hint if not window else min(seq_len_hint,
                                               window + ccfg.page_size)
    kv_valid = valid
    if window:
        # windowed layers never attend past the window again: drop the
        # out-of-window tokens at paging time (keeps the slab small)
        cur = torch.where(valid, positions, -1).amax(-1, keepdim=True)
        kv_valid = valid & (positions > cur - window)
    cache = compress_and_page(k, v, positions, kv_valid, policy, ccfg,
                              seq_len_hint=hint,
                              cache_dtype=dtype_of(ccfg.dtype))
    return x, cache


def forward_prefill(params: dict, cfg: ModelConfig, tokens,
                    policy: EvictionPolicy, ccfg: CacheConfig, valid=None,
                    total_seq_hint: int | None = None,
                    plain_kernels: bool = False):
    """Process whole prompts, compress each layer's K/V by Alg.2 and page
    it: tokens (B, S) int32; ``valid`` (B, S) bool marks right-padded
    prompts' real tokens. ``total_seq_hint``: expected prompt + generation
    length, which sizes the page slabs (default S). The caches live on
    ``tokens``' device. Returns (last valid token's logits (B, vocab) f32,
    ModelCache)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    if valid is None:
        valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    positions = torch.where(valid, positions, -1)
    hint = total_seq_hint or S
    layers = []
    for lp, spec in zip(params["layers"], cfg.layer_specs()):
        x, c = _prefill_layer(lp, cfg, spec, x, positions, valid, policy,
                              ccfg, hint, plain_kernels)
        layers.append(c)
    n_valid = valid.sum(-1, dtype=torch.int32)
    last = (n_valid.long() - 1).clamp_min(0)
    logits = lm_logits(params, cfg, x[torch.arange(B, device=dev), last])
    return logits, ModelCache(layers=layers, cur_pos=n_valid)


def _decode_layer(lp: dict, cfg: ModelConfig, spec: LayerSpec, x, kvc,
                  cur_pos, policy: EvictionPolicy, ccfg: CacheConfig, active,
                  decode_splits: int, fused_scores: bool,
                  plain_kernels: bool):
    """One layer, one token. x: (B, D)."""
    h = apply_norm(lp["norm1"], x)
    q, k, v = attn_mod.decode_project_qkv(lp["attn"], cfg, h, cur_pos)
    if kvc.stats is not None:
        kvc.stats.zero_()
    out = []

    def attend(c):
        o, pscores = attn_mod.decode_attention(
            q, c, cur_pos=cur_pos, window=attn_mod.spec_window(cfg, spec),
            num_splits=decode_splits, want_scores=fused_scores,
            plain=plain_kernels)
        out.append(o)
        return pscores

    decode_append(kvc, k, v, cur_pos, policy, ccfg, active=active,
                  attend=attend)
    x = x + out[0].reshape(x.shape[0], -1) @ lp["attn"]["wo"]
    return x + mlp_forward(lp["mlp"], cfg, apply_norm(lp["norm2"], x))


def decode_step(params: dict, cfg: ModelConfig, tokens, cache: ModelCache,
                policy: EvictionPolicy, ccfg: CacheConfig, active=None,
                decode_splits: int = 1, fused_scores: bool = False,
                plain_kernels: bool = False):
    """One decode step of every request: tokens (B,) -> (logits (B, vocab)
    f32, cache), the cache updated in place. ``active`` (B,) bool: rows
    that take a token. ``decode_splits`` / ``fused_scores`` /
    ``plain_kernels``: see :func:`forward_step`."""
    x = params["embed"][tokens.long()]
    B = x.shape[0]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=x.device)
    cur_pos = cache.cur_pos
    for lp, spec, kvc in zip(params["layers"], cfg.layer_specs(),
                             cache.layers):
        x = _decode_layer(lp, cfg, spec, x, kvc, cur_pos, policy, ccfg,
                          active, decode_splits, fused_scores, plain_kernels)
    logits = lm_logits(params, cfg, x)
    cache.cur_pos = torch.where(active, cur_pos + 1, cur_pos)
    return logits, cache

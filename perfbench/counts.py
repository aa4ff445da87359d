"""Operations and bytes of the one-shot path, from shapes alone, and the
H100's peaks (NVIDIA's data sheet, SXM part, dense, at its 700 W limit).

The rules are the kernel bounds of the port's kernel table (PERF.md,
"Every TPU kernel of the repository", Bounds): attention costs 4 * hd
operations per (query head, visible key) pair; a kernel reads each input
byte once and writes each output byte once. A share of a peak states the
card's power limit beside it: below 700 W the card runs slower than the
peak assumes.

Each layer is charged by its kind (``LayerSpec.mixer``). An attention
layer: the q / k / v / o projections, 4 * hd operations a visible pair,
its K / V pages. A Mamba-1 layer (d_inner di, d_state ds, dt_rank dr,
d_conv dc), operations per token, the products only: in_proj 2 * D * 2di,
the depthwise conv 2 * dc * di, x_proj 2 * di * (dr + 2ds), dt_proj 2 *
dr * di, the scan 4 * di * ds (the state's update and its read by C),
out_proj 2 * di * D; a decode step reads the mixer's weights once (dt_bias,
A_log and D in f32) and reads and writes each row's f32 state (di, ds) and
its conv window (dc - 1, di) in the model's dtype. Then the layer's MLP:
dense, or the router and the k routed experts. Another mixer raises.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # dense tensor-core rate, bf16
PEAK_HBM_BYTES = 3.35e12      # HBM3 bandwidth
BF16 = 2
F32 = 4


def _attn_dims(cfg):
    return cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads


def _mamba_dims(cfg):
    return (cfg.mamba_d_inner, cfg.mamba_d_state, cfg.resolved_dt_rank,
            cfg.mamba_d_conv)


def _mixer(spec) -> str:
    if spec.mixer not in ("attn", "mamba"):
        raise ValueError(f"no count for a {spec.mixer} layer")
    return spec.mixer


def mamba_flops(cfg) -> int:
    """Operations per token of one Mamba-1 mixer (module docstring)."""
    di, ds, dr, dc = _mamba_dims(cfg)
    D = cfg.d_model
    return (2 * D * 2 * di + 2 * dc * di + 2 * di * (dr + 2 * ds)
            + 2 * dr * di + 4 * di * ds + 2 * di * D)


def mamba_weight_bytes(cfg, elt: int = BF16) -> int:
    di, ds, dr, dc = _mamba_dims(cfg)
    D = cfg.d_model
    return ((D * 2 * di + dc * di + di + di * (dr + 2 * ds) + dr * di
             + di * D) * elt + (di + di * ds + di) * F32)


def mamba_state_bytes(cfg, B: int, elt: int = BF16) -> int:
    """One decode step's reads and writes of B rows' state in one layer."""
    di, ds, _, dc = _mamba_dims(cfg)
    return 2 * B * (di * ds * F32 + (dc - 1) * di * elt)


def layer_linear_flops(cfg, spec) -> int:
    """Operations per token of one layer's products: the mixer's (q / k / v
    / o projections, or a Mamba mixer's) and the MLP's, or the router's
    and the k routed experts'."""
    hd, H, KV = _attn_dims(cfg)
    D = cfg.d_model
    if _mixer(spec) == "attn":
        f = 2 * D * (H + 2 * KV) * hd + 2 * H * hd * D
    else:
        f = mamba_flops(cfg)
    if spec.mlp == "moe":
        f += 2 * D * cfg.num_experts
        f += cfg.num_experts_per_tok * 2 * 3 * D * cfg.d_ff
    elif spec.mlp == "dense":
        f += 2 * 3 * D * cfg.d_ff
    return f


def linear_flops_per_token(cfg) -> int:
    return sum(layer_linear_flops(cfg, s) for s in cfg.layer_specs())


def head_flops(cfg) -> int:
    return 2 * cfg.d_model * cfg.vocab_size


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def attention_flops(cfg, pairs: int) -> int:
    """All layers' attention over ``pairs`` (query, key) pairs per head."""
    hd, H, _ = _attn_dims(cfg)
    return 4 * hd * H * pairs * cfg.num_attn_layers()


def prefill_flops(cfg, lengths) -> int:
    """Model operations of a prefill: valid tokens only, each layer's
    products, causal attention over each row's own tokens, the head over
    each row's last token."""
    toks = sum(int(n) for n in lengths)
    return (toks * linear_flops_per_token(cfg)
            + attention_flops(cfg, sum(causal_pairs(int(n))
                                       for n in lengths))
            + len(lengths) * head_flops(cfg))


def least_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The chip's least time for the work, and which bound sets it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k5_call(cfg, B: int, S: int, elt: int = BF16) -> tuple[int, int]:
    """(operations, bytes) of one K5 launch (one layer) over B rows of S
    tokens: the kernel masks by index, so it is handed every causal pair
    of the padded rows; q, k, v read once, the output written once."""
    hd, H, KV = _attn_dims(cfg)
    ops = 4 * hd * H * B * causal_pairs(S)
    nbytes = B * S * hd * (2 * H + 2 * KV) * elt
    return ops, nbytes


def k1_call(cfg, B: int, mapped_pages: int, live_tokens: int, page: int,
            splits: int, elt: int = BF16) -> tuple[int, int]:
    """(operations, bytes) of one K1 launch (one layer, one decode step):
    the K / V and positions of the ``mapped_pages`` pages of all rows, the
    block tables, q, the split partials and the fused epilogue's norms
    written. ``live_tokens``: the valid keys over all rows."""
    hd, H, KV = _attn_dims(cfg)
    G = H // KV
    slots = mapped_pages * page
    reads = slots * KV * hd * 2 * elt + slots * 4 + B * H * hd * elt
    writes = B * KV * splits * G * (hd + 2) * 4 + 2 * slots * KV * 4
    return 4 * hd * H * live_tokens, reads + writes


def weight_bytes(cfg, experts_read: int | None = None,
                 elt: int = BF16) -> int:
    """Bytes of the layers' weights and the head read once; a MoE layer
    reads ``experts_read`` of its experts (default all)."""
    hd, H, KV = _attn_dims(cfg)
    D = cfg.d_model
    total = cfg.vocab_size * D * elt + D * elt          # head, final norm
    for spec in cfg.layer_specs():
        if _mixer(spec) == "attn":
            total += (D * (H + 2 * KV) * hd + H * hd * D) * elt
        else:
            total += mamba_weight_bytes(cfg, elt)
        total += 2 * D * elt
        if spec.mlp == "moe":
            e = cfg.num_experts if experts_read is None else experts_read
            total += D * cfg.num_experts * 4 + e * 3 * D * cfg.d_ff * elt
        elif spec.mlp == "dense":
            total += 3 * D * cfg.d_ff * elt
    return total


def decode_step(cfg, B: int, mapped_pages: int, live_tokens: int,
                page: int, elt: int = BF16) -> tuple[int, int]:
    """(operations, bytes) of one whole decode step of B rows: the layers'
    products and the head for each row, attention over the live keys; the
    weights read once (a MoE layer the at most B * k experts its rows
    route to), the live K / V pages once, each Mamba layer's state read
    and written, the logits written."""
    hd, H, KV = _attn_dims(cfg)
    L = cfg.num_attn_layers()
    ops = B * (linear_flops_per_token(cfg) + head_flops(cfg)) \
        + 4 * hd * H * live_tokens * L
    experts = min(cfg.num_experts, B * cfg.num_experts_per_tok) \
        if cfg.num_experts else None
    mamba = sum(_mixer(s) == "mamba" for s in cfg.layer_specs())
    nbytes = (weight_bytes(cfg, experts, elt)
              + L * mapped_pages * page * (KV * hd * 2 * elt + 4)
              + mamba * mamba_state_bytes(cfg, B, elt)
              + B * cfg.vocab_size * 4)
    return ops, nbytes


def share(least: float, measured: float) -> float:
    """A share of the peak in percent."""
    return 100.0 * least / measured

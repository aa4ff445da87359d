"""The benchmark's operation and byte counts: by hand at small shapes,
and against the port's meta-device step counter."""
import pytest
import torch

import pb_tiny  # noqa: F401  (paths)
from perfbench import counts


def test_hand_counts():
    assert counts.causal_pairs(4) == 10
    from repro_torch.configs import get_arch
    cfg = get_arch("mistral-nemo-12b")
    ops, nbytes = counts.k5_call(cfg, 1, 4)
    assert ops == 4 * 128 * 32 * 10
    assert nbytes == 4 * 128 * (2 * 32 + 2 * 8) * 2
    D, F, V = 5120, 14336, 131072
    per_layer = 2 * D * (32 + 16) * 128 + 2 * 4096 * D + 6 * D * F
    assert counts.linear_flops_per_token(cfg) == 40 * per_layer
    assert counts.prefill_flops(cfg, [3]) == \
        3 * 40 * per_layer + 4 * 128 * 32 * 6 * 40 + 2 * D * V
    t, by = counts.least_s(989e12, 1.0)
    assert t == pytest.approx(1.0) and by == "operations"
    mix = get_arch("mixtral-8x7b")
    moe = 2 * 4096 * 8 + 2 * 6 * 4096 * 14336
    assert counts.layer_linear_flops(mix, mix.layer_specs()[0]) == \
        2 * 4096 * 48 * 128 + 2 * 4096 * 4096 + moe


ARCHS = ["mistral-nemo-12b", "mixtral-8x7b", "jamba-1.5-large-398b"]


def test_counts_charge_attention_to_attention_layers_only():
    """A hybrid's projections and K / V are its attention layers': 1 of the
    4 layers of the reduced jamba; its Mamba layers count their mixer."""
    from repro_torch.configs import get_arch
    cfg = get_arch("jamba-1.5-large-398b").reduced()
    specs = cfg.layer_specs()
    assert [s.mixer for s in specs] == ["attn", "mamba", "mamba", "mamba"]
    D, di, ds, dr, dc = (cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state,
                         cfg.resolved_dt_rank, cfg.mamba_d_conv)
    mixer = (4 * D * di + 2 * dc * di + 2 * di * (dr + 2 * ds)
             + 2 * dr * di + 4 * di * ds + 2 * di * D)
    assert counts.mamba_flops(cfg) == mixer
    attn = 2 * D * (4 + 2) * 64 + 2 * 4 * 64 * D
    moe = 2 * D * 4 + 2 * 6 * D * cfg.d_ff
    assert counts.linear_flops_per_token(cfg) == \
        attn + 3 * mixer + 2 * moe + 2 * 6 * D * cfg.d_ff
    assert counts.attention_flops(cfg, 10) == 4 * 64 * 4 * 10
    ops, nbytes = counts.decode_step(cfg, 3, 7, 100, 8)
    dense, _ = counts.decode_step(cfg, 3, 7, 0, 8)
    assert ops - dense == 4 * 64 * 4 * 100
    state = 2 * 3 * (di * ds * 4 + (dc - 1) * di * 2)
    assert counts.mamba_state_bytes(cfg, 3) == state
    assert nbytes == counts.weight_bytes(cfg, min(4, 3 * 2)) + 7 * 8 * (
        1 * 64 * 2 * 2 + 4) + 3 * state + 3 * cfg.vocab_size * 4


def test_mamba_state_bytes_match_the_state():
    from repro_torch.configs import get_arch
    from repro_torch.models.mamba import mamba_init_state
    cfg = get_arch("jamba-1.5-large-398b").reduced()
    st = mamba_init_state(cfg, 3, torch.bfloat16, "meta")
    size = st.conv.numel() * 2 + st.ssm.numel() * 4
    assert counts.mamba_state_bytes(cfg, 3) == 2 * size


def test_other_mixers_are_refused():
    from repro_torch.configs import get_arch
    with pytest.raises(ValueError, match="mlstm"):
        counts.linear_flops_per_token(get_arch("xlstm-1.3b").reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_weight_bytes_match_the_parameters(arch):
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_model
    from perfbench.weights import param_bytes
    cfg = get_arch(arch).reduced()
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "bfloat16"})
    meta = init_model(cfg, device="meta")
    embed = meta["embed"].numel() * 2
    assert counts.weight_bytes(cfg) == param_bytes(meta) - embed


@pytest.mark.parametrize("arch", ARCHS)
def test_linear_flops_match_the_step_counter(arch):
    """Each layer's products and the head, run by the port on the meta
    device under ``launch/analysis.py``'s StepCounter, count what
    ``counts`` says (MoE layers by the decode's dense combine over every
    expert and its gate combine, the router once; a Mamba layer by
    ``mamba_decode_step`` a token at a time, whose state update, dA * h +
    dt * x * B, is elementwise and not among the counter's products)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.analysis import StepCounter
    from repro_torch.models import attention, mamba, mlp, moe
    from repro_torch.models.transformer import init_model, lm_logits
    cfg = get_arch(arch).reduced()
    p = init_model(cfg, device="meta")
    B, S = 2, 64
    x = torch.empty((B, S, cfg.d_model), device="meta")
    pos = torch.zeros((B, S), dtype=torch.int32, device="meta")
    state = mamba.mamba_init_state(cfg, B * S, torch.float32, "meta")
    with StepCounter(1) as c:
        for lp, spec in zip(p["layers"], cfg.layer_specs()):
            if spec.mixer == "attn":
                q, _, _ = attention.project_qkv(lp["attn"], cfg, x, pos)
                q.reshape(B, S, -1) @ lp["attn"]["wo"]
            else:
                mamba.mamba_decode_step(lp["mamba"], cfg,
                                        x.reshape(B * S, -1), state)
            if spec.mlp == "moe":
                moe.moe_forward_decode(lp["moe"], cfg, x.reshape(B * S, -1))
            else:
                mlp.mlp_forward(lp["mlp"], cfg, x)
        lm_logits(p, cfg, x[:, -1])
    want = B * S * counts.linear_flops_per_token(cfg) + \
        B * counts.head_flops(cfg)
    mamba_layers = sum(s.mixer == "mamba" for s in cfg.layer_specs())
    want -= B * S * mamba_layers * 2 * cfg.mamba_d_inner * cfg.mamba_d_state
    if cfg.num_experts:
        dense = cfg.num_experts - cfg.num_experts_per_tok
        moe_layers = sum(s.mlp == "moe" for s in cfg.layer_specs())
        want += B * S * moe_layers * (
            dense * 6 * cfg.d_model * cfg.d_ff          # unrouted experts
            + 2 * cfg.num_experts * cfg.d_model)        # the gate combine
    assert c.flops == want

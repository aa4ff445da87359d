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


def test_decode_weight_bytes_match_the_parameters():
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_model
    from perfbench.weights import param_bytes
    cfg = get_arch("mistral-nemo-12b").reduced()
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "bfloat16"})
    meta = init_model(cfg, device="meta")
    embed = meta["embed"].numel() * 2
    assert counts.weight_bytes(cfg) == param_bytes(meta) - embed


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "mixtral-8x7b"])
def test_linear_flops_match_the_step_counter(arch):
    """Each layer's products and the head, run by the port on the meta
    device under ``launch/analysis.py``'s StepCounter, count what
    ``counts`` says (MoE layers by the decode's dense combine over every
    expert and its gate combine, the router once)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.analysis import StepCounter
    from repro_torch.models import attention, mlp, moe
    from repro_torch.models.transformer import init_model, lm_logits
    cfg = get_arch(arch).reduced()
    p = init_model(cfg, device="meta")
    B, S = 2, 64
    x = torch.empty((B, S, cfg.d_model), device="meta")
    pos = torch.zeros((B, S), dtype=torch.int32, device="meta")
    with StepCounter(1) as c:
        for lp, spec in zip(p["layers"], cfg.layer_specs()):
            q, _, _ = attention.project_qkv(lp["attn"], cfg, x, pos)
            q.reshape(B, S, -1) @ lp["attn"]["wo"]
            if spec.mlp == "moe":
                moe.moe_forward_decode(lp["moe"], cfg, x.reshape(B * S, -1))
            else:
                mlp.mlp_forward(lp["mlp"], cfg, x)
        lm_logits(p, cfg, x[:, -1])
    want = B * S * counts.linear_flops_per_token(cfg) + \
        B * counts.head_flops(cfg)
    if cfg.num_experts:
        dense = cfg.num_experts - cfg.num_experts_per_tok
        want += B * S * len(cfg.layer_specs()) * (
            dense * 6 * cfg.d_model * cfg.d_ff          # unrouted experts
            + 2 * cfg.num_experts * cfg.d_model)        # the gate combine
    assert c.flops == want

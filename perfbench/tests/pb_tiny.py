"""Tiny cells for the CPU tests: the port's reduced families in f32, on
the harness's own files' layout."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.spec import MODEL_KEYS, Cell  # noqa: E402

LOOSE = {"token_gap": 1e-3, "prefill_logit_err": 1e-3,
         "decode_gap_med": 1e-3, "kept_miss": 0.0, "evict_gap": 0.0}
# each tiny family, under a policy, stands in for the cell of its
# architecture
CELL = {("mistral-nemo-12b", "paged_eviction"): "nemo12b.longdoc",
        ("mixtral-8x7b", "paged_eviction"): "mixtral8x7b.longdoc",
        ("mistral-nemo-12b", "full"): "nemo12b.longdoc_full"}
# the source keys of a hybrid's config (and the second name of the
# expert count), which the attention-only families' configs do not hold
HYBRID_KEYS = ("num_experts", "mamba_d_state", "mamba_d_conv",
               "mamba_expand", "mamba_dt_rank", "attn_layer_period",
               "expert_layer_period")


def tiny_config(arch: str = "mistral-nemo-12b",
                policy: str = "paged_eviction") -> dict:
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).reduced()
    model = {key: getattr(cfg, field) for key, field in MODEL_KEYS.items()
             if key not in HYBRID_KEYS}
    model.update(sliding_window=None, rms_norm_eps=1e-6, hidden_act="silu",
                 tie_word_embeddings=False, torch_dtype="float32")
    if not cfg.num_experts:
        for key in ("num_local_experts", "num_experts_per_tok",
                    "moe_capacity_factor"):
            model.pop(key)
    return {"name": f"tiny-{arch}", "port_arch": arch, "model": model,
            "cache": {"page_size": 8, "cache_budget": 64,
                      "policy": policy, "dtype": "float32"},
            "decode": {"decode_splits": 2, "fused_scores": True}}


def tiny_traffic(rows: int = 2, steps: int = 12) -> dict:
    """Prompts past the budget of 64, ``steps`` decode steps: the first
    eviction at step 8, after it the steps that attend without the page."""
    return {"loop": "closed", "requests_per_call": rows,
            "prompt_len": {"dist": "log_uniform", "min": 150, "max": 300,
                           "draw": "stratified_midpoints"},
            "pad": {"side": "right", "to": "call_max", "multiple": 128},
            "token_ids": "uniform", "decode_steps": steps,
            "sampling": "greedy", "check_requests": 2}


def tiny_cell(arch: str = "mistral-nemo-12b", limits: dict | None = None,
              policy: str = "paged_eviction", **traffic) -> Cell:
    from perfbench.spec import benchmark
    bench = benchmark()
    return Cell(name=f"tiny.{arch}", config_name=f"tiny-{arch}",
                traffic_name="tiny", config=tiny_config(arch, policy),
                traffic=tiny_traffic(**traffic), limits=limits or LOOSE,
                end_to_end=bench["end_to_end"],
                per_layer=bench["per_layer"])

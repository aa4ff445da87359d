"""Model / serving configuration dataclasses (a copy of the JAX package's
``repro.configs.base``, kept here so the port imports nothing of it).

Every assigned architecture is expressed as a ``ModelConfig``.  A config is
pure data: the model substrate (``repro_torch.models``) interprets it.
Layer heterogeneity (local/global attention, mamba/attention hybrids,
MoE-every-k, sLSTM/mLSTM interleave) is expressed as a repeating *layer
pattern*; the torch port runs it as a plain list of layers.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


# ---------------------------------------------------------------------------
# Per-layer spec (one element of the repeating pattern)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    """Static description of a single decoder layer."""
    mixer: str = "attn"          # "attn" | "mamba" | "mlstm" | "slstm"
    attn_kind: str = "global"    # "global" | "local" | "swa"  (attn only)
    mlp: str = "dense"           # "dense" | "moe" | "none"

    @property
    def has_kv_cache(self) -> bool:
        return self.mixer == "attn"


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (the public pool entries)."""
    name: str
    arch_type: str               # dense | moe | hybrid | ssm | vlm | audio
    source: str                  # citation (paper / model card)
    num_layers: int = 12
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0            # 0 -> d_model // num_heads
    d_ff: int = 2048
    vocab_size: int = 32000

    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0      # >0: SWA window for attn_kind=="swa"
    local_window: int = 0        # >0: window for attn_kind=="local"
    local_global_ratio: int = 0  # gemma3: N local layers per 1 global
    logit_soft_cap: float = 0.0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_every: int = 1           # MoE MLP on every k-th layer (jamba: 2)
    moe_capacity_factor: float = 1.25

    # --- hybrid (jamba) -----------------------------------------------------
    attn_every: int = 0          # >0: attention on layer i%attn_every==0, rest mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0       # 0 -> ceil(d_model / 16)

    # --- xLSTM ---------------------------------------------------------------
    slstm_every: int = 0         # >0: sLSTM on layer i%slstm_every==slstm_every-1
    xlstm_proj_factor: float = 2.0

    # --- modality ------------------------------------------------------------
    modality: str = "text"       # text | vlm | audio
    num_codebooks: int = 1       # musicgen: parallel codebooks
    cross_attention: bool = False
    cond_len: int = 0            # conditioning sequence length (stub frontend)

    # --- misc -----------------------------------------------------------------
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"            # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ props
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, -(-self.d_model // 16))

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    # ------------------------------------------------------------- pattern
    def layer_pattern(self) -> list[LayerSpec]:
        """The repeating per-layer pattern (period P)."""
        period = 1
        if self.attn_every:
            period = max(period, self.attn_every)
        if self.slstm_every:
            period = max(period, self.slstm_every)
        if self.local_global_ratio:
            period = max(period, self.local_global_ratio + 1)
        if self.num_experts and self.moe_every > 1:
            period = max(period, self.moe_every)
        # lcm-ish: all our configs use compatible periods; verify below.
        specs = []
        for i in range(period):
            if self.attn_every:
                mixer = "attn" if i % self.attn_every == 0 else "mamba"
            elif self.slstm_every:
                mixer = "slstm" if i % self.slstm_every == self.slstm_every - 1 else "mlstm"
            else:
                mixer = "attn"
            if mixer == "attn":
                if self.local_global_ratio:
                    # gemma3 style: ratio local layers then 1 global per period slot
                    attn_kind = "global" if (i + 1) % (self.local_global_ratio + 1) == 0 else "local"
                elif self.sliding_window:
                    attn_kind = "swa"
                else:
                    attn_kind = "global"
            else:
                attn_kind = "global"
            if self.num_experts and i % self.moe_every == (self.moe_every - 1):
                mlp = "moe"
            elif mixer in ("mlstm", "slstm"):
                mlp = "none"          # xLSTM blocks carry their own projections
            else:
                mlp = "dense"
            specs.append(LayerSpec(mixer=mixer, attn_kind=attn_kind, mlp=mlp))
        return specs

    def layer_specs(self) -> list[LayerSpec]:
        """Per-layer specs for the full depth (pattern repeated + remainder)."""
        pat = self.layer_pattern()
        reps, rem = divmod(self.num_layers, len(pat))
        return pat * reps + pat[:rem]

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern())

    @property
    def full_pattern_reps(self) -> int:
        return self.num_layers // self.pattern_period

    @property
    def remainder_layers(self) -> int:
        return self.num_layers % self.pattern_period

    def num_attn_layers(self) -> int:
        return sum(1 for s in self.layer_specs() if s.mixer == "attn")

    # ------------------------------------------------------------ parameter math
    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        hd = self.resolved_head_dim
        total = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        if self.num_codebooks > 1:
            total += (self.num_codebooks - 1) * self.vocab_size * self.d_model * 2
        for spec in self.layer_specs():
            if spec.mixer == "attn":
                q = self.d_model * self.num_heads * hd
                kv = 2 * self.d_model * self.num_kv_heads * hd
                o = self.num_heads * hd * self.d_model
                total += q + kv + o
                if self.cross_attention:
                    total += q + kv + o
            elif spec.mixer == "mamba":
                di, ds, dr = self.mamba_d_inner, self.mamba_d_state, self.resolved_dt_rank
                total += self.d_model * di * 2          # in_proj
                total += di * self.mamba_d_conv          # conv
                total += di * (dr + 2 * ds)              # x_proj
                total += dr * di + di * ds + di          # dt_proj, A, D
                total += di * self.d_model               # out_proj
            elif spec.mixer in ("mlstm", "slstm"):
                di = int(self.xlstm_proj_factor * self.d_model)
                if spec.mixer == "mlstm":
                    total += self.d_model * di * 2 + 3 * di * di // max(1, self.num_heads) + di * self.d_model
                else:
                    total += 4 * self.d_model * self.d_model + 4 * self.d_model * self.d_model // max(1, self.num_heads)
                    total += self.d_model * di * 2
            if spec.mlp == "dense":
                total += 3 * self.d_model * self.d_ff
            elif spec.mlp == "moe":
                total += self.d_model * self.num_experts  # router
                total += self.num_experts * 3 * self.d_model * self.d_ff
            total += 2 * self.d_model  # norms
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        total = self.param_count()
        moe_layers = sum(1 for s in self.layer_specs() if s.mlp == "moe")
        unused = (self.num_experts - self.num_experts_per_tok) * 3 * self.d_model * self.d_ff
        return total - moe_layers * unused

    # --------------------------------------------------------------- reduced
    def reduced(self, tp: int = 1) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (spec: <=2-ish layers,
        d_model<=512, <=4 experts). Keeps one full pattern period when the
        family is heterogeneous so the interleave is exercised.

        ``tp``: make the reduced config servable at that tensor-parallel
        degree — KV heads are rounded UP to a multiple of ``tp`` (preserving
        the family's GQA ratio for the query heads), since TP shards whole
        KV heads. TP∈{1,2,4} parity tests must use the SAME tp-capable
        config at every degree."""
        num_layers = 2
        if self.attn_every or self.slstm_every or self.local_global_ratio:
            num_layers = min(self.pattern_period, 4)
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        # keep GQA ratio when possible
        if self.num_kv_heads < self.num_heads:
            kv = max(1, heads // self.q_per_kv)
        if tp > 1:
            kv = -(-kv // tp) * tp
            # keep a GQA fold (G=2) when the family has one, but cap it so
            # tp=4 configs stay CPU-smoke sized
            ratio = 2 if self.num_kv_heads < self.num_heads else 1
            heads = kv * ratio
        overrides = dict(
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            local_window=min(self.local_window, 64) if self.local_window else 0,
            cond_len=min(self.cond_len, 8) if self.cond_len else 0,
            dtype="float32",
        )
        if self.num_experts:
            overrides["num_experts"] = min(self.num_experts, 4)
            overrides["num_experts_per_tok"] = min(self.num_experts_per_tok, 2)
        if self.attn_every:
            overrides["attn_every"] = min(self.attn_every, num_layers)
            overrides["moe_every"] = min(self.moe_every, 2)
        if self.slstm_every:
            overrides["slstm_every"] = min(self.slstm_every, num_layers)
        if self.local_global_ratio:
            overrides["local_global_ratio"] = min(self.local_global_ratio, num_layers - 1)
        return replace(self, **overrides)

    def validate(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0, self.name
        assert self.d_model > 0 and self.num_layers > 0
        if self.num_experts:
            assert self.num_experts_per_tok > 0
        if self.attn_every:
            assert self.num_layers % self.pattern_period == 0 or True
        # pattern must tile
        assert len(self.layer_specs()) == self.num_layers


# ---------------------------------------------------------------------------
# Serving / cache configuration (paper knobs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheConfig:
    """Paged KV cache + eviction configuration (the paper's knobs)."""
    page_size: int = 16              # B in the paper (16 optimal per vLLM)
    cache_budget: int = 1024         # C in the paper (256..4096 evaluated)
    policy: str = "paged_eviction"   # paged_eviction | streaming_llm |
                                     # inverse_key_l2 | keydiff | full
    num_sink_tokens: int = 4         # streaming_llm attention sinks
    protect_recent: bool = False     # optional extension: never evict newest page
    dtype: str = "bfloat16"
    slab_multiple: int = 1           # round page slabs up to a multiple (TPU:
                                     # 16 enables sharding the page dim over
                                     # the model axis — decode context
                                     # parallelism; see sharding.rules)

    @property
    def budget_pages(self) -> int:
        assert self.cache_budget % self.page_size == 0, (
            f"budget {self.cache_budget} must be a multiple of page {self.page_size}")
        return self.cache_budget // self.page_size

    def max_pages(self, seq_len: int) -> int:
        """Physical pages per request. Full cache: covers seq_len; eviction
        policies: statically bounded by the budget (+1 working page)."""
        total = -(-seq_len // self.page_size)
        if self.policy == "full":
            return total
        return min(total, self.budget_pages + 1)

    def validate(self) -> None:
        assert self.page_size > 0
        assert self.cache_budget >= self.page_size
        assert self.cache_budget % self.page_size == 0

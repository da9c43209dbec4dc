"""Model configuration shared by the embedding-model zoo; a copy of
``repro.models.config`` (plain data, no framework).

One frozen dataclass describes every assigned architecture: dense GQA/MQA
transformers, MLA, MoE, pure-SSM (Mamba2/SSD), hybrids (Jamba), and the
VLM/audio stub-frontend variants.  ``layer_pattern`` gives the repeating
per-layer kind sequence; ``moe_every`` marks which layers carry MoE FFNs.

The port adds fields the reference lacks, each defaulting to the
reference's behaviour: ``first_k_dense_replace`` leading layers with the
dense ``d_ff`` MLP (DeepSeek-V2's layer 0), YaRN rope scaling as flat
``rope_yarn_*`` scalars (a frozen dataclass holds no dict; factor 0 is
plain RoPE), and ``moe_dropless`` routing (every routed slot computed, no
capacity).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention options
    attn_type: str = "gqa"  # gqa | mla
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # YaRN (DeepSeek-V2's ``rope_scaling``); factor 0: plain RoPE
    rope_yarn_factor: float = 0.0
    rope_yarn_original_max_positions: int = 0
    rope_yarn_beta_fast: float = 32.0
    rope_yarn_beta_slow: float = 1.0
    rope_yarn_mscale: float = 1.0
    rope_yarn_mscale_all_dim: float = 0.0

    # MLA (multi-head latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_num_shared: int = 0
    moe_every: int = 1  # layer l has MoE FFN iff (l % moe_every) == moe_every-1
    moe_capacity_factor: float = 1.25
    moe_norm_topk: bool = True
    moe_dropless: bool = False  # every routed slot computed (grouped GEMMs), no capacity
    first_k_dense_replace: int = 0  # leading layers with the d_ff MLP, before the MoE pattern

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # layer pattern, repeated to num_layers; None => all "attn" (or all "ssm"
    # for family == "ssm")
    layer_pattern: tuple[str, ...] | None = None

    # modality frontend stubs
    frontend: str | None = None  # "vlm_stub" | "audio_stub"
    num_prefix_embeddings: int = 0  # e.g. 256 image patches

    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ---------------------------------------------------------- derived ----
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def pattern(self) -> tuple[str, ...]:
        if self.layer_pattern is not None:
            if self.num_layers % len(self.layer_pattern) != 0:
                raise ValueError("num_layers must be a multiple of the pattern length")
            return self.layer_pattern
        return ("ssm",) if self.family == "ssm" else ("attn",)

    def layer_kinds(self) -> list[str]:
        pat = self.pattern()
        return [pat[l % len(pat)] for l in range(self.num_layers)]

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe_num_experts == 0 or layer_idx < self.first_k_dense_replace:
            return False
        return (layer_idx % self.moe_every) == (self.moe_every - 1)

    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: no dense O(S^2)-per-token decode state."""
        kinds = set(self.layer_kinds())
        return kinds == {"ssm"} or "ssm" in kinds  # pure SSM or hybrid

    def num_params(self) -> int:
        """Analytic parameter count (for 6ND model-FLOP accounting)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for l, kind in enumerate(self.layer_kinds()):
            total += 2 * d  # norms
            if kind == "attn":
                if self.attn_type == "mla":
                    q_out = self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    qr = self.q_lora_rank
                    total += d * qr + qr * q_out if qr else d * q_out  # factored or direct query
                    total += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    total += self.kv_lora_rank * self.num_heads * (
                        self.qk_nope_head_dim + self.v_head_dim
                    )
                    total += self.num_heads * self.v_head_dim * d
                else:
                    total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                    if self.qkv_bias:
                        total += self.q_dim + 2 * self.kv_dim
            else:  # ssm
                di, st = self.ssm_d_inner, self.ssm_state
                h = self.ssm_heads
                total += d * (2 * di + 2 * st + h)  # in_proj (z, x, B, C, dt)
                total += self.ssm_conv * (di + 2 * st)
                total += 2 * h  # A_log, D
                total += di * d  # out_proj
            if self.is_moe_layer(l):
                e, f = self.moe_num_experts, self.moe_d_ff
                total += d * e  # router
                total += e * 3 * d * f
                total += self.moe_num_shared * 3 * d * f
            else:
                total += 3 * d * self.d_ff
        return total

    def active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe_num_experts == 0:
            return self.num_params()
        d = self.d_model
        total = self.num_params()
        for l in range(self.num_layers):
            if self.is_moe_layer(l):
                e, f, k = self.moe_num_experts, self.moe_d_ff, self.moe_top_k
                total -= (e - k) * 3 * d * f
        return total

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        pat = self.pattern()
        small_layers = max(len(pat), 2 if len(pat) == 1 else len(pat))
        defaults = dict(
            num_layers=small_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            qk_nope_head_dim=8 if self.qk_nope_head_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            moe_num_experts=4 if self.moe_num_experts else 0,
            moe_top_k=min(2, self.moe_top_k) if self.moe_top_k else 0,
            moe_d_ff=32 if self.moe_d_ff else 0,
            moe_num_shared=min(1, self.moe_num_shared),
            # generous capacity so smoke tests see no token drops (the full
            # configs keep the faithful 1.25 factor)
            moe_capacity_factor=4.0 if self.moe_num_experts else self.moe_capacity_factor,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 256,
            num_prefix_embeddings=8 if self.num_prefix_embeddings else 0,
        )
        defaults.update(overrides)
        return replace(self, **defaults)


@dataclass(frozen=True)
class ShapeConfig:
    """One (workload shape) cell: what to lower in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

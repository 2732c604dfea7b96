"""Architecture + shape + approximation config schema (port of
`repro.configs.base`, a pure-Python module kept here as a copy so the port
imports nothing of the JAX package).

One `ModelConfig` per architecture, a `ShapeConfig` per input shape, and
the paper's technique exposed as first-class `approx_*` fields typed on
the port's `core.types.ApproxSpec`. The fields that steer XLA (`remat`,
`unroll_layers`, `fsdp`) are kept so a config reads the same in both
packages; the port's single-card eager model ignores them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..core.types import ApproxSpec


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    experts_per_token: int = 0    # top-k
    d_ff_expert: int = 0          # per-expert hidden
    n_shared_experts: int = 0     # always-on experts (dsv3: 1)
    n_dense_layers: int = 0       # leading dense layers (dsv3: 3)
    d_ff_dense: int = 0           # hidden dim of those dense layers
    capacity_factor: float = 1.25
    router_group_size: int = 512  # tokens per dispatch group (memory knob)
    aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk_size: int = 256         # SSD chunk length
    n_groups: int = 1             # B/C groups (GVA)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora_rank: int = 64     # rank of the data-dependent decay (Finch)
    chunk_size: int = 128         # time-chunk for the chunked WKV form


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style: Mamba2 backbone + a SHARED attention block applied
    every `attn_period` layers (same weights at every application)."""

    attn_period: int = 6


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention flavor
    rope_theta: float = 10000.0
    qk_norm: bool = False         # qwen3
    qkv_bias: bool = False        # qwen1.5
    norm: str = "rms"             # rms | ln
    mlp: str = "gated_silu"       # gated_silu | gelu
    use_mla: bool = False
    mla: Optional[MLAConfig] = None
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid: Optional[HybridConfig] = None
    # enc-dec (whisper): n_layers == encoder layers == decoder layers
    is_encdec: bool = False
    max_source_positions: int = 1500
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: str = "none"        # none | audio_frames | vision_patches
    n_patch_tokens: int = 0       # vlm: patch embeddings per sample
    # training details
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mtp: bool = False             # dsv3 multi-token prediction
    mtp_loss_coef: float = 0.1
    param_dtype: str = "float32"  # float32 | bfloat16 (dsv3 uses bf16)
    compute_dtype: str = "bfloat16"
    remat: bool = True            # activation checkpointing over blocks
    # python-unroll the layer loop instead of lax.scan (roofline marginal-
    # cost artifacts need unrolled HLO: XLA cost analysis counts a while
    # body once regardless of trip count -- verified empirically)
    unroll_layers: bool = False
    # sub-quadratic attention available? (long_500k eligibility)
    subquadratic: bool = False
    # parallelism policy
    fsdp: bool = False            # shard params over data axis too (ZeRO-3)
    # serving: KV cache storage dtype ("bfloat16" | "int8"); int8 stores a
    # per-(batch, head, position) scale and halves decode's dominant HBM
    # traffic (beyond-paper optimization, section Perf cell A)
    kv_cache_dtype: str = "bfloat16"
    # the paper's technique, first-class (defaults: off == exact baseline)
    approx_attention: ApproxSpec = dataclasses.field(default_factory=ApproxSpec)
    approx_ffn: ApproxSpec = dataclasses.field(default_factory=ApproxSpec)
    approx_decode: ApproxSpec = dataclasses.field(default_factory=ApproxSpec)

    # embedding tables padded to a multiple of this (TP divisibility --
    # standard production practice; whisper's 51866 is not 16-divisible)
    vocab_pad_multiple: int = 256

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                                  # embed
        if not self.tie_embeddings:
            total += v * d                             # head
        hd = self.resolved_head_dim

        def attn_params():
            if self.use_mla:
                m = self.mla
                q = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + \
                    m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                o = self.n_heads * m.v_head_dim * d
                return q + kv + o
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def dense_ffn(dff):
            mult = 3 if self.mlp == "gated_silu" else 2
            return mult * d * dff

        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn_params() + dense_ffn(self.d_ff))
        elif self.family == "moe":
            m = self.moe
            n_moe = self.n_layers - m.n_dense_layers
            total += self.n_layers * attn_params()
            total += m.n_dense_layers * dense_ffn(m.d_ff_dense or self.d_ff)
            total += n_moe * (m.n_experts + m.n_shared_experts) * \
                dense_ffn(m.d_ff_expert)
            total += n_moe * d * m.n_experts  # router
        elif self.family == "ssm":
            r = self.rwkv
            total += self.n_layers * (4 * d * d + d * self.d_ff * 2 +
                                      2 * d * r.decay_lora_rank)
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            # mixer only: zamba2 mamba blocks carry no per-layer MLP
            per_mamba = d * (2 * d_in + 2 * s.n_groups * s.d_state +
                             d_in // s.head_dim) + d_in * d
            n_attn = n_hybrid_attn_applications(self)
            n_mamba = self.n_layers - n_attn
            total += n_mamba * per_mamba
            total += attn_params() + dense_ffn(self.d_ff)  # ONE shared block
        elif self.family == "audio":
            # encoder + decoder stacks (n_layers each) + cross attention
            total += self.n_layers * (attn_params() + dense_ffn(self.d_ff))
            total += self.n_layers * (2 * attn_params() + dense_ffn(self.d_ff))
        if self.mtp:
            total += attn_params() + dense_ffn(self.d_ff) + 2 * d * d
        return total

    def active_param_count(self) -> int:
        """Active (per-token) parameters -- MoE uses top-k experts only."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        total = self.param_count()
        n_moe = self.n_layers - m.n_dense_layers
        mult = 3 if self.mlp == "gated_silu" else 2
        all_experts = n_moe * m.n_experts * mult * self.d_model * m.d_ff_expert
        active_experts = n_moe * m.experts_per_token * mult * \
            self.d_model * m.d_ff_expert
        return total - all_experts + active_experts


def n_hybrid_attn_applications(cfg: ModelConfig) -> int:
    """zamba2: shared attention applied every attn_period-th layer slot."""
    return cfg.n_layers // cfg.hybrid.attn_period


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Brief rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full-attention arch has no "
                       "sub-quadratic mode (DESIGN.md section 6)")
    return True, ""

"""Model configuration for the PyTorch port (a copy of ``repro.configs.base``).

Every architecture module in this package defines a ``CONFIG`` (full size,
exact published values) and a ``SMOKE_CONFIG`` (same family, tiny dims) used
by CPU tests.  The fields and defaults match the JAX package's
``ModelConfig`` one for one, so a config built here describes the same model
as its namesake there.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

Family = Literal["dense", "moe", "rwkv6", "griffin", "encdec"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 1
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0
    seq_groups: int = 16
    router_aux_coef: float = 0.001
    router_z_coef: float = 0.0001


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class GriffinConfig:
    lru_width: int = 0
    conv_width: int = 4
    window: int = 2048
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    c: float = 8.0


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    ddlerp_rank: int = 32
    decay_rank: int = 64
    gate_rank: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    num_encoder_layers: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()
    use_mla: bool = False
    mla: MLAConfig = field(default_factory=MLAConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    griffin: GriffinConfig = field(default_factory=GriffinConfig)
    rwkv: RWKVConfig = field(default_factory=RWKVConfig)
    mlp_kind: Literal["swiglu", "relu2", "geglu"] = "swiglu"
    norm_kind: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-6
    vocab_pad_to: int = 256
    tie_embeddings: bool = False
    scale_emb: float = 1.0
    scale_depth: float = 0.0
    dim_model_base: int = 0
    input_kind: Literal["tokens", "embeds", "embeds_mrope"] = "tokens"
    attn_impl: Literal["naive", "chunked", "pallas"] = "chunked"
    kernels_impl: Literal["xla", "pallas", "pallas_interpret"] = "xla"
    attn_kv_chunk: int = 1024
    remat: Literal["none", "full", "dots"] = "full"
    scan_unroll: bool = False
    logits_chunk: int = 512
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    sharding_overrides: dict[str, tuple[str, ...] | None] = field(default_factory=dict)
    supports_long_context: bool = False
    notes: str = ""

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def lru_width(self) -> int:
        return self.griffin.lru_width or self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dryrun's cells (JAX ``ShapeConfig``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclass(frozen=True)
class ArchEntry:
    config: ModelConfig
    smoke_config: ModelConfig


def register(config: ModelConfig, smoke_config: ModelConfig) -> None:
    _REGISTRY[config.name] = ArchEntry(config, smoke_config)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    entry = _REGISTRY.get(name)
    if entry is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return entry.smoke_config if smoke else entry.config


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    """The shapes of ``cfg``'s dryrun cells: ``long_500k`` only for the
    sub-quadratic archs."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or cfg.supports_long_context]


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib

    # the dense GQA archs (with qwen2-vl's M-RoPE and embeds inputs), MoE,
    # MLA over MoE, RWKV-6, Griffin and the encoder-decoder
    for mod in ("qwen2_0_5b", "qwen3_14b", "qwen2_vl_7b", "minitron_4b",
                "minicpm_2b", "phi35_moe_42b", "deepseek_v2_lite_16b", "rwkv6_3b",
                "recurrentgemma_9b", "seamless_m4t_large_v2"):
        importlib.import_module(f"repro_torch.configs.{mod}")

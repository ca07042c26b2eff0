"""Per-(arch, shape-kind) logical-axis rule tables — the sharding profiles,
copied from ``repro.parallel.profiles``.

* ``fsdp_cp`` (train / prefill default): weights 2-D sharded
  (``embed_w`` -> data, TP dims -> model = ZeRO-3 x TP storage); activations
  batch-sharded over (pod, data) and *sequence*-sharded over model (context /
  sequence parallelism).  Attention gathers KV (``seq_kv`` -> replicated);
  linear-recurrence archs chunk-scan over the sharded sequence.  This profile
  has no head-divisibility constraints.

* ``tp_sp`` (classic Megatron TP + sequence parallelism): attention heads and
  MLP hidden sharded over model; residual stream sequence-sharded.  Valid only
  when both H and KV divide the model axis.

* ``decode``: weights tensor-parallel over model (no FSDP dim — decode cannot
  afford per-token param gathers), KV-cache time dim sharded over model,
  everything else replicated (S=1 activations are tiny).

The port trains under the Megatron split of ``models.split`` (each family's
sliced axes over ``model``, the vocabulary among them at pp = 1, the
leaves of ``KEPT_WHOLE`` and everything else replicated, the batch over
``data``); FSDP weight storage under ``embed_w ->
data`` and sharded serving under ``decode`` are ROADMAP item 8c.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import AxisRules

_COMMON_WEIGHTS = {
    "heads_w": ("model",),
    "kv_heads_w": ("model",),
    "head_dim_w": ("model",),
    "qkv": ("model",),
    "mlp_w": ("model",),
    "vocab_w": ("model",),
    "expert_w": ("model",),
    "expert_mlp": None,
    "kv_lora_w": None,
    "conv": None,
    "layers": None,
    "stack": None,
}

_COMMON_ACTS = {
    "embed_act": None,
    "heads_act": None,
    "kv_heads_act": None,
    "head_dim_act": None,
    "mlp_act": None,
    "kv_lora_act": None,
    "state": None,
    "seq_ce": None,
    "vocab_act": ("model",),
    "moe_cap": None,
    "expert_pre": None,
    "expert_act": ("model",),
}

FSDP_CP: dict = {
    **_COMMON_WEIGHTS,
    **_COMMON_ACTS,
    "embed_w": ("data",),
    "batch": ("pod", "data"),
    "seq_act": ("model",),
    "seq": ("model",),
    "seq_kv": None,
    "kv_time": ("model",),
    # CE: batch stays on data axes so the vocab dim keeps the model axis
    "ce_batch": ("pod", "data"),
    "moe_groups": ("pod", "data", "model"),
    "moe_groups_post": ("pod", "data"),
}

TP_SP: dict = {
    **_COMMON_WEIGHTS,
    **_COMMON_ACTS,
    "embed_w": ("data",),
    "batch": ("pod", "data"),
    "seq_act": ("model",),
    "seq": None,
    "seq_kv": None,
    "heads_act": ("model",),
    "kv_heads_act": ("model",),
    "mlp_act": ("model",),
    "kv_time": ("model",),
    "ce_batch": ("pod", "data"),
    "moe_groups": ("pod", "data", "model"),
    "moe_groups_post": ("pod", "data"),
}

DECODE: dict = {
    **_COMMON_WEIGHTS,
    **_COMMON_ACTS,
    "embed_w": None,
    "batch": ("pod", "data"),
    "seq_act": None,
    "seq": None,
    "seq_kv": None,
    "kv_time": ("model",),
    "ce_batch": ("pod", "data"),
    "moe_groups": ("pod", "data"),
    "moe_groups_post": ("pod", "data"),
}


def profile_name(cfg: ModelConfig, shape_kind: str) -> str:
    if shape_kind == "decode":
        return "decode"
    return "fsdp_cp"


def rules_for(
    cfg: ModelConfig, shape_kind: str, profile: str | None = None
) -> AxisRules:
    name = profile or profile_name(cfg, shape_kind)
    base = {"fsdp_cp": FSDP_CP, "tp_sp": TP_SP, "decode": DECODE}[name]
    rules = dict(base)
    ov = cfg.sharding_overrides
    if ov and all(isinstance(v, dict) for v in ov.values()):
        # per-shape-kind overrides: {"train": {...}, "prefill": {...}, ...}
        rules.update(ov.get(shape_kind, {}))
    else:
        rules.update(ov)
    return rules

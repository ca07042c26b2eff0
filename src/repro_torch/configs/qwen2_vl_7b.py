"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (multimodal 3-D rotary: temporal/height/width sections 16/24/24 on
head_dim 128) + dynamic resolution [arXiv:2409.12191].  The vision frontend is
not modelled: a batch carries precomputed patch embeddings (``embeds``) and
the 3-component M-RoPE position ids.  The same values as
``repro.configs.qwen2_vl_7b``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    input_kind="embeds_mrope",
    notes="M-RoPE sections (t,h,w)=(16,24,24); patch-embedding frontend stub.",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen2-vl-7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    mrope_sections=(2, 3, 3),
    attn_kv_chunk=32,
    logits_chunk=16,
)

register(CONFIG, SMOKE_CONFIG)

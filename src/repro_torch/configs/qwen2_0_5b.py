"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.

GQA with QKV bias [arXiv:2407.10671].  head_dim = 896/14 = 64.  The same
values as ``repro.configs.qwen2_0_5b``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    notes="GQA kv=2 with QKV bias; tied embeddings.",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen2-0.5b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    attn_kv_chunk=32,
    logits_chunk=16,
)

register(CONFIG, SMOKE_CONFIG)

"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

Qwen3: per-head-dim RMSNorm on Q and K (qk_norm), GQA, no QKV bias.  The same
values as ``repro.configs.qwen3_14b``; in this slice its smoke config is the
parity case for the qk_norm branch of the paged attention block.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    notes="qk_norm + GQA.",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-14b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    attn_kv_chunk=32,
    logits_chunk=16,
)

register(CONFIG, SMOKE_CONFIG)

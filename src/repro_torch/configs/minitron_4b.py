"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

Pruned Nemotron [arXiv:2407.14679]: squared-ReLU (non-gated) MLP, no biases.
The same values as ``repro.configs.minitron_4b``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_kind="relu2",
    rope_theta=10000.0,
    notes="Nemotron-style squared-ReLU MLP (non-gated).",
)

SMOKE_CONFIG = CONFIG.replace(
    name="minitron-4b-smoke",
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

"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.

RWKV-6 with data-dependent decay [arXiv:2404.05892].  head_size=64 -> 40 WKV
heads.  The same values as ``repro.configs.rwkv6_3b`` without its
``sharding_overrides``, which place the recurrence on a TPU mesh and mean
nothing on one card.
"""

from repro_torch.configs.base import ModelConfig, RWKVConfig, register

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv6",
    num_layers=32,
    d_model=2560,
    num_heads=40,             # d_model / head_size
    num_kv_heads=40,
    head_dim=64,              # rwkv head_size
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVConfig(head_size=64, ddlerp_rank=32, decay_rank=64),
    supports_long_context=True,
    notes="Attention-free; MegaScope attention views replaced by WKV state probes.",
)

SMOKE_CONFIG = CONFIG.replace(
    name="rwkv6-3b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    rwkv=RWKVConfig(head_size=16, ddlerp_rank=8, decay_rank=16),
    logits_chunk=16,
)

register(CONFIG, SMOKE_CONFIG)

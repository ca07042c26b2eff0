"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.

Griffin recipe [arXiv:2402.19427]: the block pattern (rec, rec, attn), two
RG-LRU recurrent blocks per local-attention block, local window 2048, conv1d
width 4, lru_width = d_model, GeGLU MLP; 38 layers = 12 full groups + 2
trailing rec blocks.  The same values as ``repro.configs.recurrentgemma_9b``,
its ``sharding_overrides`` included (``parallel.profiles.rules_for`` reads
them).
"""

from repro_torch.configs.base import GriffinConfig, ModelConfig, register

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="griffin",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp_kind="geglu",
    griffin=GriffinConfig(lru_width=0, conv_width=4, window=2048,
                          pattern=("rec", "rec", "attn"), c=8.0),
    rope_theta=10000.0,
    supports_long_context=True,
    # the batch takes the model axis where it divides (a device-local
    # recurrence); otherwise the size-aware resolver leaves model free and
    # seq_act claims it (the JAX package's state-passing context parallelism)
    sharding_overrides={
        "train": {
            "batch": ("pod", "data", "model"),
            "seq_act": ("model",),
            "seq": ("model",),
        },
    },
    notes="RG-LRU + local attention 1:2; O(1) recurrent state + 2048-window KV.",
)

SMOKE_CONFIG = CONFIG.replace(
    name="recurrentgemma-9b-smoke",
    num_layers=4,              # (rec, rec, attn, rec)
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    griffin=GriffinConfig(lru_width=0, conv_width=4, window=32,
                          pattern=("rec", "rec", "attn"), c=8.0),
    attn_kv_chunk=32,
    logits_chunk=16,
)

register(CONFIG, SMOKE_CONFIG)

"""seamless-m4t-large-v2 [audio] — enc-dec, d_model=1024 16H d_ff=8192 vocab=256206.

Encoder-decoder multimodal backbone [arXiv:2308.11596].  "24L" is read as
24 encoder + 24 decoder layers (the checkpoint's speech-encoder/text-decoder
depths).  The audio frontend is a stub: the encoder takes precomputed frame
embeddings.  LayerNorm + GeGLU per the m4t family; RoPE replaces the
original positional scheme for uniformity.
The same values as ``repro.configs.seamless_m4t_large_v2``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,             # decoder layers
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp_kind="geglu",
    norm_kind="layernorm",
    rope_theta=10000.0,
    input_kind="embeds",       # encoder consumes precomputed audio-frame embeddings
    notes="enc-dec; audio frontend stubbed with frame embeddings.",
)

SMOKE_CONFIG = CONFIG.replace(
    name="seamless-m4t-large-v2-smoke",
    num_layers=2,
    num_encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    attn_kv_chunk=32,
    logits_chunk=16,
)

register(CONFIG, SMOKE_CONFIG)

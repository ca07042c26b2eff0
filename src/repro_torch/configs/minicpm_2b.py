"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753.

MiniCPM [arXiv:2404.06395]: llama-like with MHA (kv=36), depth-scaled residual
(scale_depth=1.4), embedding scale 12, logits scaled by d_model/dim_model_base,
tied embeddings.  Trained with the WSD schedule (see repro/train/optim.py).
The same values as ``repro.configs.minicpm_2b``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_emb=12.0,
    scale_depth=1.4,
    dim_model_base=256,
    notes="WSD schedule; depth-scaled residuals; tied embeddings.",
)

SMOKE_CONFIG = CONFIG.replace(
    name="minicpm-2b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=257,
    attn_kv_chunk=32,
    logits_chunk=16,
)

register(CONFIG, SMOKE_CONFIG)

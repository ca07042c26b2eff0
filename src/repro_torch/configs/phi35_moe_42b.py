"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064.

16 experts, top-2 routing, SwiGLU experts, no shared expert
[hf:microsoft/Phi-3.5-MoE-instruct].
The same values as ``repro.configs.phi35_moe_42b``.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(
        num_experts=16,
        num_shared_experts=0,
        top_k=2,
        expert_d_ff=6400,
        capacity_factor=1.25,
        first_k_dense=0,
    ),
    rope_theta=10000.0,
    notes="16e top-2 SwiGLU experts; all layers MoE.",
)

SMOKE_CONFIG = CONFIG.replace(
    name="phi3.5-moe-42b-a6.6b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    moe=MoEConfig(
        num_experts=4,
        num_shared_experts=0,
        top_k=2,
        expert_d_ff=64,
        capacity_factor=1.5,
        first_k_dense=0,
    ),
    attn_kv_chunk=32,
    logits_chunk=16,
)

register(CONFIG, SMOKE_CONFIG)

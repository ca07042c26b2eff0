"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff(expert)=1408 vocab=102400.

MLA (kv_lora_rank=512, no query compression) + MoE: 64 routed experts top-6 and
2 shared experts [arXiv:2405.04434].  Layer 0 uses a dense MLP
(first_k_dense_replace=1, intermediate size 10944 as the published config).
The same values as ``repro.configs.deepseek_v2_lite_16b``.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,          # MLA: all heads share the compressed latent
    head_dim=128,             # v_head_dim / qk_nope_head_dim
    d_ff=10944,               # dense (first_k_dense) MLP width
    vocab_size=102400,
    use_mla=True,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        expert_d_ff=1408,
        capacity_factor=1.25,
        first_k_dense=1,
    ),
    rope_theta=10000.0,
    notes="MLA compressed-KV cache at decode; EP over the model axis.",
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-v2-lite-16b-smoke",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    mla=MLAConfig(
        kv_lora_rank=32,
        q_lora_rank=0,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    moe=MoEConfig(
        num_experts=4,
        num_shared_experts=1,
        top_k=2,
        expert_d_ff=64,
        capacity_factor=1.5,
        first_k_dense=1,
    ),
    attn_kv_chunk=32,
    logits_chunk=16,
)

register(CONFIG, SMOKE_CONFIG)

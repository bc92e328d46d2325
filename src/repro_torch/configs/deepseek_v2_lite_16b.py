"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64-expert top-6 MoE with
2 shared experts.  [arXiv:2405.04434; hf]
27L d_model=2048 16H d_ff_expert=1408 vocab=102400.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-lite-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=192, d_ff=1408, vocab_size=102_400,
        attn_kind="mla", act="swiglu",
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared_experts=2, d_ff_shared=2816),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=24, d_ff=64, vocab_size=256,
        attn_kind="mla", act="swiglu", remat="none",
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      num_shared_experts=1, d_ff_shared=64),
    )

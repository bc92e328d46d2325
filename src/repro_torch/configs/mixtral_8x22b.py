"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "mixtral-8x22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=32_768,
        attn_kind="swa", window=4096, act="swiglu", subquadratic=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        attn_kind="swa", window=8, act="swiglu", subquadratic=True,
        remat="none",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )

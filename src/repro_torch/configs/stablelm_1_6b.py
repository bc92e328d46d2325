"""stablelm-1.6b [dense] — MHA (kv == heads), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b; unverified]
24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "stablelm-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=5632, vocab_size=100_352,
        attn_kind="full", act="swiglu", norm="layernorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        attn_kind="full", act="swiglu", norm="layernorm", remat="none",
    )

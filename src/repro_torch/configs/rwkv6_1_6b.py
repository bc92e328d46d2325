"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]
24L d_model=2048 d_ff=7168 vocab=65536.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

ARCH_ID = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=7168, vocab_size=65_536,
        attn_kind="none", act="relu", norm="layernorm", subquadratic=True,
        rwkv=RWKVConfig(head_size=64, decay_lora=64),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        attn_kind="none", act="relu", norm="layernorm", subquadratic=True,
        remat="none",
        rwkv=RWKVConfig(head_size=16, decay_lora=8),
    )

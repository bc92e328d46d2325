"""mistral-nemo-12b [dense] — 128k-context full attention.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "mistral-nemo-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=131_072,
        attn_kind="full", act="swiglu", rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        attn_kind="full", act="swiglu", remat="none",
    )

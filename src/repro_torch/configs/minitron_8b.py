"""minitron-8b [dense] — pruned nemotron (squared-ReLU-family MLP -> relu).
[arXiv:2407.14679; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "minitron-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=256_000,
        attn_kind="full", act="relu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        attn_kind="full", act="relu", remat="none",
    )

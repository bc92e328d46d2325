"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427; hf]  26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

ARCH_ID = "recurrentgemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256_000,
        attn_kind="local", window=2048, act="geglu",
        tie_embeddings=True, scale_embed=True, subquadratic=True,
        rglru=RGLRUConfig(lru_width=2560, conv1d_width=4,
                          attention_window=2048),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=256,
        attn_kind="local", window=8, act="geglu",
        tie_embeddings=True, scale_embed=True, subquadratic=True, remat="none",
        rglru=RGLRUConfig(lru_width=64, conv1d_width=4, attention_window=8),
    )

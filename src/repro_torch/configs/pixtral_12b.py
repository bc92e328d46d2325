"""pixtral-12b [vlm] — mistral-nemo-12b backbone + stub pixtral-ViT frontend
(input_specs provides precomputed patch embeddings).
[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

ARCH_ID = "pixtral-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=131_072,
        attn_kind="full", act="swiglu", rope_theta=1e6,
        vlm=VLMConfig(num_image_tokens=1024),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        attn_kind="full", act="swiglu", remat="none",
        vlm=VLMConfig(num_image_tokens=8),
    )

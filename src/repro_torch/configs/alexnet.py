"""AlexNet — the paper's own primary benchmark network (Table II).

Not part of the assigned 10-arch pool; included because the paper's
evaluation (Figs. 4-8) centres on it.  family="cnn" is handled by the
benchmark/equivalence harness rather than the LM registry.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "alexnet"


def config() -> ModelConfig:
    # CNN configs reuse ModelConfig loosely: d_model == input resolution,
    # vocab_size == classes.  See repro_torch.models.cnn for the real structure.
    return ModelConfig(
        name=ARCH_ID, family="cnn",
        num_layers=8, d_model=224, num_heads=1, num_kv_heads=1,
        d_ff=4096, vocab_size=1000, attn_kind="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="tinycnn", family="cnn",
        num_layers=4, d_model=16, num_heads=1, num_kv_heads=1,
        d_ff=64, vocab_size=10, attn_kind="full",
    )

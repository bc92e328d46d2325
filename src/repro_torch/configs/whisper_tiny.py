"""whisper-tiny [audio] — enc-dec backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings).  [arXiv:2212.04356]
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

ARCH_ID = "whisper-tiny"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec",
        num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
        head_dim=64, d_ff=1536, vocab_size=51_865,
        attn_kind="full", qkv_bias=True, act="gelu", norm="layernorm",
        tie_embeddings=True,
        encdec=EncDecConfig(num_encoder_layers=4, encoder_seq_len=1500),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        attn_kind="full", qkv_bias=True, act="gelu", norm="layernorm",
        tie_embeddings=True, remat="none",
        encdec=EncDecConfig(num_encoder_layers=2, encoder_seq_len=24),
    )

"""Architecture configs: the 10 assigned archs + the paper's AlexNet, and
the port's own archs (``PORT_ARCHS``: no JAX counterpart)."""
from repro_torch.configs import (alexnet, deepseek_v2_lite_16b,
                                 k_exaone_236b_a23b, minitron_8b,
                                 mistral_nemo_12b, mixtral_8x22b, pixtral_12b,
                                 qwen25_14b, recurrentgemma_2b, rwkv6_1_6b,
                                 stablelm_1_6b, whisper_tiny)
from repro_torch.configs.base import (MeshConfig, ModelConfig, OptimizerConfig,
                                RunConfig, ServeConfig, ShapeConfig,
                                MULTI_POD, SINGLE_POD)
from repro_torch.configs.shapes import SHAPES, get_shape

_MODULES = (recurrentgemma_2b, qwen25_14b, stablelm_1_6b, minitron_8b,
            mistral_nemo_12b, deepseek_v2_lite_16b, mixtral_8x22b,
            whisper_tiny, rwkv6_1_6b, pixtral_12b)

ARCHS = {m.ARCH_ID: m for m in _MODULES}
ALL_ARCHS = tuple(ARCHS)

#: archs of the port alone: id -> (config, smoke config); K-EXAONE whole
#: and one card's share of its 16-way expert-parallel deployment
_kx = k_exaone_236b_a23b
PORT_ARCHS = {
    _kx.ARCH_ID: (_kx.config, _kx.smoke_config),
    _kx.SHARE_ID: (_kx.share_config, _kx.share_smoke_config),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in (alexnet.ARCH_ID, "tinycnn"):
        return alexnet.smoke_config() if (smoke or arch == "tinycnn") \
            else alexnet.config()
    if arch == "examples-lm-100m":
        # ~120M-param dense LM for the end-to-end example driver
        return ModelConfig(
            name=arch, family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32_000, attn_kind="full", act="swiglu",
            compute_dtype="float32", remat="none")
    if arch in PORT_ARCHS:
        full, small = PORT_ARCHS[arch]
        return small().replace(compute_dtype="float32") if smoke else full()
    try:
        mod = ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{sorted(ARCHS) + sorted(PORT_ARCHS)}") from None
    if smoke:
        # smoke configs run in fp32 (the JAX package's smoke convention,
        # kept so the two packages compare like with like); full configs
        # keep bf16.
        return mod.smoke_config().replace(compute_dtype="float32")
    return mod.config()

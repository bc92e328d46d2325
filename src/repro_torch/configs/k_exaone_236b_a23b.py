"""k-exaone-236b-a23b [moe] — windowed and global attention side by side
(``LLLG``: 36 layers on a 128-token window with rope, 12 global layers
without positional encoding), per-head q/k RMS norms, the norms after each
sublayer (EXAONE 4's block), a dense first layer of 18,432, then 47 MoE
layers of 128 experts of 2,048 with a sigmoid router (top-8, correction
bias, gates normalised and scaled by 2.5) and one shared expert.
[hf:LGAI-EXAONE/K-EXAONE-236B-A23B config.json]
48L d_model=6144 64H (GQA kv=8, head_dim 128) vocab=153600.

Two ids:

* ``ARCH_ID`` — the published model, every expert held (236.6 B
  parameters without its multi-token-prediction layer, which this port
  leaves out: it serves no decode step without speculation);
* ``SHARE_ID`` — one card's share of a deployment in which 16 cards share
  each MoE layer by expert parallelism: experts 0-7 of each layer are
  held here, the router keeps its 128 outputs and its top-8, and
  attention, the dense layer, the shared expert and the vocabulary are
  whole, as with data-parallel attention (23.67 B parameters).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "k-exaone-236b-a23b"
SHARE_ID = ARCH_ID + "-ep16"
#: cards that share each MoE layer, and the experts each holds
EP_CARDS, EXPERTS_HELD = 16, 8


def config(experts_held: int = 0) -> ModelConfig:
    return ModelConfig(
        name=SHARE_ID if experts_held else ARCH_ID, family="moe",
        num_layers=48, d_model=6144, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=2048, vocab_size=153_600,
        attn_kind="swa", window=128, layer_pattern="LLLG",
        act="swiglu", rope_theta=1e6, norm_eps=1e-5,
        qk_norm=True, norm_placement="post", rope_layers="windowed",
        first_dense_layers=1, d_ff_dense=18_432,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=2048,
                      num_shared_experts=1, d_ff_shared=2048,
                      scoring="sigmoid", correction_bias=True,
                      routed_scaling=2.5, experts_held=experts_held),
    )


def share_config() -> ModelConfig:
    return config(EXPERTS_HELD)


def smoke_config(experts_held: int = 0) -> ModelConfig:
    """8 layers (two periods of ``LLLG``, the first dense), a window of 8;
    32 experts, top-4: at ``experts_held`` 2 the experts form 16 shares,
    as the deployment's 128 do."""
    return ModelConfig(
        name=(SHARE_ID if experts_held else ARCH_ID) + "-smoke",
        family="moe", num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=256,
        attn_kind="swa", window=8, layer_pattern="LLLG",
        act="swiglu", rope_theta=1e6, norm_eps=1e-5, remat="none",
        qk_norm=True, norm_placement="post", rope_layers="windowed",
        first_dense_layers=1, d_ff_dense=96,
        moe=MoEConfig(num_experts=32, top_k=4, d_ff_expert=32,
                      num_shared_experts=1, d_ff_shared=32,
                      scoring="sigmoid", correction_bias=True,
                      routed_scaling=2.5, experts_held=experts_held),
    )


def share_smoke_config() -> ModelConfig:
    return smoke_config(2)

"""Each plain reference against the program's plain path (float32, no
kernels) at the smoke sizes, on the weights the benchmark makes."""
import pytest
import torch

from bench.core.weights import make_weights, shape_mismatches
from bench.reference import dense, mla_moe
from repro_torch.configs import get_config
from repro_torch.models import registry
from repro_torch.models.transformer import lm_forward, lm_head


def hf_keys(mc):
    """The reference's configuration keys from the program's config."""
    cfg = {"hidden_size": mc.d_model, "num_hidden_layers": mc.num_layers,
           "num_attention_heads": mc.num_heads, "vocab_size": mc.vocab_size,
           "rope_theta": mc.rope_theta, "rms_norm_eps": mc.norm_eps}
    if mc.mla is None:
        cfg.update(num_key_value_heads=mc.num_kv_heads,
                   head_dim=mc.resolved_head_dim, intermediate_size=mc.d_ff)
    else:
        m, e = mc.mla, mc.moe
        cfg.update(kv_lora_rank=m.kv_lora_rank,
                   qk_nope_head_dim=m.qk_nope_head_dim,
                   qk_rope_head_dim=m.qk_rope_head_dim,
                   v_head_dim=m.v_head_dim, n_routed_experts=e.num_experts,
                   num_experts_per_tok=e.top_k,
                   moe_intermediate_size=e.d_ff_expert,
                   n_shared_experts=e.d_ff_shared // e.d_ff_expert)
    return cfg


@pytest.mark.parametrize("arch,ref", [("qwen2.5-14b", dense),
                                      ("deepseek-v2-lite-16b", mla_moe)])
def test_reference_matches_program(arch, ref):
    mc = get_config(arch, smoke=True).replace(compute_dtype="float32")
    cfg = hf_keys(mc)
    shapes = ref.param_shapes(cfg)
    bundle = registry.build(mc)
    assert shape_mismatches(shapes, bundle.specs) == []
    w = make_weights(shapes, ref.leaf_std, 1234, "cpu", torch.float32)
    g = torch.Generator().manual_seed(5)
    seqs = [torch.randint(0, cfg["vocab_size"], (n,), generator=g).tolist()
            for n in (37, 64)]
    want = [list(range(len(s))) for s in seqs]
    got = ref.logits_at(cfg, w, seqs, want)
    for s, r in zip(seqs, got):
        x, _, _ = lm_forward(mc, w, torch.tensor([s]), collect_cache=True,
                             cache_len=len(s), moe_dropless=True)
        prog = lm_head(mc, w, x)[0].float()
        assert r.shape == prog.shape
        torch.testing.assert_close(r, prog, rtol=1e-4, atol=1e-4)


def test_mla_reference_refuses_scaled_rope():
    """The configuration's yarn group at factor 1 is unscaled rope, which
    the reference computes; the published factor of 40 is refused."""
    import json
    from pathlib import Path
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / "deepseek-v2-lite-16b.json").read_text())
    mla_moe.plain_rope(cfg)
    mla_moe.plain_rope({**cfg, "rope_scaling": None})
    with pytest.raises(ValueError):
        mla_moe.plain_rope({**cfg, "rope_scaling":
                            cfg["published"]["rope_scaling"]})

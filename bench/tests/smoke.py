"""Smoke-size cells for the CPU tests: the program's smoke configurations
as configuration files, and a small traffic mix of each kind."""
from repro_torch.configs import get_config


def config(arch: str, limit: float = 0.5) -> dict:
    """A configuration file for the smoke variant of ``arch``."""
    mc = get_config(arch, smoke=True)
    cfg = {"arch": arch, "dtype": "bfloat16",
           "reference": "dense" if mc.mla is None else "mla_moe",
           "hidden_size": mc.d_model, "num_hidden_layers": mc.num_layers,
           "num_attention_heads": mc.num_heads, "vocab_size": mc.vocab_size,
           "rope_theta": mc.rope_theta, "rms_norm_eps": mc.norm_eps,
           "check": {"logit_gap": limit, "mean_gap": limit}}
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


SERVE = {"max_batch": 4, "max_seq_len": 256, "page_size": 8,
         "prefill_chunk_tokens": 32, "enable_spec": False}


def chat(rate: float = 3.0) -> dict:
    return {"arrivals": {"kind": "poisson", "rate_per_s": rate},
            "turns": {"min": 2, "max": 3}, "history": True,
            "shared_prefix_tokens": 40,
            "user_tokens": {"median": 12, "sigma": 0.5, "min": 4, "max": 30},
            "answer_tokens": {"median": 6, "sigma": 0.3, "min": 3, "max": 9},
            "think_s": {"mean": 0.05}, "base_seed": 0, "preroll_s": 0.3,
            "serve": dict(SERVE), "check": {"max_requests": 4}}


def batch(clients: int = 4) -> dict:
    return {"arrivals": {"kind": "closed", "clients": clients},
            "turns": {"min": 8, "max": 8}, "history": False,
            "shared_prefix_tokens": 0,
            "user_tokens": {"median": 20, "sigma": 0.5, "min": 8, "max": 60},
            "answer_tokens": {"median": 8, "sigma": 0.3, "min": 4, "max": 16},
            "think_s": {"mean": 0.0}, "base_seed": 0, "preroll_s": 0.3,
            "serve": dict(SERVE), "check": {"max_requests": 3}}


def spec(config_: dict, traffic: dict, e2e=(), per_layer=()) -> dict:
    from pathlib import Path
    return {"root": Path(__file__).resolve().parents[2],
            "workload": {"name": "smoke", "chips": 1}, "config": config_,
            "traffic": traffic, "end_to_end": list(e2e),
            "per_layer": list(per_layer)}

"""The port's configs equal the JAX package's, field by field.

``repro_torch.configs`` is a copy of ``repro.configs`` (pure dataclasses
with construction-time validation); every preset, smoke and full, must
resolve to the same values in both packages.  ``ServeConfig`` differs in
one renamed knob — the JAX ``use_pallas`` is the port's ``use_kernels`` —
and one knob of the port's own, ``decode_graphs`` (CUDA graphs stand
where the JAX engine jits its decode scans).
"""
import dataclasses

import pytest

from repro import configs as jax_configs
from repro_torch import configs as torch_configs

ARCHS = sorted(jax_configs.ARCHS) + ["alexnet", "tinycnn", "examples-lm-100m"]

#: the port's own model fields (a model of windowed and global layers, a
#: sigmoid router over held experts: K-EXAONE) and the values that leave
#: the reference's models as they are
PORT_FIELDS = {"layer_pattern": "", "qk_norm": False,
               "norm_placement": "pre", "rope_layers": "all",
               "first_dense_layers": 0, "d_ff_dense": 0}
PORT_MOE_FIELDS = {"scoring": "softmax", "correction_bias": False,
                   "routed_scaling": 1.0, "experts_held": 0}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_config_matches_reference(arch, smoke):
    ref = jax_configs.get_config(arch, smoke=smoke)
    port = torch_configs.get_config(arch, smoke=smoke)
    assert type(port).__name__ == type(ref).__name__
    got = dataclasses.asdict(port)
    assert {k: got.pop(k) for k in PORT_FIELDS} == PORT_FIELDS
    if got["moe"] is not None:
        assert {k: got["moe"].pop(k) for k in PORT_MOE_FIELDS} == \
            PORT_MOE_FIELDS
    assert got == dataclasses.asdict(ref)


def test_serve_config_defaults_match_reference():
    ref = dataclasses.asdict(jax_configs.ServeConfig())
    port = dataclasses.asdict(torch_configs.ServeConfig())
    assert ref.pop("use_pallas") is None and port.pop("use_kernels") is None
    assert port.pop("decode_graphs") is None
    assert port == ref
    with pytest.raises(ValueError, match="use_kernels"):
        torch_configs.ServeConfig(use_kernels=1)
    with pytest.raises(ValueError, match="decode_graphs"):
        torch_configs.ServeConfig(decode_graphs=1)
    with pytest.raises(ValueError, match="page_size"):
        torch_configs.ServeConfig(page_size=12)

"""The engine's decode cycle as one dispatch: what the CPU can hold.

A CUDA graph captures the decode body only if it never syncs the host and
no op's output shape depends on the data.  ``NoSync`` (a dispatch mode)
raises on both; every decode cycle of short smoke drives runs under it —
qwen on the paged pool (greedy, sampled, int8 pages) and the slotted pool
(greedy, sampled), deepseek (MLA + MoE) and mixtral (ring pages + MoE) on
the paged pool, recurrentgemma and rwkv6 on the slotted pool.  MoE decodes
on its dense route, held here to the JAX package's
``moe_apply(per_token=True)`` on the same weights (atol 1e-5, the same
fp32 math summed in another order, as ``tests/test_torch_moe.py``).  Then
``ServeConfig.decode_graphs`` as the engine resolves it, and the launch
tally a capture keeps for its replays.  Capture and replay themselves need
the card: ``tests/test_torch_cuda_graphs.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config
from repro.models import moe as jax_moe
from repro.models import registry as jax_registry
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs.base import MeshConfig, ServeConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import common as kcommon
from repro_torch.models import moe as port_moe
from repro_torch.serving import SamplingParams
from repro_torch.serving.engine import ServingEngine, resolve_decode_graphs

#: ops whose output shape depends on the data (and so read it back)
_DATA_SHAPED = {"nonzero", "unique", "unique_dim", "_unique", "_unique2",
                "unique_consecutive", "unique_dim_consecutive",
                "masked_select", "bincount", "is_nonzero", "equal"}


class NoSync(TorchDispatchMode):
    """Raise on a host read of a device value (``_local_scalar_dense``:
    ``item``, ``int``, ``bool``) and on every op whose output shape depends
    on the data, boolean indexing included.  Counts the ops it passes."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        bool_index = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 else ()) or ())
        tensor_repeats = (name == "repeat_interleave"
                          and func._overloadname in ("Tensor", "self_Tensor"))
        if (name == "_local_scalar_dense" or name in _DATA_SHAPED
                or bool_index or tensor_repeats):
            raise AssertionError(f"{func} in the decode body: a host sync or "
                                 "a data-dependent shape, which a CUDA graph "
                                 "cannot capture")
        self.ops += 1
        return func(*args, **kwargs)


#: (arch, ServeConfig overrides, sampled): every family on the pools it
#: serves from, greedy and sampled (int8 pages change the attention, not the
#: sampler: greedy); mixtral's smoke window 8 wants ring pages of 4
_MIXTRAL = {"page_size": 4, "num_pages": 40}
#: K-EXAONE's share on the two-kind pool (rings of 2 cells of 4), which
#: has no prefix cache or speculation yet
_KEXAONE = {"page_size": 4, "enable_prefix_cache": False,
            "enable_spec": False}
CASES = {
    "qwen-paged-greedy": ("qwen2.5-14b", {}, False),
    "qwen-paged-sampled": ("qwen2.5-14b", {}, True),
    "qwen-paged-int8": ("qwen2.5-14b", {"kv_dtype": "int8"}, False),
    "qwen-slotted-greedy": ("qwen2.5-14b", {"kv_layout": "slotted"}, False),
    "qwen-slotted-sampled": ("qwen2.5-14b", {"kv_layout": "slotted"}, True),
    "deepseek-paged-greedy": ("deepseek-v2-lite-16b", {}, False),
    "deepseek-paged-sampled": ("deepseek-v2-lite-16b", {}, True),
    "mixtral-paged-greedy": ("mixtral-8x22b", _MIXTRAL, False),
    "mixtral-paged-sampled": ("mixtral-8x22b", _MIXTRAL, True),
    "mixtral-paged-int8": ("mixtral-8x22b", {**_MIXTRAL, "kv_dtype": "int8"},
                           False),
    "recurrentgemma-slotted-greedy": ("recurrentgemma-2b", {}, False),
    "recurrentgemma-slotted-sampled": ("recurrentgemma-2b", {}, True),
    "rwkv6-slotted-greedy": ("rwkv6-1.6b", {}, False),
    "rwkv6-slotted-sampled": ("rwkv6-1.6b", {}, True),
    "kexaone-paged-greedy": ("k-exaone-236b-a23b-ep16", _KEXAONE, False),
    "kexaone-paged-sampled": ("k-exaone-236b-a23b-ep16", _KEXAONE, True),
}
SAMPLED = SamplingParams(temperature=0.8, top_k=8, top_p=0.9, seed=13)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_cycle_never_syncs_the_host(case):
    """Every decode cycle of a short drive runs under ``NoSync``; a sampled
    drive's cycles take the sampler (one request greedy beside it)."""
    arch, kw, sampled = CASES[case]
    cfg = port_get_config(arch, smoke=True)
    eng = ServingEngine(cfg, ServeConfig(max_batch=2, max_seq_len=32,
                                         decode_steps=2, **kw),
                        seed=0, device="cpu")
    assert eng.decode_graphs is False
    modes, kinds = [], []
    real = eng._decode

    def guarded(ops):
        kinds.append("samp" in ops)
        with NoSync() as mode:
            out = real(ops)
        modes.append(mode)
        return out

    eng._decode = guarded
    sampling = [SAMPLED, None] if sampled else None
    outs = eng.generate([[3, 1, 4, 1, 5, 9, 2], [2, 7, 1, 8]], 5,
                        sampling=sampling)
    assert all(len(o) == 5 for o in outs)
    assert modes and all(m.ops > 0 for m in modes)
    assert any(kinds) == sampled
    assert eng.decode_steps_run == 2 * eng.decode_cycles == 2 * len(modes)


# ---------------------------------------------------------------------------
# MoE's dense decode route against the JAX package's per-token dispatch
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek-v2-lite-16b"
#: 8 experts, top-2, no shared expert (the routed sum alone)
WIDE = dict(num_experts=8, top_k=2, capacity_factor=0.5,
            num_shared_experts=0)


@functools.lru_cache(maxsize=None)
def _moe_setup(variant):
    cfg = get_config(MOE_ARCH, smoke=True)
    pcfg = port_get_config(MOE_ARCH, smoke=True)
    if variant == "wide":
        cfg = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                                   **WIDE}))
        pcfg = pcfg.replace(moe=pcfg.moe.__class__(**{**pcfg.moe.__dict__,
                                                      **WIDE}))
    params = jax_registry.build(cfg).init_params(jax.random.PRNGKey(5))
    ff = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["ff"])
    ff["router"] = ff["router"] * 100.0       # decisive routing
    return cfg, pcfg, ff


@pytest.mark.parametrize("variant", ["smoke", "wide"])
@pytest.mark.parametrize("n_valid", [None, 7])
def test_dense_moe_route_matches_jax_per_token(variant, n_valid):
    cfg, pcfg, ff = _moe_setup(variant)
    x = np.random.default_rng(2).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)
    want_y, want_aux = jax.jit(functools.partial(
        jax_moe.moe_apply, cfg, n_valid=n_valid, per_token=True))(
        jax.tree.map(jnp.asarray, ff), jnp.asarray(x))
    with NoSync():
        got_y, got_aux = port_moe.moe_apply(
            pcfg, from_jax_params(ff), torch.from_numpy(x), n_valid=n_valid,
            per_token=True, dense=True)
    rows = slice(None) if n_valid is None else slice(0, n_valid)
    np.testing.assert_allclose(got_y.numpy()[:, rows],
                               np.asarray(want_y)[:, rows], atol=1e-5)
    assert abs(float(got_aux) - float(want_aux)) < 1e-6


def test_sorted_moe_route_never_reads_the_host():
    """The sorted route (prefill chunks, verify rows) groups the picks by
    expert into a tile table on the device and runs one grouped GEMM over
    it: ``NoSync`` passes it, a masked bucket tail included, and it gives
    the dense route's output."""
    _, pcfg, ff = _moe_setup("smoke")
    p = from_jax_params(ff)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 6, pcfg.d_model)).astype(np.float32))
    with NoSync() as mode:
        got, _ = port_moe.moe_apply(pcfg, p, x, n_valid=4, per_token=True)
    assert mode.ops > 0
    want, _ = port_moe.moe_apply(pcfg, p, x, n_valid=4, per_token=True,
                                 dense=True)
    torch.testing.assert_close(got[:, :4], want[:, :4], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# ServeConfig.decode_graphs as the engine resolves it
# ---------------------------------------------------------------------------

_MESH = MeshConfig(shape=(1, 2), axis_names=("data", "model"))


@pytest.mark.parametrize("choice,mesh,error", [
    (True, None, "needs a CUDA device"),
    (True, _MESH, "with a mesh"),
    (None, None, None),
    (False, None, None),
], ids=["true-cpu", "true-mesh", "auto-cpu", "false-cpu"])
def test_engine_resolves_decode_graphs(choice, mesh, error):
    cfg = port_get_config("qwen2.5-14b", smoke=True)
    serve = ServeConfig(max_batch=2, max_seq_len=32, decode_graphs=choice)
    if error:
        with pytest.raises(ValueError, match=error):
            ServingEngine(cfg, serve, mesh_cfg=mesh, device="cpu")
        return
    assert ServingEngine(cfg, serve, device="cpu").decode_graphs is False


@pytest.mark.parametrize("choice,mesh,want", [
    (None, None, True), (None, _MESH, False), (False, None, False),
    (True, None, True)])
def test_decode_graphs_resolve_on_a_cuda_device(choice, mesh, want):
    """On a CUDA device (resolved without one: no capture happens here)
    None means graphs unless there is a mesh."""
    assert resolve_decode_graphs(choice, torch.device("cuda"), mesh) is want


# ---------------------------------------------------------------------------
# Launch counts under capture
# ---------------------------------------------------------------------------

def test_captured_launches_count_at_every_replay():
    """A launch counted while capturing goes to the capture's tally, not
    to the wrapper's counts; each replay adds the tally once; scratch
    handed to ``hold_scratch`` stays with the capture."""
    def wrapper():
        pass
    wrapper.launches, wrapper.launches_by = 0, {}
    kcommon.count_launch(wrapper, "fp")
    scratch = torch.zeros(4)
    with kcommon.capture_launches() as cap:
        for _ in range(3):
            kcommon.count_launch(wrapper, "fp")
            kcommon.count_launch(wrapper, "int8")
        kcommon.hold_scratch(scratch)
    assert (wrapper.launches, wrapper.launches_by) == (1, {"fp": 1})
    assert cap.launches == {(wrapper, "fp"): 3, (wrapper, "int8"): 3}
    assert cap.held == [scratch]
    for _ in range(2):
        kcommon.add_launches(cap.launches)
    assert wrapper.launches == 1 + 2 * 6
    assert wrapper.launches_by == {"fp": 7, "int8": 6}
    kcommon.count_launch(wrapper, "fp")          # outside: counted at once
    assert wrapper.launches_by["fp"] == 8

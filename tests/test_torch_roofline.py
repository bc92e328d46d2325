"""The port's roofline tools on the CPU: the op counter on the five cases of
``tests/test_hlo_parse.py``, the analysis rows of a hand-made record, and
the H100 constants against ``chip_smoke.py``'s.

The JAX cases lower a ``lax.scan`` and weight its body by the trip count;
the port runs eager, so a loop's ops are counted as they run and the same
totals come out exactly (no tolerance: FLOPs are integers computed from
shapes).  Collectives run on a ``fake``-backend process group of 4 ranks
(``launch.dryrun.fake_world``) under ``FakeTensorMode``.
"""
import ast
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.launch.dryrun import fake_world
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.op_count import OpCounter

ROOT = Path(__file__).resolve().parents[1]


def test_loop_flops_exact():
    D, L, B = 128, 8, 4
    with FakeTensorMode():
        w, x = torch.empty(L, D, D), torch.empty(B, D)
        with OpCounter() as c:
            for layer in range(L):
                x = torch.tanh(x @ w[layer])
    assert c.stats.dot_flops == 2 * B * D * D * L
    assert c.stats.fp32_flops == c.stats.dot_flops      # fp32 operands
    assert c.stats.while_trip_counts == []
    top = c.stats.top_flops(1)[0]
    assert top.multiplicity == L and top.comp == "test_loop_flops_exact"


def test_nested_loop_multiplicity():
    D, L1, L2 = 64, 3, 5
    with FakeTensorMode():
        w = torch.empty(L1, L2, D, D, dtype=torch.bfloat16)
        x = torch.empty(2, D, dtype=torch.bfloat16)
        with OpCounter() as c:
            for i in range(L1):
                for j in range(L2):
                    x = torch.einsum("bd,de->be", x, w[i, j])
    assert c.stats.dot_flops == 2 * 2 * D * D * L1 * L2
    assert c.stats.fp32_flops == 0


def test_collectives_captured_with_groups():
    """An all-reduce over a 4-rank group: per-device buffer [2,128] fp32 =
    1024 B, ring wire 2·N·(p-1)/p."""
    with fake_world(4, rank=1), FakeTensorMode():
        x = torch.empty(2, 128)
        with OpCounter() as c:
            dist.all_reduce(x)
    ar = [c for c in c.stats.collectives if c.kind == "all-reduce"]
    assert len(ar) == 1
    assert ar[0].group_size == 4
    assert ar[0].result_bytes == 2 * 128 * 4
    assert ar[0].wire_bytes == pytest.approx(2 * 1024 * 3 / 4)
    assert c.stats.collective_summary()["all-reduce"]["count"] == 1
    assert not dist.is_initialized()          # the fake world is torn down


def test_collective_inside_loop_multiplied():
    """L all-reduces inside a layer loop over a subgroup of 2 of the 4
    ranks, with an all-gather beside them: counts and group sizes."""
    L = 6
    with fake_world(4, rank=2), FakeTensorMode():
        sub = dist.new_group([2, 3])
        w, x = torch.empty(L, 32, 32), torch.empty(8, 32)
        with OpCounter() as c:
            for layer in range(L):
                x = x @ w[layer]
                dist.all_reduce(x, group=sub)
            parts = [torch.empty_like(x) for _ in range(4)]
            dist.all_gather(parts, x)
    ars = [c for c in c.stats.collectives if c.kind == "all-reduce"]
    assert sum(c.multiplicity for c in ars) == L
    assert {c.group_size for c in ars} == {2}
    ag = c.stats.collective_summary()["all-gather"]
    assert ag["count"] == 1 and ag["buffer_bytes"] == 4 * 8 * 32 * 4
    assert c.stats.wire_bytes_by_group() == {
        2: L * 2 * (8 * 32 * 4) / 2, 4: 4 * 8 * 32 * 4 * 3 / 4}


def test_conv_flops_counted():
    """NHWC input and HWIO weight convolved as the CNN models do: exact."""
    with FakeTensorMode():
        x = torch.empty(2, 16, 16, 3).permute(0, 3, 1, 2)
        w = torch.empty(3, 3, 3, 8).permute(3, 2, 0, 1)
        with OpCounter() as c:
            torch.nn.functional.conv2d(x, w, padding=1)
    assert c.stats.conv_flops == 2 * (2 * 16 * 16 * 8) * (3 * 3 * 3)
    assert c.stats.dot_flops == 0


def test_bytes_and_peak_model():
    """HBM bytes: operands read once and results written once; views
    free; a scatter counts the values written, not its target.  Peak: the
    live storages' high-water mark."""
    with FakeTensorMode():
        a = torch.empty(256, 256)
        with OpCounter() as c:
            c.track(a)
            b = a * 2.0                      # 256 KiB read + 256 KiB written
            v = b.t()                        # a view: nothing
            del b
            rows = torch.zeros(4, dtype=torch.long)
            a.index_put_((rows,), torch.ones(4, 256))
            peak = c.peak_bytes
    n = 256 * 256 * 4
    ops = {x.opcode: x.bytes for x in c.stats.contributors}
    assert ops["mul.Tensor"] == 2 * n
    assert "t.default" not in ops
    assert ops["index_put_.default"] == 2 * (4 * 8 + 4 * 256 * 4)
    assert peak >= 2 * n and v.shape == (256, 256)


def test_roofline_row_from_a_hand_made_record():
    rec = {"ok": True, "arch": "a", "shape": "s", "mesh": "single",
           "mode": "serve", "devices": 256, "compile_s": 1.5,
           "hlo_stats": {"dot_flops": 989e12 + 67e12 * 0.25,
                         "conv_flops": 0.0, "fp32_flops": 67e12 * 0.25,
                         "hbm_bytes": 3.35e12 * 0.5, "wire_bytes": 1.0,
                         "wire_bytes_by_group": {"16": 50e9 * 0.25,
                                                 "8": 450e9 * 0.5}},
           "memory": {"peak_estimate_bytes": 81e9},
           "model_flops_global": 989e12 * 256 / 2}
    row = analysis.row_from_record(rec)
    assert row.compute_s == pytest.approx(1.25)        # bf16 1 + fp32 0.25
    assert row.memory_s == pytest.approx(0.5)
    assert row.collective_s == pytest.approx(0.75)     # IB 0.25 + NVLink 0.5
    assert row.bottleneck == "compute"
    assert row.est_step_s == pytest.approx(1.25)
    assert row.est_mfu == pytest.approx(1.0)
    assert row.model_mfu == pytest.approx(0.5 / 1.25)
    assert row.model_to_hlo == pytest.approx(
        989e12 * 256 / 2 / (rec["hlo_stats"]["dot_flops"] * 256))
    assert not row.fits_hbm                            # 81 GB > 80 GB
    assert row.cell == "a/s/single/serve"
    assert analysis.row_from_record({"ok": False}) is None
    md = analysis.format_markdown([row])
    assert "| a/s/single/serve | 1.250 | 0.500 | 0.750 | compute |" in md
    csv = analysis.format_csv([row]).splitlines()
    assert csv[1].startswith("a,s,single,serve,256,1.250000,0.500000,0.750000")


def test_hw_constants_agree_with_chip_smoke():
    """``chip_smoke.py`` (which imports nothing of the package) states the
    card's rates for its bounds; they must be ``roofline.hw``'s."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and isinstance(n.value, ast.Constant)}
    assert consts["HBM_BYTES_PER_S"] == hw.HBM_BW
    assert consts["BF16_FLOPS_PER_S"] == hw.PEAK_FLOPS_BF16
    assert consts["FP32_FLOPS_PER_S"] == hw.PEAK_FLOPS_FP32
    assert hw.HBM_BYTES == 80e9 and hw.GPUS_PER_NODE == 8

"""Roofline synthesis: dry-run JSON records -> three-term roofline rows on
the H100.

The port of ``src/repro/roofline/analysis.py``.  Terms (per device, per
step, seconds; every input is a per-device quantity from the dry run's op
counter, ``launch/dryrun.py``):

  compute    = (dot_flops + conv_flops - fp32_flops) / PEAK_FLOPS_BF16
               + fp32_flops / PEAK_FLOPS_FP32 (fp32 matmuls on the CUDA
               cores: TF32 is off)
  memory     = hbm_bytes / HBM_BW
  collective = sum over groups of wire_bytes / (NVLINK_BW for a group of
               at most GPUS_PER_NODE ranks, IB_BW beyond)

A group of at most 8 ranks is taken to lie within one node (the model
axis, innermost in the rank order, does); a wider group crosses nodes at
the InfiniBand rate.  The bottleneck is the max term (perfect-overlap
assumption); est. MFU = compute / max(...); MODEL_FLOPS ratio = 6·N·D-style
analytic flops over the counted global flops (how much counted compute is
"useful" — catches remat and recomputation).  ``fits_hbm`` holds the dry
run's peak against the card's 80 GB.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from repro_torch.roofline import hw


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    mode: str
    devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    est_step_s: float
    est_mfu: float              # counted-flops MFU upper bound
    model_mfu: float            # useful-flops (6ND) MFU upper bound
    model_to_hlo: float         # MODEL_FLOPS / (global counted flops)
    peak_bytes_per_dev: float
    fits_hbm: bool
    compile_s: float

    @property
    def cell(self) -> str:
        return f"{self.arch}/{self.shape}/{self.mesh}/{self.mode}"


def compute_seconds(flops: float, fp32_flops: float) -> float:
    """The compute term: bf16 / fp16 FLOPs at the tensor cores' peak, fp32
    ones at the CUDA cores'."""
    return ((flops - fp32_flops) / hw.PEAK_FLOPS_BF16
            + fp32_flops / hw.PEAK_FLOPS_FP32)


def collective_seconds(hlo_stats: dict) -> float:
    """The collective term: each group size's wire bytes at its link's
    rate (``wire_bytes_by_group``; a record without it is taken to cross
    nodes)."""
    by_group = hlo_stats.get("wire_bytes_by_group")
    if by_group is None:
        return hlo_stats["wire_bytes"] / hw.IB_BW
    return sum(w / (hw.NVLINK_BW if int(p) <= hw.GPUS_PER_NODE else hw.IB_BW)
               for p, w in by_group.items())


def row_from_record(rec: dict) -> Optional[RooflineRow]:
    if not rec.get("ok"):
        return None
    st = rec["hlo_stats"]
    n_dev = rec["devices"]
    flops_dev = st["dot_flops"] + st["conv_flops"]
    compute_s = compute_seconds(flops_dev, st.get("fp32_flops", 0.0))
    memory_s = st["hbm_bytes"] / hw.HBM_BW
    coll_s = collective_seconds(st)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    est = max(terms.values())
    model_flops_dev = rec["model_flops_global"] / n_dev
    peak = rec["memory"]["peak_estimate_bytes"]
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        mode=rec["mode"], devices=n_dev,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck, est_step_s=est,
        est_mfu=compute_s / est if est else 0.0,
        model_mfu=(model_flops_dev / hw.PEAK_FLOPS_BF16) / est if est else 0.0,
        model_to_hlo=(rec["model_flops_global"] /
                      (flops_dev * n_dev) if flops_dev else 0.0),
        peak_bytes_per_dev=peak,
        fits_hbm=peak <= hw.HBM_BYTES,
        compile_s=rec.get("compile_s", 0.0),
    )


def load_rows(results_dir, include_tags: bool = False) -> List[RooflineRow]:
    rows = []
    for f in sorted(Path(results_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("tag") and not include_tags:
            continue                      # hillclimb variants
        row = row_from_record(rec)
        if row is not None:
            if rec.get("tag"):
                row.mode = f"{row.mode}+{rec['tag']}"
            rows.append(row)
    return rows


def format_markdown(rows: List[RooflineRow]) -> str:
    hdr = ("| cell | compute s | memory s | collective s | bottleneck | "
           "est MFU | model MFU | model/counted | peak GB/dev | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r.cell} | {r.compute_s:.3f} | {r.memory_s:.3f} | "
            f"{r.collective_s:.3f} | {r.bottleneck} | {r.est_mfu:.2%} | "
            f"{r.model_mfu:.2%} | {r.model_to_hlo:.2f} | "
            f"{r.peak_bytes_per_dev/1e9:.1f} | "
            f"{'y' if r.fits_hbm else 'N'} |")
    return hdr + "\n".join(lines) + "\n"


def format_csv(rows: List[RooflineRow]) -> str:
    out = ["arch,shape,mesh,mode,devices,compute_s,memory_s,collective_s,"
           "bottleneck,est_mfu,model_mfu,model_to_hlo,peak_gb_dev,fits_hbm,"
           "compile_s"]
    for r in rows:
        out.append(
            f"{r.arch},{r.shape},{r.mesh},{r.mode},{r.devices},"
            f"{r.compute_s:.6f},{r.memory_s:.6f},{r.collective_s:.6f},"
            f"{r.bottleneck},{r.est_mfu:.4f},{r.model_mfu:.4f},"
            f"{r.model_to_hlo:.4f},{r.peak_bytes_per_dev/1e9:.3f},"
            f"{int(r.fits_hbm)},{r.compile_s:.1f}")
    return "\n".join(out) + "\n"

"""Three-term roofline per (arch x shape) from the port's dry-run artifacts
(``launch/dryrun.py``, ``results/dryrun_torch/``): the counterpart of
``src/repro/roofline/analysis.py``, on the H100's figures.

  compute    = FLOPs_per_device / peak_FLOPs          (989 TFLOP/s bf16)
  memory     = HBM_bytes_per_device / HBM_bw          (3.35 TB/s)
  collective = link_bytes_per_device / NVLink_bw      (450 GB/s)

The constants are the port's `HardwareSpec` (``serving/cost_model.py``):
the H100 SXM data sheet at 700 W, not measured.  FLOPs and bytes are the
counter's (``roofline/cost.py``) over the single-pod mesh, split evenly
over its 256 devices; bytes are eager PyTorch's traffic, every operation
materialised.  MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill, decode) over
active parameters; MODEL_FLOPS / counted FLOPs exposes recomputation,
attention and dispatch overhead.  ``fits`` is argument + peak live bytes
within one card's 80 GB.

  python -m repro_torch.roofline.analysis
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.serving.cost_model import HardwareSpec

_HW = HardwareSpec()
PEAK_FLOPS = _HW.peak_flops
HBM_BW = _HW.hbm_bw
LINK_BW = _HW.ici_bw
HBM_BYTES = _HW.hbm_bytes

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


@dataclass
class RooflineRow:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_ratio: float      # useful / counted
    mem_gb: float
    fits: bool
    coll_breakdown: Dict[str, float]

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_s / step_s: the useful fraction of the bounding
        resource if the three terms overlapped perfectly."""
        return self.compute_s / max(self.step_s, 1e-30)


def load_row(arch: str, shape: str, mesh: str = "single",
             results: Path = RESULTS) -> Optional[RooflineRow]:
    f = Path(results) / f"{arch}__{shape}__{mesh}.json"
    if not f.exists():
        return None
    d = json.loads(f.read_text())
    if d.get("skipped") or not d.get("ok"):
        return None
    p = d["per_device"]
    comp = p["flops"] / PEAK_FLOPS
    mem = p["hbm_bytes"] / HBM_BW
    coll = p["total_coll_bytes"] / LINK_BW
    terms = {"compute": comp, "memory": mem, "collective": coll}
    bott = max(terms, key=terms.get)
    useful = d["model_flops_global"] / d["n_devices"]
    return RooflineRow(
        arch=arch, shape=shape, compute_s=comp, memory_s=mem,
        collective_s=coll, bottleneck=bott,
        model_flops_ratio=useful / max(p["flops"], 1e-30),
        mem_gb=d["memory"]["total_gb"], fits=d["fits_hbm_80gb"],
        coll_breakdown={k: v / LINK_BW for k, v in p["coll_bytes"].items()})


def all_rows(results: Path = RESULTS) -> List[RooflineRow]:
    from repro_torch.configs import ARCHS, shapes_for
    rows = []
    for arch in sorted(ARCHS):
        for cell in shapes_for(ARCHS[arch]):
            r = load_row(arch, cell.name, results=results)
            if r:
                rows.append(r)
    return rows


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'coll_s':>10s} {'bound':>10s} {'useful/cnt':>10s} "
           f"{'mem_GB':>7s} fits")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.compute_s:10.4f} "
            f"{r.memory_s:10.4f} {r.collective_s:10.4f} {r.bottleneck:>10s} "
            f"{r.model_flops_ratio:10.3f} {r.mem_gb:7.1f} "
            f"{'Y' if r.fits else 'N'}")
    return "\n".join(lines)


def main():
    from collections import Counter
    rows = all_rows()
    print(f"H100 SXM data sheet at 700 W: {PEAK_FLOPS / 1e12:.0f} TFLOP/s, "
          f"{HBM_BW / 1e12:.2f} TB/s HBM, {LINK_BW / 1e9:.0f} GB/s NVLink, "
          f"{HBM_BYTES / 1e9:.0f} GB; terms per device per step")
    print(format_table(rows))
    print(f"\n{len(rows)} cells; bottleneck histogram: "
          f"{dict(Counter(r.bottleneck for r in rows))}")


if __name__ == "__main__":
    main()

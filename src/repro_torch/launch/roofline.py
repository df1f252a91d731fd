"""The roofline table of the dry run's records: port of
``benchmarks/roofline.py`` into the package (one H100; no benchmark).

Each ok cell's three terms (compute, memory, collective: 0 on one card),
its bound, the useful share of its FLOPs, its peak memory and its
fraction of the roofline: useful compute time at the H100 SXM's dense
bf16 rate over the dominant term.  Estimates from the meta run at
data-sheet rates, not measurements.

Usage::

    python -m repro_torch.launch.roofline [--dir results/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import SHAPE_ORDER
from repro_torch.configs.registry import ARCH_ORDER
from repro_torch.launch.cost import PEAK_FLOPS_BF16
from repro_torch.launch.dryrun import MESH


def load_records(d: str) -> List[Dict]:
    recs = []
    for path in glob.glob(os.path.join(d, "*.json")):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def table_lines(recs: List[Dict]) -> List[str]:
    by_key = {(r["arch"], r["shape"]): r for r in recs
              if r.get("mesh") == MESH}
    lines = []
    header = ("roofline,arch,shape,status,Tc_ms,Tm_ms,Tcoll_ms,bound,"
              "useful_pct,peak_GiB,frac_of_roofline")
    lines.append(header)
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = by_key.get((arch, shape))
            if r is None:
                continue
            if r["status"] == "skipped":
                lines.append(f"roofline,{arch},{shape},SKIP,,,,,,,")
                continue
            if r["status"] != "ok":
                lines.append(f"roofline,{arch},{shape},ERROR,,,,,,,")
                continue
            rl = r["roofline"]
            peak = r["memory"].get("peak_bytes_per_device", 0) / 2 ** 30
            # fraction of roofline = useful compute time / dominant term
            t_dom = max(rl["t_compute"], rl["t_memory"],
                        rl["t_collective"])
            t_useful = rl["model_flops"] / PEAK_FLOPS_BF16
            frac = t_useful / t_dom if t_dom > 0 else 0.0
            lines.append(
                f"roofline,{arch},{shape},ok,"
                f"{rl['t_compute'] * 1e3:.2f},{rl['t_memory'] * 1e3:.2f},"
                f"{rl['t_collective'] * 1e3:.2f},{rl['bottleneck']},"
                f"{rl['useful_ratio'] * 100:.1f},{peak:.2f},"
                f"{frac * 100:.1f}%")
    return lines


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    if not recs:
        return [f"roofline,no records found in {args.dir} — run "
                f"`python -m repro_torch.launch.dryrun --all` first"]
    return table_lines(recs)


if __name__ == "__main__":
    for line in main():
        print(line)

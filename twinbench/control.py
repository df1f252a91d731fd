"""The control of ``correct``: the plain reference put in the program's
place with every time the job table holds stored in bfloat16 (the next
precision below the float32 the configurations state), held to the
float32 reference by the cell's own comparison.  It has to come out not
correct.

    python3 twinbench/control.py --workload <cell> --seeds 1,2,3

prints each seed's readings beside the cell's limits, one JSON line a
seed.  For a decision cell the control decides the first cycle (the
backlog as published); for a farm it replays the checked sample of
scenarios.  Needs a CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def bf16(a):
    """float32 values rounded to bfloat16 and back."""
    import torch
    return torch.as_tensor(a).to(torch.bfloat16).float().numpy()


def readings(cell, seed: int, device: str):
    """((checks, exact_diff parts) of the control, the same of the
    float32 reference against itself) for one seed."""
    import numpy as np

    from twinbench.gen import traces
    cfg, tr, entry = cell.config, cell.traffic, cell.entry
    rng = np.random.default_rng(seed)
    if tr["entry"] == "cycle":
        sched, fan = entry.draw_episode(cfg, tr, seed, 0)
        events = [(0, sched.take())]
        out = []
        for q in (bf16, None):
            ctl = entry.reference(cfg, tr, events, [fan], [0], device,
                                  quantize=q)
            ref = entry.reference(cfg, tr, events, [fan], [0], device,
                                  winners=ctl["winners"])
            out.append(entry.compare(ctl, ref, tr["limits"])[:2])
        return tuple(out)
    drawn = traces.draw(tr["traces"], rng, cfg["total_nodes"])
    rows = traces.padded(drawn, traces.table_width(drawn["nodes"].shape[1]),
                         cfg["total_nodes"])
    S = rows["nodes"].shape[0]
    pick = np.random.default_rng([seed, 7])
    sidx = np.sort(pick.choice(S, min(int(tr["check"]["scenarios"]), S),
                               replace=False))
    ref = entry.reference(cfg, rows, sidx, device)
    out = []
    for q in (bf16, None):
        ctl = entry.reference(cfg, rows, sidx, device, quantize=q)
        ctl["grids"] = [(ctl["best"], ctl["costs"])]
        out.append(entry.compare(ctl, ref, tr["limits"])[:2])
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from twinbench import harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        (ctl, parts), (same, _) = readings(cell, seed, args.device)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "control": {c.name: [c.value, c.limit] for c in ctl},
            "control_parts": parts,
            "control_correct": all(c.ok for c in ctl),
            "reference_twice": {c.name: c.value for c in same}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

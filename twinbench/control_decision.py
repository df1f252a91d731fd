"""The control of ``correct`` for a decision cell whose mix names an
entry of its own (``cycle_queues``): ``control.py``'s decision-cycle
readings, taken through the cell's entry (its ``draw_episode``,
``reference`` and ``compare``).  ``control.py`` takes that path only for
the entry named ``cycle``.

    python3 twinbench/control_decision.py --workload <cell> --seeds 1,2,3

prints each seed's readings beside the cell's limits, one JSON line a
seed, as ``control.py`` does.  Needs a CUDA device unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device: str):
    """``control.readings`` of a decision cell, whatever its entry's
    name."""
    from twinbench import control
    return control.readings(
        dataclasses.replace(cell, traffic=dict(cell.traffic, entry="cycle")),
        seed, device)


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

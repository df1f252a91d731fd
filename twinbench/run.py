"""Run one cell of the benchmark once and print its result line.

    python3 twinbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, this folder and
the program (``src/repro_torch``).  The run sets up the cell (kernels
built once a checkout, under ``build/twinbench/``), measures for
``--seconds`` seconds, checks what the measured path produced against
the plain reference, and prints, last on stderr, each compared number
beside its limit and, last on stdout, one JSON line.  With ``--trace 1``
the line carries the per-layer metrics and the device trace of a short
window instead of the end-to-end metrics.  It needs a CUDA device and
exits non-zero without printing a result when there is none.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "twinbench"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import json

    import torch

    from twinbench import harness
    from twinbench.compare import printable

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("twinbench: no CUDA device; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"twinbench: {cell.name} needs {cell.chips} devices, torch "
              f"sees {torch.cuda.device_count()}; no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_start=T_START)
    out = harness.measure(run)
    harness.guard_imports()
    line = harness.result_line(run, out)
    sys.stdout.flush()
    for c in run.checks:
        print(f"check {c.name} {printable(c.value)!r} limit {c.limit!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

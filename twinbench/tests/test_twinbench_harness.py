"""The harness: cells and metrics found by name as files alone, the
window and rate arithmetic, the result line, the refusals, and the
contract ``BENCHMARK.json`` is written to."""
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest

from twinbench import harness, readers
from twinbench.compare import Check
from twinbench.tests import tiny

REPO = harness.HERE.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_cell_and_metric_added_as_files(tmp_path):
    tiny_root = tiny.make(tmp_path)
    (tiny_root / "metrics" / "units_seen.farm.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    path = tiny_root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["per_layer"].append({
        "name": "units_seen.farm", "unit": "units", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "forks_per_s",
        "workloads": ["tiny-16.farm6"]})
    path.write_text(json.dumps(bench))
    cell = harness.find_cell(bench, "tiny-16.farm6", tiny_root)
    assert cell.config == tiny.CONFIGS["tiny-16"]
    assert cell.entry.__file__.startswith(str(tiny_root))
    assert "units_seen.farm" in [m["name"] for m in cell.per_layer]
    r = tiny.run(tiny_root, "tiny-16.farm6", seconds=0.0, trace=True)
    got = r.extra["out"]["metrics"]
    assert got["units_seen.farm"] == {"value": 1.0, "unit": "units"}
    assert "step_ms.farm" not in got        # no K1 launch on the CPU


def _run(spans, counts, profile=None):
    rec = harness.Recorder()
    for name, vals in spans.items():
        for v in vals:
            rec.span(name, v)
    for name, vals in counts.items():
        for v in vals:
            rec.count(name, v)
    return SimpleNamespace(rec=rec, setup_s=12.5, profile=profile, extra={})


PROFILE = {"wall_s": 0.5, "busy_s": 0.2, "kernels": 6400,
           "k1_launches": 64, "k1_count": 64, "k1_s": 64 * 175.0e-6,
           "k1_bytes": 64 * 142_704_644, "k1_counted": 64}


@pytest.mark.parametrize("reader, want", [
    ("setup_s", 12.5),
    ("mean_unit_s", 2.5),                     # (2 + 3) / 2 cycles
    ("forks_per_s", 2 * 32768 / 5.0),         # forks over the units' time
    ("ingest_ms", 1e3 * ((2 - 1.5) + (3 - 2.75)) / 2),
    ("k1_per_unit", 550.0),
    ("step_ms", 1e3 * 5.0 / 1100),
    ("kernels_per_iter", 100.0),
    ("k1_roofline", 100 * 42.598e-6 / 175e-6),
    ("idle_share", 60.0),
    ("peak_gib", 4.0),
])
def test_reader_arithmetic(reader, want):
    run = _run({"unit": [2.0, 3.0], "decide": [1.5, 2.75]},
               {"forks": [32768, 32768], "k1": [500, 600],
                "peak_bytes": [2**32, 2**31]}, PROFILE)
    assert getattr(readers, reader)(run) == pytest.approx(want, rel=1e-4)


def test_readers_without_records_read_nothing():
    run = _run({}, {"k1": [0]})
    for name in ("mean_unit_s", "forks_per_s", "ingest_ms", "k1_per_unit",
                 "step_ms", "kernels_per_iter", "k1_roofline",
                 "idle_share", "peak_gib"):
        assert getattr(readers, name)(run) is None, name


def test_result_line_shape(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    cell = SimpleNamespace(chips=1)
    run = SimpleNamespace(
        cell=cell, trace=True, profile=dict(PROFILE, device_ops=[],
                                            idle_gaps=[]),
        extra={"memory_peak_bytes": 123},
        checks=[Check("exact_diff", 0, 0), Check("cost_gap", 2e-7, 1e-5)])
    out = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"idle_share.farm": {"value": 60.0, "unit": "%"}},
           "breakdown": {"device_ops": [], "idle_gaps": []}}
    line = json.loads(harness.result_line(run, out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123, "busy_s": 0.2,
                              "window_s": 0.5}
    assert line["checks"]["cost_gap"] == {"value": 2e-7, "limit": 1e-5}


@pytest.mark.parametrize("where", ("checkout", "benchmark alone"))
def test_refuses_without_card_or_program(tmp_path, where):
    """No CUDA device (or no program beside the benchmark): a non-zero
    exit and no result line."""
    root = REPO
    if where == "benchmark alone":
        import shutil
        shutil.copytree(harness.HERE, tmp_path / "twinbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(REPO / "BENCHMARK.json", tmp_path)
        root = tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "twinbench/run.py", "--workload",
                        "paper-32.farm16384", "--seed", str(2**31 + 9),
                        "--seconds", "1", "--trace", "0"], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_contract():
    b = BENCH
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["twinbench"] and b["command"][1] == "twinbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert cfg["guarantees"]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = harness.find_cell(b, w["name"])
        reported = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
    assert len(json.dumps(b)) < 64 * 1024

"""On the card: the CPU-sized cells through K1 with the traced window,
correct and with every per-layer metric read."""
import json

import pytest

from twinbench import harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", ("tiny-16.cycle4", "tiny-16.farm6"))
def test_tiny_cell_on_card(card, tiny_root, workload):
    bench = json.loads((tiny_root.parent / "BENCHMARK.json").read_text())
    bench_cell = harness.find_cell(bench, workload, tiny_root)
    r = harness.Run(cell=bench_cell, seed=17, seconds=0.0, trace=True,
                    device=card, root=tiny_root)
    out = harness.measure(r)
    assert out["correct"], r.checks
    assert r.profile is not None and r.profile["k1_count"] == 3
    assert r.profile["k1_counted"] == 3
    assert 0 < out["metrics"][next(m for m in out["metrics"]
                                   if m.startswith("k1_roofline"))][
        "value"] <= 100
    assert {m["name"] for m in bench_cell.per_layer} == set(out["metrics"])

"""The queue-table deployment: the backlog generator (``gen/queues.py``)
against the shipped configuration and mix, and a tiny copy of the cell
(``cycle_queues``) run end to end on the CPU against the reference, its
span readers (``cycle_spans.py``), its control and planted faults."""
import json
import statistics

import numpy as np
import pytest

from twinbench import control_decision, cycle_spans, harness
from twinbench.gen import queues
from twinbench.tests import tiny
from twinbench.tests.test_twinbench_control import (altered_answer,
                                                     half_batch,
                                                     unchanged_step)

POLARIS = json.loads((harness.HERE / "configs" / "polaris-560.json")
                     .read_text())
MIX = json.loads((harness.HERE / "traffic" / "queues700-fan256.json")
                 .read_text())
CELL = "tiny-queues.queues40"
CONFIG = {"total_nodes": 48, "max_jobs": 64,
          "pool": "wfp:a=1..3x3:tau=600..3600x2",
          "queues": {"debug": {"nodes": [1, 2], "walltime": [300.0, 3600.0]},
                     "small": {"nodes": [3, 8], "walltime": [300.0, 10800.0]},
                     "large": {"nodes": [9, 40],
                               "walltime": [300.0, 86400.0]}},
          "reduced": [], "guarantees": ["as polaris-560"]}
TRAFFIC = {"entry": "cycle_queues",
           "backlog": {"generator": "queues", "n_jobs": 40, "mean_gap": 30.0,
                       "shares": {"debug": 0.4, "small": 0.4, "large": 0.2},
                       "accuracy": [0.3, 1.0]},
           "episode_cycles": 2,
           "fan": {"n": 4, "runtime_noise": 0.3, "failure_prob": 0.5,
                   "failure_frac": 0.15},
           "goal": "cvar:0.5:score", "obits": 2, "warm_cycles": 1,
           "profile": {"start": 2, "warm": 1, "active": 3},
           "check": {"cycles": 2}, "limits": tiny.LIMITS}
SPAN_METRICS = ("dispatch_ms.cycle", "wait_ms.cycle", "prep_ms.cycle",
                "decide_ms.cycle")


def test_polaris_queue_table():
    """The documented limits: nodes, then walltime from 5 min to the cap."""
    hours = {"debug": 1, "debug-scaling": 1, "small": 3, "medium": 6,
             "large": 24, "preemptable": 72}
    nodes = {"debug": [1, 2], "debug-scaling": [1, 10], "small": [10, 24],
             "medium": [25, 99], "large": [100, 496], "preemptable": [1, 10]}
    assert POLARIS["total_nodes"] == 560 and POLARIS["max_jobs"] == 1024
    assert {q: v["nodes"] for q, v in POLARIS["queues"].items()} == nodes
    assert {q: v["walltime"] for q, v in POLARIS["queues"].items()} == {
        q: [300.0, 3600.0 * h] for q, h in hours.items()}
    assert set(MIX["backlog"]["shares"]) == set(POLARIS["queues"])


def _draw(seed, n_jobs=700, S=1):
    spec = dict(MIX["backlog"], n_jobs=n_jobs)
    return queues.backlog(spec, POLARIS, np.random.default_rng(seed), S)


def test_draw_is_the_seeds():
    a, b, c = _draw(2**31 + 5), _draw(2**31 + 5), _draw(2**31 + 6)
    assert set(a) == {"submit", "nodes", "est", "true", "queue"}
    for k in a:
        assert a[k].shape == (1, 700)
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["est"], c["est"])


def test_every_job_inside_its_queue():
    d = _draw(7, n_jobs=20_000)
    names = list(MIX["backlog"]["shares"])
    for i, q in enumerate(names):
        mask = d["queue"] == i
        lo_n, hi_n = POLARIS["queues"][q]["nodes"]
        lo_w, hi_w = POLARIS["queues"][q]["walltime"]
        n, e = d["nodes"][mask], d["est"][mask]
        assert ((n >= lo_n) & (n <= hi_n)).all(), q
        assert ((e >= lo_w) & (e <= hi_w)).all(), q
        assert n.min() == lo_n and n.max() == hi_n, q
    assert (d["true"] <= d["est"]).all()
    assert (d["true"] >= np.maximum(1.0, 0.3 * d["est"]) - 1e-9).all()
    assert (np.diff(d["submit"], axis=1) >= 0).all()
    assert np.mean(np.diff(d["submit"])) == pytest.approx(30.0, rel=0.05)


def test_shares_over_twenty_thousand_draws():
    d = _draw(11, n_jobs=20_000)
    for i, share in enumerate(MIX["backlog"]["shares"].values()):
        assert abs(np.mean(d["queue"] == i) - share) < 0.01


def test_nodes_log_uniform_and_capped():
    """Log-uniform over the integers: as many jobs of 100-199 nodes as of
    200-399 in large; a cluster smaller than a queue's range caps it."""
    d = _draw(3, n_jobs=20_000)
    large = d["nodes"][d["queue"] == list(MIX["backlog"]["shares"])
                       .index("large")]
    low, high = np.mean(large < 200), np.mean((large >= 200) & (large < 400))
    assert abs(low - high) < 0.05
    small = dict(POLARIS, total_nodes=64)
    d = queues.backlog(dict(MIX["backlog"], n_jobs=2000), small,
                       np.random.default_rng(3))
    assert d["nodes"].max() == 64


def test_bad_shares_refused():
    with pytest.raises(ValueError):
        queues.backlog(dict(MIX["backlog"], shares={"debug": 0.5}), POLARIS,
                       np.random.default_rng(0))


@pytest.fixture(scope="module")
def queue_root(tmp_path_factory):
    """The tiny copy of the benchmark with a tiny queue cell beside its
    own, reporting the cycle's metrics and the new span readers."""
    root = tiny.make(tmp_path_factory.mktemp("queues"))
    (root / "configs" / "tiny-queues.json").write_text(json.dumps(CONFIG))
    (root / "traffic" / "queues40.json").write_text(json.dumps(TRAFFIC))
    path = root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny-queues",
                               "traffic": "queues40", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("forks_per_s", "decide_ms.cycle", "iters.cycle",
                         "ingest_ms.cycle"):
            m["workloads"].append(CELL)
    bench["per_layer"] += [
        {"name": name, "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "decide and drain",
         "moves": "forks_per_s", "workloads": [CELL]}
        for name in SPAN_METRICS[:3]]
    path.write_text(json.dumps(bench))
    return root


def test_tiny_cell_correct_with_forks(queue_root):
    r = tiny.run(queue_root, CELL, seed=2**31 + 17, seconds=0.0)
    out = r.extra["out"]
    assert out["correct"] and out["failed"] == 0, r.checks
    assert r.extra["exact_parts"] == {"mirror": 0, "winner": 0, "qrun": 0}
    assert {c.name for c in r.checks} == {"exact_diff", "cost_gap"}
    assert out["attempted"] == 2
    assert r.rec.counts["forks"] == [6 * 4] * 2       # k × F a cycle
    assert set(out["metrics"]) == {"forks_per_s", "setup_s"}
    assert out["metrics"]["forks_per_s"]["value"] > 0


def test_tiny_cell_span_readers(queue_root):
    """The three readers give numbers, and steps × (dispatch + wait)
    plus prep is the decision span, which holds the twin's own clock."""
    r = tiny.run(queue_root, CELL, seed=5, seconds=0.0, trace=True)
    got = {k: v["value"] for k, v in r.extra["out"]["metrics"].items()}
    for name in SPAN_METRICS:
        assert got[name] > 0, name
    trees = cycle_spans.window_decisions(r)
    assert len(trees) == r.attempted == len(r.rec.spans["decide"]) == 2
    steps = sum(t.counts()["drain.steps"] for t in trees)
    per_cycle = (1e-6 * sum(t.root.ns for t in trees) / len(trees))
    assert (got["dispatch_ms.cycle"] + got["wait_ms.cycle"]) \
        * steps / len(trees) + got["prep_ms.cycle"] == pytest.approx(
            per_cycle, rel=1e-9)
    decide = 1e3 * statistics.fmean(r.rec.spans["decide"])
    assert decide <= per_cycle <= 1.05 * decide


def test_span_readers_read_nothing_without_spans(queue_root, monkeypatch):
    from repro_torch.core import telemetry
    r = tiny.run(queue_root, CELL, seed=5, seconds=0.0)
    monkeypatch.setattr(telemetry, "SPANS", telemetry.SpanRecorder())
    for name in ("dispatch_ms", "wait_ms", "prep_ms"):
        assert getattr(cycle_spans, name)(r) is None, name
    monkeypatch.delattr(telemetry, "SPANS")        # a program without it
    assert cycle_spans.window_decisions(r) == []


def test_control_is_not_correct(queue_root):
    bench = json.loads((queue_root.parent / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, CELL, queue_root)
    (ctl, parts), (same, _) = control_decision.readings(cell, 21, "cpu")
    assert all(c.value > c.limit for c in ctl), (ctl, parts)
    assert all(c.value == 0 for c in same), same


@pytest.mark.parametrize("fault", (unchanged_step, half_batch,
                                   altered_answer))
def test_fault_makes_run_incorrect(queue_root, fault, monkeypatch):
    fault(monkeypatch)
    r = tiny.run(queue_root, CELL, seed=13)
    assert not r.extra["out"]["correct"], r.checks

"""The readers of the program's spans and counters (``twinbench/spans.py``):
their arithmetic on a fabricated record, the window's grids chosen by
start time and unit count, nothing read where nothing was recorded, and
a tiny farm cell run on the CPU."""
from types import SimpleNamespace

import pytest
import torch

from twinbench import harness, spans
from twinbench.tests import tiny

READERS = ("dispatch_ms", "wait_ms", "prep_ms", "useful_steps",
           "idle_untraced")


class Clock:
    def __init__(self) -> None:
        self.t = 0

    def __call__(self) -> int:
        return self.t


def _grid(rec, clock, start, blocks, steps, iters, before, after):
    """A ``grid`` root as the program records it: ``before`` ns, then a
    ``replay`` of (dispatch, read) ns blocks, then ``after`` ns."""
    clock.t = start
    with rec.span("grid"):
        clock.t += before
        with rec.span("replay"):
            for dispatch, read in blocks:
                clock.t += dispatch
                with rec.span("replay.read"):
                    clock.t += read
            rec.count("replay.steps", steps)
            rec.count("replay.iters", torch.tensor(iters))
        clock.t += after


@pytest.fixture
def record(monkeypatch):
    """A recorder holding a warm grid inside set-up (which ends at 1 s),
    two window grids and the traced unit's grid after them."""
    from repro_torch.core import telemetry
    clock = Clock()
    rec = telemetry.SpanRecorder(clock=clock)
    monkeypatch.setattr(telemetry, "SPANS", rec)
    junk = [(10**6, 10**6)] * 4
    _grid(rec, clock, 5 * 10**8, junk, 128, 1, 10**7, 10**7)    # warm
    _grid(rec, clock, 2 * 10**9, [(100, 900), (600, 1400), (1000, 2000),
                                  (3000, 1000)], 128, 120, 1000, 500)
    _grid(rec, clock, 5 * 10**9, [(200, 1800), (1200, 2800),
                                  (2000, 4000), (6000, 2000)], 128, 112,
          3000, 1500)
    _grid(rec, clock, 8 * 10**9, junk, 128, 1, 10**7, 10**7)    # traced
    return rec


def _run(units=2, busy_s=4.5e-6):
    rec = harness.Recorder()
    for _ in range(units):
        rec.span("unit", 2.0)
    return SimpleNamespace(
        rec=rec, t_start=0.0, setup_s=1.0, profile={"busy_s": busy_s},
        cell=SimpleNamespace(traffic={"profile": {"start": 40, "warm": 8,
                                                  "active": 64}}))


def test_window_grids_by_start_and_unit_count(record):
    got = spans.window_grids(_run())
    assert [t.root.start_ns for t in got] == [2 * 10**9, 5 * 10**9]
    assert [t.root.start_ns for t in spans.window_grids(_run(units=1))] \
        == [2 * 10**9]


@pytest.mark.parametrize("reader, want", [
    # reads 900 + 1400 + 2000 + 1000 and 1800 + 2800 + 4000 + 2000 ns
    ("wait_ms", 1e-6 * (5300 + 10600) / 256),
    # the replays' self time: 4700 and 9400 ns
    ("dispatch_ms", 1e-6 * (4700 + 9400) / 256),
    ("prep_ms", 1e-6 * (1500 + 4500) / 2),
    ("useful_steps", 100.0 * (120 + 112) / 256),
    # steps [48, 112) of blocks of 32: half of block 1, block 2, half of
    # block 3: 1000 + 3000 + 2000 ns and twice that; busy 4.5 us of 9
    ("idle_untraced", 50.0),
])
def test_reader_arithmetic(record, reader, want):
    assert getattr(spans, reader)(_run()) == pytest.approx(want, rel=1e-9)


def test_steps_outside_the_replay_read_nothing(record):
    (first, _) = spans.window_grids(_run())
    assert spans.steps_s(first, 48, 112, 32) == pytest.approx(6e-6)
    assert spans.steps_s(first, 100, 129, 32) is None
    run = _run()
    run.cell.traffic["profile"]["active"] = 100      # past step 128
    assert spans.idle_untraced(run) is None


def test_busy_beyond_the_untraced_time_reads_nothing(record):
    """A busy time longer than the same steps' untraced time was not
    taken of the same work: no share, rather than a negative one."""
    assert spans.idle_untraced(_run(busy_s=9e-6)) == pytest.approx(0.0)
    assert spans.idle_untraced(_run(busy_s=9.5e-6)) is None


@pytest.mark.parametrize("case", ["no grid", "no unit", "no recorder",
                                  "no profile"])
def test_nothing_recorded_reads_nothing(monkeypatch, case):
    from repro_torch.core import telemetry
    monkeypatch.setattr(telemetry, "SPANS", telemetry.SpanRecorder())
    run = _run(units=0 if case == "no unit" else 2)
    if case == "no recorder":                      # a program without it
        monkeypatch.delattr(telemetry, "SPANS")
    if case == "no profile":
        run.profile = None
    for name in READERS:
        assert getattr(spans, name)(run) is None, name


def test_tiny_farm_cell_reads_all_five(tiny_root):
    r = tiny.run(tiny_root, "tiny-16.farm6", seconds=0.0, trace=True)
    got = {k: v["value"] for k, v in r.extra["out"]["metrics"].items()}
    for name in ("dispatch_ms.farm", "wait_ms.farm", "prep_ms.farm"):
        assert got[name] > 0, name
    assert 0 < got["useful_steps.farm"] <= 100
    grids = spans.window_grids(r)
    assert len(grids) == r.attempted == 1
    steps = sum(t.counts()["replay.steps"] for t in grids)
    replay_ms = 1e-6 * sum(s.ns for t in grids for s in t.named("replay"))
    assert got["dispatch_ms.farm"] + got["wait_ms.farm"] == pytest.approx(
        replay_ms / steps, rel=1e-9)
    # the CPU has no device trace: give the window a busy time of half
    # the same steps' untraced time
    w = r.cell.traffic["profile"]
    lo = w["start"] + w["warm"]
    untraced = spans.steps_s(grids[0], lo, lo + w["active"], 32)
    r.profile = {"busy_s": 0.5 * untraced}
    assert spans.idle_untraced(r) == pytest.approx(50.0)

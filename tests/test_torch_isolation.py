"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

* An AST walk over ``src/repro_torch/**.py`` and ``chip_smoke.py`` finds
  no import of ``jax`` or of the ``repro`` package.
* Importing every port module in a fresh interpreter leaves ``jax`` out
  of ``sys.modules``.
* On a host without a CUDA device, every entry point asked for
  ``device="cuda"`` (their default) raises instead of running on the
  CPU, the twin's (the replay and the emulator's fast mode included)
  and the serving stack's alike, and every kernel
  wrapper (K1, K1', K2's two entries, K3, K4) raises for anything but
  CPU or CUDA tensors (K2, K3 and K4 also take the dry run's meta
  tensors).  The new modules of the dry run (``counting.py``,
  ``launch/cost.py``, ``specs.py``, ``dryrun.py``, ``roofline.py``,
  ``configs/shapes.py`` and the ``configs/<arch>.py`` modules) are in
  both checks above.
  The Monte-Carlo entry points (``decide_fan``,
  ``decide_ensemble``, ``fan_grid``, ``race_grid``, ``decide_race``,
  ``pruned_fan_grid``, ``materialize_fan``, ``SchedTwin(fan=/race=/
  ensemble=)``, ``twin_loop --fan/--race/--ensemble/--prune``) too, and
  so do the learner (``train``), ``CheckpointManager.restore`` and
  ``twin_loop --train/--chaos/--snapshot-dir``, and the fleet engine
  (``make_fleet_mesh``, a ``FleetMesh`` naming ``cuda``, every
  ``whatif.sharded_*`` entry, ``decide_legacy_vmap``, ``twin_loop
  --shard/--block-size/--prefetch``) and the four examples, and the
  serving stack of the moe, vlm and encdec families (``EncDec``,
  ``init_model``/``init_caches`` for each, ``launch.serve --arch`` of
  olmoe, deepseek and whisper, ``examples.serve_twin``), and the
  training path (``init_params``, ``init_train_state``,
  ``make_train_step``, ``launch.train``).
* On a host with a card (marker ``cuda``), K1 is held bitwise against
  its plain version.  Tolerance: none — started sets and free-node
  counts are integers.
"""
import ast
import functools
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.cluster.emulator import ClusterEmulator
from repro_torch.cluster.workload import make_scenario, poisson_trace
from repro_torch.configs.schedtwin import ReplayGridConfig
from repro_torch.core import backfill, state, whatif
from repro_torch.core.engine import DrainEngine
from repro_torch.core.events import EventBus
from repro_torch.core.twin import SchedTwin
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import policy_eval as pe
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import wkv6 as wk
from repro_torch.examples import serve_twin
from repro_torch.launch import serve, twin_loop
from repro_torch.models import api
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM
from repro_torch.serve import ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "repro"
            or name.startswith("repro."))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_the_port_leaves_jax_unloaded():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or "
              "m.startswith('repro.'))\n"
              "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the host "
                    "without one")


def _cpu_state():
    return state.empty_state(16, 8, device="cpu")


def test_entry_points_raise_for_cuda_without_a_card():
    _no_card()
    trace = poisson_trace(4, 8, 8.0, (1, 8), (30.0, 90.0), seed=0)
    d = convert.state_to_numpy(_cpu_state())
    calls = {
        "DrainEngine": lambda: DrainEngine(),
        "DrainEngine(cuda)": lambda: DrainEngine("cuda", device="cuda"),
        "empty_state": lambda: state.empty_state(16, 8),
        "whatif.decide": lambda: whatif.decide(_cpu_state(), "paper"),
        "SchedTwin": lambda: SchedTwin(EventBus(), lambda j, t: None, 8),
        "ClusterEmulator": lambda: ClusterEmulator(trace, 8),
        "state_from_numpy": lambda: convert.state_from_numpy(d),
        "pool_from_numpy": lambda: convert.pool_from_numpy(
            np.zeros(1), np.zeros((1, 9))),
        "twin_loop.main": lambda: twin_loop.main(
            ["--trace", "poisson", "--jobs", "4", "--nodes", "8"]),
        "DrainEngine.replay": lambda: DrainEngine().replay(
            make_scenario(trace, 8), torch.zeros(1, dtype=torch.int32)),
        "DrainEngine.replay_grid": lambda: DrainEngine(
            device="cuda").replay_grid(make_scenario(trace, 8),
                                       torch.zeros(1, dtype=torch.int32)),
        "ClusterEmulator.run(fast=True)": lambda: ClusterEmulator(
            trace, 8).run(policy_id=0, fast=True),
        "ReplayGridConfig.make_engine": lambda: ReplayGridConfig(
            ).make_engine(),
        "twin_loop.main --replay-grid": lambda: twin_loop.main(
            ["--replay-grid", "2", "--trace", "poisson", "--jobs", "4",
             "--nodes", "8"]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_monte_carlo_entry_points_raise_for_cuda_without_a_card():
    """Fans, races and ensembles: asked for ``cuda`` (their default)
    without a card, each raises; none goes on on the CPU."""
    _no_card()
    from repro_torch.core import fan, prng, race
    trace = poisson_trace(4, 8, 8.0, (1, 8), (30.0, 90.0), seed=0)
    scen = make_scenario(trace, 8)
    ids = torch.zeros(1, dtype=torch.int32)
    spec = fan.FanSpec(n=4, runtime_noise=0.3)
    small = ["--trace", "poisson", "--jobs", "4", "--nodes", "8"]
    calls = {
        "decide_fan": lambda: DrainEngine().decide_fan(_cpu_state(), ids,
                                                       spec),
        "decide_ensemble": lambda: DrainEngine().decide_ensemble(
            _cpu_state(), ids, prng.PRNGKey(0)),
        "whatif.decide_ensemble": lambda: whatif.decide_ensemble(
            _cpu_state(), "paper", prng.PRNGKey(0)),
        "fan_grid": lambda: DrainEngine(device="cuda").fan_grid(scen, ids,
                                                                spec),
        "race_grid": lambda: race.race_grid(scen, ids, spec),
        "decide_race": lambda: race.decide_race(_cpu_state(), ids, spec),
        "pruned_fan_grid": lambda: fan.pruned_fan_grid(scen, ids, spec),
        "materialize_fan": lambda: fan.materialize_fan(scen, spec),
        "materialize_fan(cuda)": lambda: fan.materialize_fan(
            scen, spec, device="cuda"),
        "SchedTwin(fan=)": lambda: SchedTwin(EventBus(), lambda j, t: None,
                                             8, fan=spec),
        "SchedTwin(race=)": lambda: SchedTwin(
            EventBus(), lambda j, t: None, 8, race=race.RaceSpec(fan=spec)),
        "SchedTwin(ensemble=)": lambda: SchedTwin(
            EventBus(), lambda j, t: None, 8, ensemble=4),
        "twin_loop.main --fan": lambda: twin_loop.main(small + ["--fan",
                                                                "4"]),
        "twin_loop.main --race": lambda: twin_loop.main(
            small + ["--fan", "4", "--race"]),
        "twin_loop.main --ensemble": lambda: twin_loop.main(
            small + ["--ensemble", "2"]),
        "twin_loop.main --replay-grid --fan --prune": lambda: twin_loop.main(
            ["--replay-grid", "2", "--fan", "4", "--prune"] + small),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_learning_and_resilience_entry_points_raise_for_cuda_without_a_card(
        tmp_path):
    """Training, checkpoint restore and the CLI's training, chaos and
    snapshot modes: asked for ``cuda`` (their default) without a card,
    each raises; none goes on on the CPU."""
    _no_card()
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.cluster.workload import split_scenarios
    from repro_torch.learn import TrainConfig, train
    split = split_scenarios(
        np.random.default_rng(0),
        lambda r: poisson_trace(4, 8, 8.0, (1, 8), (30.0, 90.0), rng=r),
        1, 1, 8)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"x": torch.zeros(2)})
    small = ["--trace", "poisson", "--jobs", "4", "--nodes", "8"]
    calls = {
        "train": lambda: train(*split, TrainConfig(population=2,
                                                   generations=1)),
        "train(cuda)": lambda: train(*split, TrainConfig(
            population=2, generations=1), device="cuda"),
        "CheckpointManager.restore": lambda: mgr.restore(
            1, {"x": torch.zeros(2)}),
        "CheckpointManager.restore_latest": lambda: mgr.restore_latest(
            {"x": torch.zeros(2)}),
        "twin_loop.main --train": lambda: twin_loop.main(
            small + ["--train", "1", "--train-pop", "2"]),
        "twin_loop.main --chaos": lambda: twin_loop.main(
            small + ["--chaos"]),
        "twin_loop.main --snapshot-dir": lambda: twin_loop.main(
            small + ["--snapshot-dir", str(tmp_path / "snap")]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_serving_entry_points_raise_for_cuda_without_a_card():
    _no_card()
    cfg = get_smoke_config("llama3.2-1b")
    model = api.init_model(cfg, device="cpu")
    weights = convert.params_to_numpy(model)
    calls = {
        "ServingEngine": lambda: ServingEngine(cfg, model, 2, 16),
        "serve.main": lambda: serve.main(["--arch", "llama3.2-1b",
                                          "--smoke"]),
        "params_from_numpy": lambda: convert.params_from_numpy(cfg,
                                                               weights),
        "init_model": lambda: api.init_model(cfg),
        "init_caches": lambda: api.init_caches(cfg, 2, 16),
        "LM": lambda: LM(cfg),
        "serve_twin.main": lambda: serve_twin.main([]),
    }
    for arch in ("olmoe-1b-7b", "deepseek-v2-lite-16b", "internvl2-76b",
                 "whisper-small"):
        fam = get_smoke_config(arch)
        calls[f"init_model({arch})"] = functools.partial(api.init_model,
                                                         fam)
        calls[f"init_caches({arch})"] = functools.partial(
            api.init_caches, fam, 2, 16)
        if fam.family != "vlm":
            calls[f"serve.main({arch})"] = functools.partial(
                serve.main, ["--arch", arch, "--smoke"])
    whisper = get_smoke_config("whisper-small")
    calls["EncDec"] = lambda: EncDec(whisper)
    calls["ServingEngine(whisper)"] = lambda: ServingEngine(
        whisper, api.init_model(whisper, device="cpu"), 2, 16)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_training_entry_points_raise_for_cuda_without_a_card():
    """The training path: the reference's initial weights, the train
    state, the train step and the training CLI, asked for ``cuda`` (their
    default) without a card, each raises; none goes on on the CPU."""
    _no_card()
    from repro_torch.launch import train as train_cli
    from repro_torch.models import common
    from repro_torch.train import init_train_state, make_train_step
    cfg = get_smoke_config("llama3.2-1b")
    calls = {
        "init_params": lambda: common.init_params(0, api.param_table(cfg)),
        "init_train_state": lambda: init_train_state(0, cfg),
        "make_train_step": lambda: make_train_step(cfg),
        "launch.train.main": lambda: train_cli.main(
            ["--arch", "llama3.2-1b", "--smoke", "--steps", "1"]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_fleet_entry_points_raise_for_cuda_without_a_card():
    """The fleet mesh, every sharded entry, the legacy oracle, the CLI's
    fleet flags and the three examples: asked for ``cuda`` (their
    default) without a card, each raises; none goes on on the CPU."""
    _no_card()
    from repro_torch.examples import fleet_twin, quickstart, train_policy
    from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh
    trace = poisson_trace(4, 8, 8.0, (1, 8), (30.0, 90.0), seed=0)
    scen = make_scenario(trace, 8)
    cpu_mesh = FleetMesh(["cpu"])
    on_card = DrainEngine
    grid = ["--replay-grid", "2", "--trace", "poisson", "--jobs", "4",
            "--nodes", "8"]
    calls = {
        "make_fleet_mesh": lambda: make_fleet_mesh(),
        "make_fleet_mesh(1)": lambda: make_fleet_mesh(1),
        "FleetMesh(cuda)": lambda: FleetMesh(["cuda"]),
        "FleetMesh(cpu, cuda:0)": lambda: FleetMesh(["cpu", "cuda:0"]),
        "sharded_whatif": lambda: whatif.sharded_whatif(make_fleet_mesh()),
        "sharded_whatif(engine)": lambda: whatif.sharded_whatif(
            cpu_mesh, engine=on_card())(_cpu_state(), "paper"),
        "sharded_replay_grid": lambda: whatif.sharded_replay_grid(
            make_fleet_mesh()),
        "sharded_replay_grid(engine)": lambda: whatif.sharded_replay_grid(
            cpu_mesh, engine=on_card())(scen, "paper"),
        "sharded_fan_grid": lambda: whatif.sharded_fan_grid(
            make_fleet_mesh(), fan=4),
        "sharded_generation_costs": lambda: whatif.sharded_generation_costs(
            make_fleet_mesh()),
        "sharded_race_grid": lambda: whatif.sharded_race_grid(
            make_fleet_mesh(), race=4),
        "decide_legacy_vmap": lambda: whatif.decide_legacy_vmap(
            _cpu_state(), "paper"),
        "twin_loop.main --shard 0": lambda: twin_loop.main(
            grid + ["--shard", "0"]),
        "twin_loop.main --block-size": lambda: twin_loop.main(
            grid + ["--block-size", "1"]),
        "twin_loop.main --prefetch": lambda: twin_loop.main(
            grid + ["--block-size", "1", "--prefetch", "0"]),
        "twin_loop.main --fan --race --shard": lambda: twin_loop.main(
            grid + ["--fan", "4", "--race", "--shard", "2"]),
        "quickstart": lambda: quickstart.main([]),
        "fleet_twin": lambda: fleet_twin.main([]),
        "train_policy": lambda: train_policy.main([]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


class _Elsewhere(torch.Tensor):
    """A tensor that says it lies on a device other than CPU, CUDA or
    meta (the three the model kernels' wrappers take)."""

    @property
    def device(self):
        return torch.device("xpu")


@pytest.mark.parametrize("kernel", ["wkv6", "flash_attention", "rglru",
                                    "rglru_gated"])
def test_model_kernel_wrappers_refuse_other_devices(kernel):
    """Any device but CPU, CUDA and meta (the dry run's, where each
    wrapper counts its call and allocates its outputs:
    ``tests/test_torch_cost.py``) is refused, and nothing is launched;
    CPU tensors take the plain version."""
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        build.load(kernel.replace("_gated", ""))
    meta = dict(device="meta")
    if kernel == "wkv6":
        args = (torch.empty((1, 4, 2, 16), **meta),) * 4 + (
            torch.empty((2, 16), **meta),)
        wrapper, module = wk.wkv6, wk
    elif kernel == "rglru":
        args = (torch.empty((2, 5, 24), **meta),) * 2 + (
            torch.empty((2, 24), **meta),)
        wrapper, module = rg.rglru, rg
    elif kernel == "rglru_gated":
        args = (torch.empty((2, 5, 24), **meta),) * 4 + (
            torch.empty((24,), **meta),) * 3
        wrapper, module = rg.rglru_gated, rg
    else:
        args = (torch.empty((1, 4, 8, 32), **meta),
                torch.empty((1, 2, 8, 32), **meta),
                torch.empty((1, 2, 8, 32), **meta))
        wrapper, module = fa.flash_attention, fa
    launches = module.LAUNCHES
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*(a.as_subclass(_Elsewhere) for a in args))
    out = wrapper(*(torch.zeros_like(a, device="cpu") for a in args))
    assert module.LAUNCHES == launches
    assert all(torch.isfinite(t).all() for t in
               (out if isinstance(out, tuple) else (out,)))


def test_kernel_wrapper_refuses_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        build.load("policy_eval")
    meta = dict(device="meta")
    args = (torch.empty((2, 8), dtype=torch.int32, **meta),) * 3 + (
        torch.empty((2, 8), **meta),) * 2 + (
        torch.empty(2, dtype=torch.int32, **meta), torch.empty(2, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        pe.policy_eval_pass_batched(*args)
    launches = pe.LAUNCHES
    started, free = pe.policy_eval_pass_batched(
        *(torch.zeros_like(a, device="cpu") for a in args))
    assert pe.LAUNCHES == launches     # CPU tensors: the plain pass
    assert started.dtype == torch.bool and free.dtype == torch.int32
    # K1': one shared (J,) snapshot under k orders
    shared = (args[0],) + tuple(a[0] for a in args[1:5]) + (
        args[5][:1], args[6][:1])
    with pytest.raises(ValueError, match="unsupported device"):
        pe.policy_eval_pass(*shared)
    launches = pe.SHARED_LAUNCHES
    started, free = pe.policy_eval_pass(
        *(torch.zeros_like(a, device="cpu") for a in shared))
    assert pe.SHARED_LAUNCHES == launches
    assert started.shape == (2, 8) and free.shape == (2,)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    for k, J, seed, collide in ((3, 64, 0, True), (32, 1024, 1, True),
                                (32, 1024, 2, False), (8, pe.MAX_J, 3, True)):
        args = chip_smoke.synthetic_passes(torch, k, J, seed, collide)
        s_k, f_k = pe.policy_eval_pass_batched(*args)
        s_p, f_p = backfill.schedule_pass_batched(*args)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p) and torch.equal(f_k, f_p)
    with pytest.raises(ValueError, match="MAX_J"):
        pe.policy_eval_pass_batched(
            *chip_smoke.synthetic_passes(torch, 1, pe.MAX_J + 1, 0, False))

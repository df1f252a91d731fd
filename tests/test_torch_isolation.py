"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

* An AST walk over ``src/repro_torch/**.py`` and ``chip_smoke.py`` finds
  no import of ``jax`` or of the ``repro`` package.
* Importing every port module in a fresh interpreter leaves ``jax`` out
  of ``sys.modules``.
* On a host without a CUDA device, every entry point asked for
  ``device="cuda"`` (their default) raises instead of running on the
  CPU, and the kernel wrapper raises for anything but CPU tensors.
* On a host with a card (marker ``cuda``), K1 is held bitwise against
  its plain version.  Tolerance: none — started sets and free-node
  counts are integers.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.cluster.emulator import ClusterEmulator
from repro_torch.cluster.workload import poisson_trace
from repro_torch.core import backfill, state, whatif
from repro_torch.core.engine import DrainEngine
from repro_torch.core.events import EventBus
from repro_torch.core.twin import SchedTwin
from repro_torch.kernels import build
from repro_torch.kernels import policy_eval as pe
from repro_torch.launch import twin_loop

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
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


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

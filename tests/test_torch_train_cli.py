"""The port's training CLI (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``), and training checkpoints across the
two packages.

* ``--arch llama3.2-1b --smoke --steps 20 --log-every 5 --batch 4
  --seq 64`` with ``--device cpu`` prints the reference driver's lines
  for the same ``--seed`` (the same initial weights since C5's repair,
  the same synthetic batches): losses within 2e-3, grad norms within
  5e-3, the printed learning rates equal; bf16 parameters in both, so
  the two part by bf16 roundings of parameters that f32 gradients
  differing in their last bits put on either side of a tie.  The same
  with ``--accum 2 --compress``.
* Both drivers checkpoint at steps 10 and 20 (``--ckpt-every 10``); with
  step 20's checkpoint removed, a relaunch restores step 10 and prints
  steps 15 and 20:
  - the port resuming its own run prints the uninterrupted run's lines
    exactly (tokens/s aside);
  - the port resumes the JAX run's checkpoint and the JAX driver the
    port's, each printing the other's uninterrupted lines within the
    tolerances above;
  - the manifests of the two packages name the same leaves
    (``params/…``, ``opt/mu/…``, ``opt/nu/…``, ``opt/count``) with the
    same shapes and dtypes.
* ``--mesh production`` and ``multipod`` are refused, naming A11.7.
"""
import json
import os
import re
import shutil
import sys

import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work here is many small ops: one intra-op thread
    keeps them fast while pytest-xdist runs several workers on the
    host's cores (the thread count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SMOKE = ["--arch", "llama3.2-1b", "--smoke", "--steps", "20",
         "--log-every", "5", "--batch", "4", "--seq", "64"]
LINE = re.compile(r"step +(\d+) loss +(\S+) lr (\S+) gnorm +(\S+) tok/s")
LOSS_TOL, GNORM_TOL = 2e-3, 5e-3


def _run_port(capsys, argv):
    capsys.readouterr()
    train.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def _run_jax(capsys, monkeypatch, argv):
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()
    return capsys.readouterr().out


def _lines(out):
    return {int(m[1]): (float(m[2]), m[3], float(m[4]))
            for m in LINE.finditer(out)}


def _agree(got, want, steps):
    got, want = _lines(got), _lines(want)
    assert sorted(got) == sorted(want) == list(steps)
    for s in steps:
        (gl, glr, gn), (wl, wlr, wn) = got[s], want[s]
        assert abs(gl - wl) <= LOSS_TOL, (s, gl, wl)
        assert glr == wlr, (s, glr, wlr)
        assert abs(gn - wn) <= GNORM_TOL, (s, gn, wn)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted runs of both drivers, checkpointing at steps 10
    and 20: {"port"|"jax": (stdout, checkpoint dir)}."""
    mp = pytest.MonkeyPatch()
    cap = _Capture()
    out = {}
    try:
        for who in ("port", "jax"):
            d = str(tmp_path_factory.mktemp(who))
            argv = SMOKE + ["--ckpt-dir", d, "--ckpt-every", "10"]
            with cap:
                if who == "port":
                    train.main(argv + ["--device", "cpu"])
                else:
                    mp.setattr(sys, "argv", ["train"] + argv)
                    jtrain.main()
            out[who] = (cap.text, d)
    finally:
        mp.undo()
    return out


class _Capture:
    """stdout of a block, for a module-scoped fixture (no capsys)."""

    def __enter__(self):
        import io
        self._old, sys.stdout = sys.stdout, io.StringIO()
        return self

    def __exit__(self, *exc):
        self.text = sys.stdout.getvalue()
        sys.stdout = self._old


def _resume_copy(src, dst):
    shutil.copytree(src, dst)
    shutil.rmtree(os.path.join(dst, "step_000000020"))
    return dst


def test_cli_prints_the_reference_lines(runs):
    _agree(runs["port"][0], runs["jax"][0], (5, 10, 15, 20))
    assert runs["port"][0].rstrip().endswith("done.")


def test_cli_accum_compress_matches_reference(capsys, monkeypatch):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--steps", "10",
            "--log-every", "5", "--batch", "4", "--seq", "32", "--accum",
            "2", "--compress"]
    _agree(_run_port(capsys, argv), _run_jax(capsys, monkeypatch, argv),
           (5, 10))


def test_restart_on_launch_resumes_at_the_saved_step(runs, tmp_path,
                                                       capsys):
    d = _resume_copy(runs["port"][1], str(tmp_path / "ck"))
    out = _run_port(capsys, SMOKE + ["--ckpt-dir", d, "--ckpt-every", "10"])
    assert "restored checkpoint at step 10" in out
    want = _lines(runs["port"][0])
    assert _lines(out) == {s: want[s] for s in (15, 20)}


def test_port_resumes_a_jax_checkpoint(runs, tmp_path, capsys):
    d = _resume_copy(runs["jax"][1], str(tmp_path / "ck"))
    out = _run_port(capsys, SMOKE + ["--ckpt-dir", d, "--ckpt-every", "10"])
    assert "restored checkpoint at step 10" in out
    _agree(out, runs["jax"][0].split("step    10")[1], (15, 20))


def test_jax_resumes_a_port_checkpoint(runs, tmp_path, capsys,
                                       monkeypatch):
    d = _resume_copy(runs["port"][1], str(tmp_path / "ck"))
    out = _run_jax(capsys, monkeypatch,
                   SMOKE + ["--ckpt-dir", d, "--ckpt-every", "10"])
    assert "restored checkpoint at step 10" in out
    _agree(out, runs["port"][0].split("step    10")[1], (15, 20))


def test_manifests_name_the_same_leaves(runs):
    def manifest(d):
        with open(os.path.join(d, "step_000000010", "MANIFEST.json")) as f:
            m = json.load(f)
        return m["keys"], m["shapes"], m["dtypes"]
    port, jax_ = manifest(runs["port"][1]), manifest(runs["jax"][1])
    assert port == jax_
    keys = port[0]
    assert "opt/count" in keys and "params/embed" in keys
    assert "opt/mu/seg0.attn.wq" in keys and "opt/nu/embed" in keys
    assert not any(k.startswith("ef") for k in keys)


@pytest.mark.parametrize("mesh", ["production", "multipod"])
def test_mesh_refused_naming_the_roadmap(mesh):
    with pytest.raises(SystemExit, match="A11.7"):
        train.main(SMOKE + ["--mesh", mesh, "--device", "cpu"])

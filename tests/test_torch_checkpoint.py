"""The port's checkpoint manager (``repro_torch.checkpoint``) on the CPU.

The seven tests of ``tests/test_checkpoint.py``, on a tree of the port's
own (nested dicts, a list, a NamedTuple and a tuple; f32, bf16, int32,
bool and uint32 leaves; random values from a numpy seed): round trip
with the manifest's ``extra``, keep-last-k collection, a step without a
manifest ignored, a shape mismatch refused, the async writer (its saves
and its surfaced failure), restore to ``device="cpu"`` in place of the
reference's cross-mesh restore, the manifest as JSON.

Both packages write the same format: a tree saved by either (f32, int32,
bool, bf16, a PRNG key's uint32 words and a ``SimState``) restores in the
other bit for bit, and the two manifests list the same keys, shapes and
dtypes.  Tolerance: none.
"""
import json
import os
import shutil
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import make_cluster_state
from repro.checkpoint import CheckpointManager as JManager
from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager, step_dir
from repro_torch.checkpoint.manager import ARRAYS, MANIFEST
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import prng


class Moments(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


@pytest.fixture()
def tree():
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return {
        "params": {"embed": _bf16(rng.integers(0, 2**16, (16, 8),
                                               dtype=np.uint16)),
                   "layers": [{"w": f32(8, 8), "b": f32(8)},
                              {"w": f32(8, 8), "b": f32(8)}]},
        "opt": Moments(mu=f32(8), nu=f32(8)),
        "pair": (torch.tensor(3, dtype=torch.int32),
                 torch.from_numpy(rng.random(5) < 0.5)),
        "key": prng.key_words(prng.PRNGKey(11)),
    }


def _target(tree):
    """``tree`` with its key as the port holds keys (int64 words)."""
    return dict(tree, key=prng.PRNGKey(11))


def _leaves(tree):
    from repro_torch.checkpoint.manager import _leaves as leaves
    return dict(leaves(tree))


def _trees_equal(want, got) -> bool:
    a, b = _leaves(want), _leaves(got)
    assert sorted(a) == sorted(b)
    for k in a:
        x = a[k] if isinstance(a[k], torch.Tensor) else torch.from_numpy(
            np.asarray(a[k]).astype(np.int64))
        y = b[k]
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu", k
        if x.dtype == torch.bfloat16:
            assert y.dtype == torch.bfloat16, k
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not (x.dtype == y.dtype and torch.equal(x, y)):
            return False
    return True


def test_save_restore_roundtrip(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree, extra={"tokens_seen": 123})
    restored, extra = mgr.restore(7, _target(tree), device="cpu")
    assert _trees_equal(tree, restored)
    assert extra["tokens_seen"] == 123
    assert isinstance(restored["opt"], Moments)
    assert isinstance(restored["params"]["layers"], list)
    assert restored["key"].dtype == torch.int64


def test_gc_keeps_last_k(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_incomplete_checkpoint_ignored(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    # a crash mid-save: arrays without a manifest
    d = step_dir(str(tmp_path), 2)
    os.makedirs(d)
    shutil.copy(os.path.join(step_dir(str(tmp_path), 1), ARRAYS),
                os.path.join(d, ARRAYS))
    assert mgr.latest_step() == 1  # step 2 invisible
    got = mgr.restore_latest(_target(tree), device="cpu")
    assert got is not None and got[0] == 1


def test_corrupt_shape_rejected(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    other = dict(_target(tree), opt=Moments(torch.zeros(8, 2),
                                            torch.zeros(8, 2)))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, other, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(1, {"absent": torch.zeros(1)}, device="cpu")


def test_async_checkpointer_overlaps_and_surfaces_errors(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    ac = AsyncCheckpointer(mgr)
    ac.save(1, tree)
    ac.save(2, tree)   # joins the first save implicitly
    ac.wait()
    assert mgr.all_steps() == [1, 2]
    restored, _ = mgr.restore(2, _target(tree), device="cpu")
    assert _trees_equal(tree, restored)
    # a write that fails on the worker thread is raised by wait()
    shutil.rmtree(str(tmp_path))
    ac.save(3, tree)
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()          # raised once, then cleared


def test_restore_places_leaves_on_the_requested_device(tmp_path, tree):
    """The reference's cross-mesh elastic restore re-places leaves under
    a target sharding; one GPU has no mesh, so the port's counterpart is
    ``device=``: every leaf arrives there with its saved dtype."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tree)
    restored, _ = mgr.restore(5, _target(tree), device="cpu")
    assert _trees_equal(tree, restored)
    leaf = restored["params"]["embed"]
    assert leaf.device == torch.device("cpu")
    assert leaf.dtype == torch.bfloat16


def test_manifest_is_json_readable(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree)
    with open(os.path.join(step_dir(str(tmp_path), 3), MANIFEST)) as f:
        m = json.load(f)
    assert m["step"] == 3
    assert len(m["keys"]) == len(_leaves(tree))
    assert m["dtypes"]["params/embed"] == "bfloat16"
    assert m["dtypes"]["key"] == "uint32"
    assert "opt/mu" in m["keys"] and "pair/1" in m["keys"]
    assert "params/layers/1/w" in m["keys"]


# ----------------------------------------------------------------------
# the two packages share the format
# ----------------------------------------------------------------------

def _corpus(seed: int):
    """One tree in each package's own types, from the same numpy draws:
    f32, int32, bool, bf16, the uint32 key of ``PRNGKey(seed)`` and a
    ``SimState``."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((4, 3)).astype(np.float32)
    i32 = rng.integers(-2**31, 2**31 - 1, (5,), dtype=np.int64).astype(
        np.int32)
    b = rng.random((2, 3)) < 0.5
    bits = rng.integers(0, 2**16, (3, 4), dtype=np.uint16)
    jstate = make_cluster_state(max_jobs=32, total_nodes=16, seed=seed)
    sdict = state_to_numpy(jstate)
    jtree = {"f32": jnp.asarray(f32), "i32": jnp.asarray(i32),
             "bool": jnp.asarray(b), "bf16": bits.view(ml_dtypes.bfloat16),
             "key": jax.random.PRNGKey(seed), "state": jstate}
    ttree = {"f32": torch.from_numpy(f32), "i32": torch.from_numpy(i32),
             "bool": torch.from_numpy(b), "bf16": _bf16(bits),
             "key": prng.key_words(prng.PRNGKey(seed)),
             "state": state_from_numpy(sdict, device="cpu")}
    return jtree, ttree


def _manifest(root, step):
    with open(os.path.join(step_dir(root, step), MANIFEST)) as f:
        m = json.load(f)
    return m["keys"], m["shapes"], m["dtypes"]


def _assert_port_tree_is(ttree, jtree):
    assert torch.equal(ttree["f32"], torch.from_numpy(np.array(
        jtree["f32"])))
    assert torch.equal(ttree["i32"], torch.from_numpy(np.array(
        jtree["i32"])))
    assert torch.equal(ttree["bool"], torch.from_numpy(np.array(
        jtree["bool"])))
    assert ttree["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ttree["bf16"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(jtree["bf16"]).view(np.uint16))
    np.testing.assert_array_equal(ttree["key"].numpy(),
                                  np.asarray(jtree["key"]).astype(np.int64))
    want, got = state_to_numpy(jtree["state"]), state_to_numpy(ttree["state"])
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_a_jax_checkpoint_restores_in_the_port(tmp_path, seed):
    jtree, ttree = _corpus(seed % 97)
    jtree["key"] = jax.random.PRNGKey(seed)
    ttree["key"] = prng.key_words(prng.PRNGKey(seed))
    JManager(str(tmp_path / "j")).save(4, jtree, extra={"who": "jax"})
    CheckpointManager(str(tmp_path / "t")).save(4, ttree,
                                                extra={"who": "jax"})
    assert _manifest(str(tmp_path / "j"), 4) == \
        _manifest(str(tmp_path / "t"), 4)
    target = dict(ttree, key=prng.PRNGKey(0))
    got, extra = CheckpointManager(str(tmp_path / "j")).restore(
        4, target, device="cpu")
    assert extra == {"who": "jax"}
    _assert_port_tree_is(got, jtree)


@pytest.mark.parametrize("seed", [0, 3])
def test_a_port_checkpoint_restores_in_jax(tmp_path, seed):
    jtree, ttree = _corpus(seed)
    CheckpointManager(str(tmp_path)).save(9, ttree, extra={"n": seed})
    got, extra = JManager(str(tmp_path)).restore(9, jtree)
    assert extra == {"n": seed}
    for k in ("f32", "i32", "bool", "key"):
        a, b = np.asarray(got[k]), np.asarray(jtree[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert np.asarray(got["bf16"]).dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(np.asarray(got["bf16"]).view(np.uint16),
                                  np.asarray(jtree["bf16"]).view(np.uint16))
    want, have = state_to_numpy(jtree["state"]), state_to_numpy(got["state"])
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    # and the restored key is a working JAX key: the same split
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(jnp.asarray(got["key"]))),
        prng.split(prng.PRNGKey(seed)).numpy())

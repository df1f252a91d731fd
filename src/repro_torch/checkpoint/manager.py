"""Fault-tolerant checkpointing — port of ``repro/checkpoint/manager.py``,
on the same disk format, so a checkpoint written by either package
restores in the other.

Layout (one directory per step)::

    <root>/step_000123/
        arrays.npz        # flat key -> ndarray
        MANIFEST.json     # step, keys, shapes/dtypes, written LAST

A checkpoint only exists once its manifest exists: the arrays are made
durable first, the manifest is written to a temp file and renamed, and
the step directory is published by one rename, so a crash mid-save never
leaves a half-readable checkpoint (restore scans for the newest
directory with a manifest and ignores stragglers).  ``keep`` bounds the
steps kept.

Trees are nested dicts, NamedTuples, tuples and lists (``None`` holds no
leaf); leaves are torch tensors, numpy arrays or Python scalars.  A
leaf's key is its path joined by ``/`` — dict keys, NamedTuple field
names, sequence indices — as the reference's ``tree_flatten_with_path``
names them.  Tensors are copied to the host on save.  bfloat16 is stored
as a uint16 view with its logical dtype in the manifest.  uint32 leaves
(PRNG key words, as the JAX package stores its keys; ``prng.key_words``
makes them from a port key) restore as int64 tensors holding the same
words, the port's key representation (``core/prng.py``).

``restore`` places every leaf on ``device`` (default ``cuda``) as a
torch tensor.  The reference's cross-mesh ``shardings=`` placement has
no counterpart on one GPU.

``AsyncCheckpointer`` copies the tree to host memory on the caller's
thread and writes it on a background thread; a failed write is raised by
the next ``save`` or ``wait``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

MANIFEST = "MANIFEST.json"
ARRAYS = "arrays.npz"

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(name, child) pairs of a container, in the reference's leaf
    order (dict keys sorted); None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, prefix: str = ""):
    """(key, leaf) pairs in flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out.extend(_leaves(child, f"{prefix}/{name}" if prefix else name))
    return out


def _tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` over every leaf, the containers rebuilt."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _flatten(tree: PyTree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """(storage arrays, logical dtypes) of a tree, on the host."""
    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:      # numpy has no bfloat16
                dtypes[key] = "bfloat16"
                flat[key] = t.view(torch.int16).numpy().view(np.uint16)
                continue
            arr = t.numpy()
        else:
            arr = np.asarray(leaf)
        dtypes[key] = str(arr.dtype)
        flat[key] = arr
    return flat, dtypes


def _place(arr: np.ndarray, logical_dtype: str,
           device: torch.device) -> torch.Tensor:
    """A stored array as the tensor it restores to."""
    if logical_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr)).to(device)


def _unflatten_into(tree: PyTree, flat: Dict[str, np.ndarray],
                    place: Callable[[str, np.ndarray], Any]) -> PyTree:
    """``tree``'s structure with ``place(key, array)`` of ``flat``'s
    arrays; each must have its target leaf's shape."""
    def rebuild(node, key):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            if key not in flat:
                raise KeyError(f"checkpoint missing array {key!r}")
            arr = flat[key]
            expected = tuple(np.shape(node))
            if tuple(arr.shape) != expected:
                raise ValueError(
                    f"checkpoint array {key!r} has shape {arr.shape}, "
                    f"expected {expected}")
            return place(key, arr)
        vals = {n: rebuild(c, f"{key}/{n}" if key else n) for n, c in kids}
        if isinstance(node, dict):
            return {k: vals[str(k)] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(vals[f] for f in node._fields))
        return type(node)(vals[str(i)] for i in range(len(node)))
    return rebuild(tree, "")


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3) -> None:
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    # ---------------- save ----------------
    def save(self, step: int, tree: PyTree,
             extra: Optional[Dict[str, Any]] = None) -> str:
        flat, dtypes = _flatten(tree)
        d = step_dir(self.root, step)
        tmp = tempfile.mkdtemp(dir=self.root, prefix=".tmp_save_")
        try:
            with open(os.path.join(tmp, ARRAYS), "wb") as f:
                np.savez(f, **flat)
                f.flush()
                os.fsync(f.fileno())
            manifest = {
                "step": step,
                "keys": sorted(flat),
                "shapes": {k: list(v.shape) for k, v in flat.items()},
                "dtypes": dtypes,
                "extra": extra or {},
            }
            mtmp = os.path.join(tmp, MANIFEST + ".tmp")
            with open(mtmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(mtmp, os.path.join(tmp, MANIFEST))
            if os.path.exists(d):
                shutil.rmtree(d)
            os.rename(tmp, d)            # atomic publish
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return d

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(step_dir(self.root, s), ignore_errors=True)

    # ---------------- discovery ----------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("step_"):
                continue
            if not os.path.exists(os.path.join(self.root, name, MANIFEST)):
                continue  # incomplete save — ignored
            try:
                out.append(int(name[len("step_"):]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(step_dir(self.root, step), MANIFEST)) as f:
            return json.load(f)

    # ---------------- restore ----------------
    def restore(self, step: int, target: PyTree,
                device: DeviceLike = "cuda"
                ) -> Tuple[PyTree, Dict[str, Any]]:
        """Load ``step`` into ``target``'s structure (its leaves give the
        keys and the expected shapes); every leaf comes back as a tensor
        on ``device``.  Returns ``(tree, extra)``."""
        dev = resolve_device(device)
        manifest = self.manifest(step)
        with np.load(os.path.join(step_dir(self.root, step), ARRAYS)) as data:
            flat = {k: data[k] for k in data.files}
        dtypes = manifest["dtypes"]
        tree = _unflatten_into(
            target, flat, lambda k, a: _place(a, dtypes.get(k, ""), dev))
        return tree, manifest.get("extra", {})

    def restore_latest(self, target: PyTree, device: DeviceLike = "cuda"
                       ) -> Optional[Tuple[int, PyTree, Dict[str, Any]]]:
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, target, device)
        return step, tree, extra


class AsyncCheckpointer:
    """Overlap checkpoint writes with the caller's work.

    ``save`` copies the tree to host memory on the caller's thread and
    hands the file I/O to a worker thread; ``wait`` joins any save in
    flight (call it before exit or before restoring).  A failed
    background save is raised by the next ``save`` or ``wait``.
    """

    def __init__(self, manager: CheckpointManager) -> None:
        self.manager = manager
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: PyTree,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        host_tree = _tree_map(
            lambda x: x.detach().cpu().clone()
            if isinstance(x, torch.Tensor) else np.array(x), tree)

        def work() -> None:
            try:
                self.manager.save(step, host_tree, extra)
            except Exception as e:  # noqa: BLE001 — raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

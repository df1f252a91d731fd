"""Build the port's CUDA kernels at first use and load them with ctypes.

Every source in ``SOURCES`` (one per kernel, under ``repro_torch/csrc/``)
is compiled by its own ``nvcc`` process, all started together, for
``sm_90a`` into a shared library with a plain C interface.  Libraries
land in ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``; ``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs when the module is imported.

``HOST_SOURCES`` are host C code on the CPython API (no CUDA): built the
same way with the host C compiler and the include directory that
``sysconfig`` names, on any host, and loaded with ``ctypes.PyDLL`` so
that a call holds the GIL.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES: Dict[str, Path] = {
    "policy_eval": _PKG / "csrc" / "policy_eval.cu",      # K1, K1'
    "rglru": _PKG / "csrc" / "rglru.cu",                  # K2
    "wkv6": _PKG / "csrc" / "wkv6.cu",                    # K3
    "flash_attention": _PKG / "csrc" / "flash_attention.cu",  # K4
    "priority_order": _PKG / "csrc" / "priority_order.cu",   # the order stage
    "drain_step": _PKG / "csrc" / "drain_step.cu",        # the drain's step
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_SOURCES: Dict[str, Path] = {
    "stack_scenarios": _PKG / "csrc" / "stack_scenarios.c",
}
HOST_FLAGS = ("-O2", "-shared", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _PKG.parents[1] / "build" / "repro_torch"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _hashed_path(name: str, source: Path, flags) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def library_path(name: str) -> Path:
    return _hashed_path(name, SOURCES[name], NVCC_FLAGS)


def build(names: Optional[Iterable[str]] = None,
          extra_flags: Tuple[str, ...] = (),
          force: bool = False) -> Dict[str, Tuple[float, str]]:
    """Compile every named source (default: all) that has no library yet
    (every one with ``force``), all ``nvcc`` processes started together.
    ``extra_flags`` (e.g. ``-Xptxas -v``) change the log, not the code.
    Returns ``{name: (seconds, compiler output)}`` for the sources it
    compiled; raises on a failed build."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if force or not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed.  Raises
    when no CUDA device is present: the kernels never run on the host."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"kernel {name!r} needs a CUDA device and torch sees none")
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    _LOADED[name] = lib
    return lib


def host_toolchain() -> Tuple[List[str], str]:
    """The host C compiler (``sysconfig``'s ``CC``, as words) and the
    directory holding ``Python.h``; raises where either is missing."""
    cc = shlex.split(sysconfig.get_config_var("CC") or "cc")
    if shutil.which(cc[0]) is None:
        raise RuntimeError(f"no host C compiler: {cc[0]!r} is not on PATH")
    include = sysconfig.get_paths()["include"]
    if not (Path(include) / "Python.h").exists():
        raise RuntimeError(f"no Python.h in {include}")
    return cc, include


def load_host(name: str) -> ctypes.PyDLL:
    """The loaded host library for ``name``, built first if needed.  A
    build writes a file of its own process and thread and renames it into
    place, so concurrent builds of one source are safe."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    cc, include = host_toolchain()
    cmd = [*cc, *HOST_FLAGS, f"-I{include}"]
    out = _hashed_path(name, HOST_SOURCES[name], cmd)
    if not out.exists():
        build_dir().mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([*cmd, "-o", str(tmp), str(HOST_SOURCES[name])],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{name}: {cc[0]} exited {proc.returncode}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.PyDLL(str(out))
    _LOADED[name] = lib
    return lib

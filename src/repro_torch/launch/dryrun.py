"""One-GPU dry run: what each (architecture x input shape) cell's step
would take on one H100, without allocating.  Port of
``repro/launch/dryrun.py``.

For every cell this runs the port's own step function -- the train step
of ``make_train_step`` (the registry's ``accum_steps``) for train cells,
``api.prefill(..., backend="cuda")`` for prefill cells, ``api.decode_step``
for decode cells -- on ``meta`` tensors (``specs.cell_inputs``) under
``counting.CostCounter``.  The kernels' meta branches count their calls and
work (K4 in every prefill but MLA's, K3 in rwkv6's, K2's gated entry in
recurrentgemma's); the per-token recurrences, the MoE chunk loop and the
microbatch loop run under trip counts.  The record keeps the reference's
keys: ``memory`` (``argument_bytes``: the step's inputs;
``peak_bytes_per_device``: the counter's peak, inputs included),
``roofline`` (FLOPs, the port's own eager HBM bytes -- more than the
reference's post-fusion count, not to be held against it -- and the
terms at the H100 SXM's data-sheet rates), ``n_params``,
``active_frac``, ``status``; plus ``kernel_calls`` and ``trace_s`` (the
seconds the meta run took) in place of ``lower_s``/``compile_s``.  Token
ids are int64 (the reference's are int32).

Usage::

    python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k --out results/dryrun
    python -m repro_torch.launch.dryrun --all --out results/dryrun
    python -m repro_torch.launch.dryrun --all --subprocess  # isolate cells

``--mesh single`` is the one card; ``multi`` and ``both`` (the
reference's 256- and 512-chip TPU meshes) are refused: the mesh code is
ROADMAP A11.7.  Runs on any host: nothing touches a device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple


from repro_torch.configs import SHAPES, SHAPE_ORDER, cell_applicable, \
    get_config
from repro_torch.configs.registry import ARCH_ORDER
from repro_torch import counting
from repro_torch.launch import cost
from repro_torch.launch.specs import cell_inputs
from repro_torch.models import api
from repro_torch.models.common import count_params
from repro_torch.train.train_step import make_train_step

#: The record's ``mesh``: one card.
MESH = "1xH100"


def _active_param_fraction(cfg) -> float:
    """MoE: fraction of params active per token (shared+top_k experts)."""
    if cfg.family != "moe":
        return 1.0
    table = api.param_table(cfg)
    expert = sum(
        int(_prod(shape)) for name, (shape, _) in table.items()
        if ".moe.w_" in name or name.startswith("moe.w_"))
    total = count_params(table)
    m = cfg.moe
    return (total - expert + expert * m.top_k / m.n_experts) / total


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the tree's tensors, each storage once."""
    out = {}
    for t in counting.tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def run_step(spec, cell):
    """Run the cell's step on ``spec``'s inputs (meta, or real tensors on
    the device they lie on); returns its outputs."""
    cfg = spec.cfg
    dev = counting.tensors(spec.args)[0].device
    if spec.kind == "train":
        return make_train_step(cfg, device=dev)(*spec.args)
    if spec.kind == "prefill":
        params, batch = spec.args
        return api.prefill(cfg, params, batch, backend="cuda")
    params, caches, tokens, _ = spec.args
    # the port's decode index is a host int: the cache's last position
    return api.decode_step(cfg, params, caches,
                           {"tokens": tokens, "index": cell.seq_len - 1},
                           backend="cuda")


def count_step(spec, cell) -> Tuple[counting.CostCounter, object]:
    """``run_step`` under a new ``CostCounter`` that tracks the inputs
    (``base``: their bytes); returns (the counter, the outputs)."""
    ctr = counting.CostCounter()
    ctr.track(spec.args)
    with ctr:
        out = run_step(spec, cell)
    return ctr, out


def run_cell(arch: str, shape_name: str) -> Dict:
    """Run one cell on meta under the counter; return its record (the
    reference's ``run_cell`` on the one card: no ``multi_pod``)."""
    cell = SHAPES[shape_name]
    cfg = get_config(arch)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": MESH,
                 "kind": cell.kind, "status": ""}
    if not cell_applicable(shape_name, cfg.supports_long_context):
        rec["status"] = "skipped"
        rec["skip_reason"] = ("full quadratic attention at 500k context; "
                              "see DESIGN.md §4")
        return rec

    t0 = time.time()
    spec = cell_inputs(arch, cell, cfg)
    args = _storages(spec.args)
    ctr, out = count_step(spec, cell)
    rec["status"] = "ok"
    rec["trace_s"] = round(time.time() - t0, 1)
    outs = _storages(out)
    alias = sum(n for k, n in outs.items() if k in args)
    out_bytes = sum(outs.values())
    rec["memory"] = {
        "argument_bytes": ctr.base, "output_bytes": out_bytes,
        "temp_bytes": ctr.peak - ctr.base, "alias_bytes": alias,
        "peak_bytes_per_device": ctr.peak,
    }
    rec["kernel_calls"] = dict(ctr.kernel_calls)
    del out, spec

    n_params, act, mf = model_flops(cfg, cell)
    rl = cost.Roofline(ctr.flops, ctr.bytes).finalize(model_flops=mf)
    rec["roofline"] = rl.to_dict()
    rec["n_params"] = n_params
    rec["active_frac"] = act
    return rec


def model_flops(cfg, cell) -> Tuple[int, float, float]:
    """(n_params, active fraction, useful FLOPs) of a cell, as the
    reference's ``run_cell`` counts them: 6·N·T to train, 2·N·T to
    prefill, 2·N a decoded token; N the active parameters."""
    n_params = count_params(api.param_table(cfg))
    # input-embedding rows do no matmul FLOPs (pure gather); with
    # tied embeddings the table still earns its flops in the
    # unembed dot, so only UNtied input tables are excluded.
    if not cfg.tie_embeddings:
        n_params -= cfg.vocab_size * cfg.d_model
    act = _active_param_fraction(cfg)
    tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        mf = cost.model_flops_train(n_params, tokens, act)
    elif cell.kind == "prefill":
        mf = 2.0 * n_params * act * tokens
    else:
        mf = cost.model_flops_decode(n_params, cell.global_batch, act)
    return n_params, act, mf


def fmt_cell(rec: Dict) -> str:
    if rec["status"] == "skipped":
        return (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
                f"SKIP ({rec['skip_reason'][:40]}...)")
    r = rec.get("roofline", {})
    mem = rec.get("memory", {})
    peak = mem.get("peak_bytes_per_device", 0) / 2**30
    return (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"ok  trace={rec['trace_s']:6.1f}s "
            f"peak={peak:7.2f}GiB/dev "
            f"Tc={r.get('t_compute', 0)*1e3:9.2f}ms "
            f"Tm={r.get('t_memory', 0)*1e3:9.2f}ms "
            f"Tcoll={r.get('t_collective', 0)*1e3:8.2f}ms "
            f"bound={r.get('bottleneck','-'):10s} "
            f"useful={r.get('useful_ratio', 0)*100:5.1f}%")


_MESH_REFUSAL = ("--mesh {mesh} is not ported to repro_torch (the dry run "
                 "costs one GPU; mesh code is ROADMAP A11.7)")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in its own process (isolation)")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise SystemExit(_MESH_REFUSAL.format(mesh=args.mesh))

    archs = list(ARCH_ORDER) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPE_ORDER) if args.all or not args.shape \
        else [args.shape]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__single"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
                print("cached:", fmt_cell(rec))
                continue
            if args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", "single",
                       "--out", args.out]
                r = subprocess.run(cmd)
                if r.returncode != 0:
                    failures += 1
                continue
            try:
                rec = run_cell(arch, shape)
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "mesh": MESH,
                       "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                failures += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(fmt_cell(rec) if rec["status"] != "error"
                  else f"{arch:24s} {shape:12s} ERROR {rec['error'][:80]}",
                  flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()

"""The one-GPU dry run (``repro_torch.launch.dryrun``, ``specs``,
``roofline``, ``configs/shapes.py``) against the JAX package's.

* ``SHAPES``, ``SHAPE_ORDER`` and ``cell_applicable`` equal the
  reference's.
* For all ten architectures x four shapes, every leaf of ``cell_inputs``
  lies on meta and has the reference's shape and dtype (params by name,
  batch keys, caches by leaf, the train state), token ids int64 where the
  reference's are int32 (``specs.TOKEN_DTYPE``).  The carried-over
  ``test_dryrun_cell_inputs_are_abstract``: (256, 4096) tokens, rwkv6's
  ``long_500k`` tokens (1, 1).
* ``_active_param_fraction``, ``n_params`` and the model FLOPs of every
  cell equal the reference's for all ten archs (the carried-over
  ``test_active_param_fraction_moe``).  Importing ``repro.launch.dryrun``
  sets ``XLA_FLAGS`` to 512 host devices: JAX's backend is initialised
  first and the variable restored after.
* FLOPs against the reference: llama3.2-1b's and olmoe-1b-7b's smoke
  configs, a prefill (the plain attention on both sides) and one decode
  step: the port's meta count equals
  ``HloModule(compiled.as_text()).cost().flops`` of the reference's same
  function jitted on the CPU, exactly (tolerance: none; no class of op
  parts them at these shapes: every FLOP on both sides is a matrix
  product, and XLA:CPU rewrote none of them).
* The CLI: ``--arch llama3.2-1b --shape decode_32k`` writes a record
  with the reference's keys (``trace_s`` and ``kernel_calls`` in place of
  ``lower_s``/``compile_s``); ``--mesh multi``/``both`` are refused
  naming ROADMAP A11.7; a full-attention arch's ``long_500k`` is skipped
  with the reference's record; a K4 prefill counts its kernel calls;
  ``roofline.main`` prints the reference's header and a line per record.
"""
import dataclasses
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._pytree import keystr, tree_flatten_with_path

from repro.configs import SHAPES as JSHAPES
from repro.configs import SHAPE_ORDER as JSHAPE_ORDER
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import specs as jspecs
from repro.launch.hlo_analysis import HloModule
from repro.launch.hlo_analysis import Roofline as JRoofline
from repro.launch.hlo_analysis import model_flops_decode as jmf_decode
from repro.launch.hlo_analysis import model_flops_train as jmf_train
from repro.models import api as japi
from repro.models.common import abstract_params as jabstract
from repro.models.common import count_params as jcount
from repro_torch.configs import (ARCH_ORDER, SHAPES, SHAPE_ORDER,
                                 cell_applicable, get_config,
                                 get_smoke_config)
from repro_torch import counting
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.models import api
from repro_torch.models.common import abstract_params

B, S = 2, 40


def _jleaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), jnp.dtype(x.dtype))
            for p, x in flat}


def _tleaves(tree):
    flat, _ = tree_flatten_with_path(tree)
    return {keystr(p): x for p, x in flat if x is not None}


_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.int32: jnp.int32}


def test_shapes_equal_the_reference():
    assert SHAPE_ORDER == JSHAPE_ORDER
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    for name in SHAPE_ORDER:
        for long_ok in (False, True):
            assert cell_applicable(name, long_ok) == jcell_applicable(
                name, long_ok)


@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_cell_inputs_match_the_reference(arch):
    for shape in SHAPE_ORDER:
        spec = specs.cell_inputs(arch, SHAPES[shape])
        want = jspecs.cell_inputs(arch, JSHAPES[shape])
        assert spec.kind == want.kind == SHAPES[shape].kind
        got, ref = _tleaves(spec.args), _jleaves(want.args)
        assert sorted(got) == sorted(ref), (arch, shape)
        for path, t in got.items():
            assert t.device.type == "meta", (arch, shape, path)
            shape_, dtype = ref[path]
            assert tuple(t.shape) == shape_, (arch, shape, path)
            token = dtype == jnp.int32 and (
                "tokens" in path or "labels" in path or path == "[2]")
            want_dtype = specs.TOKEN_DTYPE if token else next(
                k for k, v in _DTYPES.items() if v == dtype)
            assert t.dtype == want_dtype, (arch, shape, path, t.dtype)


def test_dryrun_cell_inputs_are_abstract():
    spec = specs.cell_inputs("llama3.2-1b", SHAPES["train_4k"])
    leaves = list(_tleaves(spec.args).values())
    assert all(isinstance(x, torch.Tensor) and x.is_meta for x in leaves)
    assert spec.args[1]["tokens"].shape == (256, 4096)
    spec_d = specs.cell_inputs("rwkv6-7b", SHAPES["long_500k"])
    assert spec_d.kind == "decode"
    assert spec_d.args[2].shape == (1, 1)   # tokens (B=1, 1)
    flat = specs.input_specs("llama3.2-1b", "decode_32k")
    assert set(flat) == {"params", "caches", "tokens", "index"}


def test_param_counts_and_model_flops_match_the_reference(monkeypatch):
    jax.devices()           # the backend first: the import below sets
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jdryrun   # ... XLA_FLAGS (undone)
    assert dryrun._active_param_fraction(get_config("llama3.2-1b")) == 1.0
    f_moe = dryrun._active_param_fraction(get_config("olmoe-1b-7b"))
    assert 0.0 < f_moe < 0.5      # 8 of 64 experts + backbone
    from repro.configs import get_config as jget_config
    for arch in ARCH_ORDER:
        cfg, jcfg = get_config(arch), jget_config(arch)
        act = dryrun._active_param_fraction(cfg)
        assert act == jdryrun._active_param_fraction(jcfg), arch
        n = jcount(japi.param_table(jcfg))
        if not jcfg.tie_embeddings:
            n -= jcfg.vocab_size * jcfg.d_model
        for shape in SHAPE_ORDER:
            rec = dryrun.run_cell(arch, shape) \
                if not cell_applicable(shape, cfg.supports_long_context) \
                else None
            if rec is not None:
                assert rec["status"] == "skipped"
                continue
            cell = SHAPES[shape]
            tokens = cell.global_batch * cell.seq_len
            want = {"train": lambda: jmf_train(n, tokens, act),
                    "prefill": lambda: 2.0 * n * act * tokens,
                    "decode": lambda: jmf_decode(n, cell.global_batch,
                                                 act)}[cell.kind]()
            got = dryrun.model_flops(cfg, cell)
            assert got == (n, act, want), (arch, shape)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_flops_equal_the_reference_hlo_count(arch, mesh11, rules_decode):
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jparams = jabstract(japi.param_table(jcfg), jnp.float32)
    params = abstract_params(api.param_table(cfg), torch.float32)
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    with mesh11:
        comp = jax.jit(functools.partial(japi.prefill, jcfg, rules_decode)
                       ).lower(jparams, {"tokens": tokens}).compile()
    want = HloModule(comp.as_text()).cost().flops
    with counting.CostCounter() as c:
        api.prefill(cfg, params, {"tokens": torch.empty(
            (B, S), dtype=torch.int64, device="meta")}, backend="reference")
    assert c.flops == want > 0
    jcaches = jax.eval_shape(lambda: japi.init_caches(jcfg, B, S + 8))
    step = {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32),
            "index": jax.ShapeDtypeStruct((), jnp.int32)}
    with mesh11:
        comp = jax.jit(functools.partial(japi.decode_step, jcfg,
                                         rules_decode)).lower(
            jparams, jcaches, step).compile()
    want = HloModule(comp.as_text()).cost().flops
    caches = api.init_caches(cfg, B, S + 8, device="meta")
    with counting.CostCounter() as c:
        api.decode_step(cfg, params, caches, {"tokens": torch.empty(
            (B, 1), dtype=torch.int64, device="meta"), "index": S + 7},
            backend="reference")
    assert c.flops == want > 0


def test_cli_writes_the_reference_record(tmp_path, capsys):
    out = str(tmp_path / "dr")
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--out", out])
    line = capsys.readouterr().out
    assert line.startswith("llama3.2-1b") and "decode_32k" in line
    with open(os.path.join(out, "llama3.2-1b__decode_32k__single.json")) as f:
        rec = json.load(f)
    want = {"arch", "shape", "mesh", "kind", "status", "memory",
            "roofline", "n_params", "active_frac"}
    assert set(rec) == want | {"trace_s", "kernel_calls"}
    assert (rec["status"], rec["mesh"], rec["kind"]) == (
        "ok", dryrun.MESH, "decode")
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_bytes_per_device"}
    assert set(rec["roofline"]) == {
        f.name for f in dataclasses.fields(JRoofline)}
    mem, rl = rec["memory"], rec["roofline"]
    # the bf16 cache: 16 layers x K and V x 8 heads x 64 x 32,768 x 128
    cache = 16 * 2 * 8 * 64 * 32_768 * 128 * 2
    assert mem["argument_bytes"] > cache
    assert mem["alias_bytes"] == cache          # written in place
    assert mem["peak_bytes_per_device"] > mem["argument_bytes"]
    assert rl["bottleneck"] == "memory" and rl["flops"] > 0
    assert rec["kernel_calls"] == {}            # decode runs no kernel
    # cached on a second run
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--out", out])
    assert capsys.readouterr().out.startswith("cached:")
    lines = roofline.main(["--dir", out])
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "roofline.py")
    loader = importlib.util.spec_from_file_location("jroofline", path)
    jroofline = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(jroofline)
    assert lines[0] == jroofline.table_lines([])[0]
    assert len(lines) == 2 and lines[1].startswith(
        "roofline,llama3.2-1b,decode_32k,ok,")
    assert roofline.main(["--dir", str(tmp_path / "none")])[0].startswith(
        "roofline,no records found")


@pytest.mark.parametrize("mesh", ["multi", "both"])
def test_mesh_refused_naming_the_roadmap(mesh, tmp_path):
    with pytest.raises(SystemExit, match="A11.7"):
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                     "--mesh", mesh, "--out", str(tmp_path)])


def test_long_context_skip_is_the_reference_record(monkeypatch):
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jdryrun
    got = dryrun.run_cell("llama3.2-1b", "long_500k")
    want = jdryrun.run_cell("llama3.2-1b", "long_500k", False)
    assert {**got, "mesh": None} == {**want, "mesh": None}
    assert got["status"] == "skipped"


def test_prefill_counts_its_kernel_calls():
    """A K4 prefill on meta: one call a layer, the kernel's work in the
    FLOPs, nothing launched."""
    from repro_torch.kernels import flash_attention as fa
    launches = fa.LAUNCHES
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    cell = SHAPES["prefill_32k"].__class__("p", 1024, 2, "prefill")
    spec = specs.cell_inputs("llama3.2-1b", cell, cfg)
    ctr, (logits, caches) = dryrun.count_step(spec, cell)
    assert fa.LAUNCHES == launches
    assert logits.shape == (2, 1, cfg.vocab_size) and logits.is_meta
    assert ctr.kernel_calls == {"flash_attention": 2}
    assert ctr.kernel_flops["flash_attention"] == 2 * fa.work(
        2, 32, 8, 1024, 1024, 64, causal=True)[0]
    assert ctr.peak > ctr.base > 0

"""The port's LM stack (``repro_torch.models``, ``convert``) against the
JAX package's, for the families it serves: ``dense`` (llama3.2-1b),
``ssm`` (rwkv6-7b), ``hybrid`` (recurrentgemma-2b: a scanned (rglru,
rglru, local) pattern segment, then a remainder rglru layer, with
nested per-block caches), ``moe`` (deepseek-v2-lite-16b: an unscanned
dense_mla layer, then MLA + MoE layers with compressed caches;
olmoe-1b-7b: GQA + MoE), ``vlm`` (internvl2-76b: patch embeddings
projected and prepended) and ``encdec`` (whisper-small: encoder, then a
decoder with self and cross caches).

* ``param_table``: names, shapes and logical axes equal to JAX's, full
  size and smoke, for all ten architectures; ``count_params`` equal at
  full size (no allocation).
* ``convert``: ``params_to_numpy(params_from_numpy(d)) == d`` bitwise,
  in float32 and (for bf16-representable values) in bfloat16.
* Smoke configs, float32 parameters made by JAX's ``init_params`` and
  carried across with ``convert``: ``prefill`` logits and caches, then
  one ``decode_step`` (logits and updated caches), against JAX's
  ``api.prefill`` (jitted) and ``api.decode_step`` (eager: jitted, XLA
  keeps bf16 intermediates in f32).  The vlm's prefill takes 8 patch
  embeddings and its decode index counts them; whisper's takes frames as
  long as the prompt, and its cross caches are zero-padded to
  ``max_seq`` for decode, as the serving engines store them (C16).  The
  moe family's case, with its routing in chunks, is
  ``tests/test_torch_moe.py::test_chunked_prefill_and_decode_match_jax``.  Tolerance: rtol 1e-4 with
  atol 1e-5 on f32 values (logits, prefill caches, the wkv state: XLA
  and torch sum in different orders); caches stored in bf16 (decode's
  KV and token-shift rows) to one bf16 ulp, atol 1e-2 relative to the
  values' scale (an f32 value within rounding distance of a bf16 tie
  can round either way).  The prompts (21 and 32 tokens) are longer than
  recurrentgemma's smoke window of 16, so the local layer's prefill
  window and its decode ring both wrap.
* The port's own golden consistency, as ``tests/test_models_smoke.py``
  checks JAX's: prefill(S tokens) + decode(token S) equals prefill(S+1
  tokens) at the last position, with bf16 weights from the port's own
  init (same tolerances as the JAX test: 3e-2 dense, 5e-2 RWKV; 5e-2 for
  recurrentgemma, whose f32 recurrence meets bf16 activations as
  RWKV's does).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import api as japi
from repro.models.common import count_params as jcount
from repro.models.common import init_params as jinit
from repro_torch import convert
from repro_torch.configs import ARCH_ORDER, get_config, get_smoke_config
from repro_torch.models import api, common
from repro_torch.serve.engine import _write_slot

ARCHS = ("llama3.2-1b", "rwkv6-7b", "recurrentgemma-2b")
NEW_ARCHS = ("deepseek-v2-lite-16b", "olmoe-1b-7b", "internvl2-76b",
             "whisper-small")
#: count_params at published widths, from JAX's tables
PARAMS = {"granite-20b": 28_167_493_632, "granite-3-2b": 2_634_201_088,
          "llama3.2-1b": 1_235_814_400, "qwen2-72b": 72_706_203_648,
          "internvl2-76b": 70_620_815_360,
          "deepseek-v2-lite-16b": 15_706_484_224,
          "olmoe-1b-7b": 6_919_096_320, "rwkv6-7b": 7_577_014_272,
          "recurrentgemma-2b": 3_549_934_080,
          "whisper-small": 238_283_520}
RTOL, ATOL = 1e-4, 1e-5
CPU = "cpu"


def _cfgs(arch, gqa=False):
    over = dict(n_kv_heads=2) if gqa else {}
    return jget_smoke(arch, **over), get_smoke_config(arch, **over)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, gqa=False):
    jcfg, _ = _cfgs(arch, gqa)
    params = jinit(jax.random.PRNGKey(0), japi.param_table(jcfg),
                   dtype=jnp.float32)
    return params, {k: np.asarray(v, dtype=np.float32)
                    for k, v in params.items()}


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _close_bf16(got, want, what):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(_np(got), want, rtol=2 ** -7,
                               atol=1e-2 * scale, err_msg=what)


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_param_table_matches_jax(arch, smoke):
    jcfg = jget_smoke(arch) if smoke else jget_config(arch)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    want = japi.param_table(jcfg)
    got = api.param_table(cfg)
    assert list(got) == list(want)
    for name in want:
        assert tuple(got[name][0]) == tuple(want[name][0]), name
        assert tuple(got[name][1]) == tuple(want[name][1]), name
    assert common.count_params(got) == jcount(want)
    if not smoke:
        assert common.count_params(got) == PARAMS[arch]


@pytest.mark.parametrize("how", ["init_model", "init_params"])
def test_init_rules(how):
    """The reference's init rules, from ``api.init_model`` (per-layer
    parameters) and from ``common.init_params`` (the flat table)."""
    cfg = get_smoke_config("rwkv6-7b")
    table = api.param_table(cfg)
    if how == "init_model":
        d, d2 = (convert.params_to_numpy(api.init_model(
            cfg, seed=3, dtype=torch.float32, device=CPU)) for _ in range(2))
    else:
        d, d2 = ({k: v.numpy() for k, v in common.init_params(
            3, table, torch.float32, CPU).items()} for _ in range(2))
    assert set(d) == set(table)
    for name, arr in d.items():
        np.testing.assert_array_equal(arr, d2[name])     # same seed
        kind, std = common.init_rule(name, table[name][0])
        if kind == "ones":
            assert np.all(arr == 1.0), name
        elif kind == "zeros":
            assert np.all(arr == 0.0), name
        else:
            assert std == min(0.02, 1 / np.sqrt(table[name][0][-2]))
            assert 0.5 * std < arr.std() < 1.5 * std, name


# ---------------------------------------------------------------- convert

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS)
def test_convert_round_trip(arch, dtype):
    jcfg, cfg = _cfgs(arch)
    _, d = _jax_params(arch)
    if dtype == torch.bfloat16:           # bf16-representable values
        d = {k: torch.from_numpy(v).bfloat16().float().numpy()
             for k, v in d.items()}
    model = convert.params_from_numpy(cfg, d, device=CPU, dtype=dtype)
    assert model.dtype == dtype
    back = convert.params_to_numpy(model)
    assert set(back) == set(d)
    for name in d:
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], d[name], err_msg=name)
    # layer j of a scanned entry is slice j of the stacked array; an
    # unscanned layer holds its entry whole
    name = {"llama3.2-1b": "seg0.attn.wq", "rwkv6-7b": "seg0.tm.wr",
            "recurrentgemma-2b": "seg0.p2.attn.wq",
            "olmoe-1b-7b": "seg0.moe.w_gate", "internvl2-76b": "seg0.attn.wq",
            "deepseek-v2-lite-16b": "seg1.mla.w_uk",
            "whisper-small": "dec.cross.wk"}[arch]
    stack, key = name.split(".", 1)
    layers = (model.dec if stack == "dec"
              else model.segs[int(stack[len("seg"):])])
    j = len(layers) - 1
    layer = layers[j].get_parameter(key)
    np.testing.assert_array_equal(layer.float().numpy(), d[name][j])
    unscanned = {"recurrentgemma-2b": (1, "rg.w_in"),
                 "deepseek-v2-lite-16b": (0, "mla.wq")}
    if arch in unscanned:
        seg, key = unscanned[arch]
        layer = model.segs[seg][0].get_parameter(key)
        np.testing.assert_array_equal(layer.float().numpy(),
                                      d[f"seg{seg}.l0.{key}"])
    if arch == "internvl2-76b":
        np.testing.assert_array_equal(
            model.top.patch_proj.float().numpy(), d["patch_proj"])
    with pytest.raises(KeyError):
        convert.params_from_numpy(cfg, {**d, "bogus": d["embed"]},
                                  device=CPU)


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("arch,gqa", [("llama3.2-1b", False),
                                      ("llama3.2-1b", True),
                                      ("rwkv6-7b", False),
                                      ("recurrentgemma-2b", False),
                                      ("internvl2-76b", False),
                                      ("whisper-small", False)],
                         ids=["llama", "llama-gqa", "rwkv", "rgemma",
                              "internvl2", "whisper"])
def test_prefill_and_decode_match_jax(arch, gqa, mesh11, rules_decode):
    jcfg, cfg = _cfgs(arch, gqa)
    jparams, npd = _jax_params(arch, gqa)
    model = convert.params_from_numpy(cfg, npd, device=CPU,
                                      dtype=torch.float32)
    b, s = 2, 21                            # S not a multiple of q_block
    toks = _tokens(cfg, b, s + 1, seed=7)
    # the vlm's patch embeddings / whisper's frames, numpy f32
    rng = np.random.default_rng(9)
    extra = ({"patches": rng.standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)}
        if cfg.family == "vlm" else
        {"frames": rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)} if cfg.family == "encdec" else {})
    n_pre = s + cfg.n_patches                 # prefill positions
    max_seq = n_pre + 8
    with mesh11:
        jlogits, jcaches = jax.jit(functools.partial(
            japi.prefill, jcfg, rules_decode))(
                jparams, {"tokens": jnp.asarray(toks[:, :s]),
                          **{k: jnp.asarray(v) for k, v in extra.items()}})
    with torch.inference_mode():
        logits, caches = api.prefill(
            cfg, model, {"tokens": torch.from_numpy(toks[:, :s]).long(),
                         **{k: torch.from_numpy(v)
                            for k, v in extra.items()}})
    assert logits.shape == (b, 1, cfg.vocab_size)
    assert logits.dtype == torch.float32
    _close(logits, jlogits, "prefill logits")
    flat, jflat = _flat(caches), _flat(jcaches)
    assert set(flat) == set(jflat)
    for name, want in jflat.items():
        _close(flat[name], want, f"prefill cache {name}")

    # decode one token from caches padded to max_seq (bf16, as served):
    # the port's slot writes match JAX's padding, and both packages then
    # decode from the port's cache bytes (an f32 value at a bf16 rounding
    # tie may round apart in the two, which would move the logits by
    # more than their tolerance)
    jfull = japi.init_caches(jcfg, b, max_seq)
    jfull = jax.tree.map(_blit, jfull, jcaches)
    full = api.init_caches(cfg, b, max_seq, device=CPU)
    jflat_full = _flat(jfull)
    for name, big in _flat(full).items():
        for slot in range(b):
            _write_slot(big, flat[name][slot:slot + 1], slot)
        (_close if big.dtype == torch.float32 else _close_bf16)(
            big, jflat_full[name], f"slot cache {name}")
    jfull = _tree_like(jfull, full)
    step = toks[:, s:]
    with mesh11:
        # eager: jitted, XLA keeps bf16 intermediates in f32
        jlogits2, jcaches2 = japi.decode_step(
            jcfg, rules_decode, jparams, jfull,
            {"tokens": jnp.asarray(step), "index": jnp.int32(n_pre)})
    with torch.inference_mode():
        logits2, caches2 = api.decode_step(
            cfg, model, full, {"tokens": torch.from_numpy(step).long(),
                               "index": n_pre})
    _close(logits2, jlogits2, "decode logits")
    flat2 = _flat(caches2)
    for name, want in _flat(jcaches2).items():
        got = flat2[name]
        assert got.dtype == {jnp.float32: torch.float32,
                             jnp.bfloat16: torch.bfloat16}[
                                 jnp.dtype(want.dtype).type]
        if got.dtype == torch.float32:
            _close(got, want, f"decode cache {name}")
        else:
            _close_bf16(got, want, f"decode cache {name}")


def _flat(tree, prefix=""):
    """``{dotted name: leaf}`` of nested cache dicts (either package's)."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{key}."))
        else:
            out[prefix + key] = leaf
    return out


def _tree_like(jtree, tree):
    """``tree``'s leaves (the port's) as JAX arrays of ``jtree``'s
    dtypes."""
    return {key: _tree_like(jleaf, tree[key]) if isinstance(jleaf, dict)
            else jnp.asarray(_np(tree[key])).astype(jleaf.dtype)
            for key, jleaf in jtree.items()}


def _blit(big, small):
    """``small`` zero-padded up to ``big``'s shape, in ``big``'s dtype (as
    the engine's slot writes store it)."""
    if big.shape == small.shape:
        return small.astype(big.dtype)
    pads = [(0, b - s) for b, s in zip(big.shape, small.shape)]
    return jnp.pad(small, pads).astype(big.dtype)


@pytest.mark.parametrize("arch,tol", [("llama3.2-1b", 3e-2),
                                      ("rwkv6-7b", 5e-2),
                                      ("recurrentgemma-2b", 5e-2)])
def test_decode_matches_full_forward(arch, tol):
    """prefill(S) + decode(token S) == prefill(S+1) at the last
    position, on the port alone (bf16 weights from its own init)."""
    cfg = get_smoke_config(arch)
    model = api.init_model(cfg, seed=0, device=CPU)
    b, s = 2, 32
    toks = torch.from_numpy(_tokens(cfg, b, s + 1, seed=5)).long()
    with torch.inference_mode():
        want, _ = api.prefill(cfg, model, {"tokens": toks})
        _, caches = api.prefill(cfg, model, {"tokens": toks[:, :s]})
        full = api.init_caches(cfg, b, s + 1, device=CPU)
        flat = _flat(caches)
        for name, big in _flat(full).items():
            small = flat[name]
            big[tuple(slice(0, n) for n in small.shape)] = small
        got, _ = api.decode_step(cfg, model, full,
                                 {"tokens": toks[:, s:], "index": s})
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                               rtol=tol)

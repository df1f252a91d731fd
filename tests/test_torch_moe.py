"""The port's MoE FFN and MLA attention (``repro_torch.models.blocks_moe``)
against the JAX package's, at smoke size on the CPU.

* ``moe_apply``, both dispatches (``gather``, ``gshard``), on one chunk,
  on ``MOE_CHUNK`` = 16 in both packages (two whole chunks: the scan,
  aux terms averaged and ``moe_dropped`` summed over chunks) and on a
  ragged count (the single-chunk fallback at the whole count's
  capacity).  float32 weights from JAX's ``init_params``, inputs from
  numpy: y and the aux terms rtol 1e-4 / atol 1e-5; ``moe_dropped``
  equal, and nonzero where the inputs make experts overflow.
* The router: top-k indices equal to ``jax.lax.top_k``'s, a forced tie
  (two router columns equal) going to the lower expert index in both.
* C17: GShard weights each kept choice by its token's kept gate sum;
  gather with its gates replaced by that sum gives GShard's y.
* MLA prefill (decompressed, v narrower than q·k) and absorbed decode
  against JAX: outputs rtol 1e-4 / atol 1e-5, the compressed caches.
* deepseek-v2-lite-16b and olmoe-1b-7b smoke models with chunked
  routing (``MOE_CHUNK`` = 16): prefill logits and caches, then one
  decode step from bf16 slot caches, against JAX on JAX's weights.
* On the port alone: prefill(S) + decode(token S) == prefill(S + 1) at
  the last position, with a capacity factor that drops nothing (with
  drops the last token of a long prefill can lose an expert that a
  one-token decode keeps); 3e-2, as the dense check.
* Ports of ``test_perf_paths.py::test_moe_gather_dispatch_matches_gshard``
  and of ``test_models_smoke.py::test_moe_aux_losses_present``'s aux
  terms, read from ``moe_apply`` (the training loss is not ported).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import api as japi
from repro.models import blocks_moe as jbm
from repro.models.common import init_params as jinit
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import api, common
from repro_torch.models import blocks_moe as bm
from repro_torch.serve.engine import _write_slot

RTOL, ATOL = 1e-4, 1e-5
CPU = "cpu"
AUX = ("moe_aux", "moe_z")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _dispatch(cfg, dispatch):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))


@functools.lru_cache(maxsize=None)
def _moe_params(arch="olmoe-1b-7b", tie=False):
    """JAX's f32 MoE table params and the port's copy ({name: tensor});
    ``tie`` makes router columns 3 and 5 equal."""
    params = jinit(jax.random.PRNGKey(0), jbm.moe_table(jget_smoke(arch)),
                   dtype=jnp.float32)
    if tie:
        r = params["moe.router"]
        params = {**params, "moe.router": r.at[:, 5].set(r[:, 3])}
    return params, {k: torch.from_numpy(np.array(v))
                    for k, v in params.items()}


def _x(b, s, d, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, s, d))).astype(np.float32)


def _jax_moe(cfg, rules, params, x, chunk):
    old = jbm.MOE_CHUNK
    jbm.MOE_CHUNK = chunk
    try:
        return jax.jit(functools.partial(jbm.moe_apply, cfg, rules))(
            params, jnp.asarray(x))
    finally:
        jbm.MOE_CHUNK = old


CASES = {"one-chunk": (1, 21, 2048), "chunked": (2, 16, 16),
         "ragged": (2, 21, 16)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dispatch", ["gather", "gshard"])
def test_moe_apply_matches_jax(dispatch, case, monkeypatch, mesh11,
                               rules_decode):
    b, s, chunk = CASES[case]
    cfg = _dispatch(get_smoke_config("olmoe-1b-7b"), dispatch)
    jcfg = _dispatch(jget_smoke("olmoe-1b-7b"), dispatch)
    jparams, params = _moe_params()
    x = _x(b, s, cfg.d_model, seed=11)
    with mesh11:
        jy, jaux = _jax_moe(jcfg, rules_decode, jparams, x, chunk)
    monkeypatch.setattr(bm, "MOE_CHUNK", chunk)
    y, aux = bm.moe_apply(cfg, params, torch.from_numpy(x))
    _close(y, jy, "y")
    for key in AUX:
        _close(aux[key], jaux[key], key)
    assert float(aux["moe_dropped"]) == float(jaux["moe_dropped"])
    # these inputs overflow experts: the capacity rule is exercised
    assert float(aux["moe_dropped"]) > 0


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tie"])
def test_router_top_k_matches_jax(tie):
    cfg = get_smoke_config("olmoe-1b-7b")
    jparams, params = _moe_params(tie=tie)
    x = _x(1, 64, cfg.d_model, seed=12).reshape(64, cfg.d_model)
    logits, probs, gates, idx = bm.route(cfg, params, torch.from_numpy(x))
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jparams["moe.router"], axis=-1)
    jgates, jidx = jax.lax.top_k(jprobs, cfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(probs, jprobs, "probs")
    if tie:
        assert torch.equal(probs[:, 3], probs[:, 5])
        # the tie decides some token's last choice: 3 in, 5 out
        assert ((idx == 3).any(1) & ~(idx == 5).any(1)).any()
        assert not ((idx == 5).any(1) & ~(idx == 3).any(1)).any()


def test_gshard_weights_choices_by_the_kept_gate_sum(monkeypatch):
    """C17: GShard's y is gather's with every kept choice weighted by its
    token's kept gate sum instead of its own gate."""
    cfg = get_smoke_config("olmoe-1b-7b")
    _, params = _moe_params()
    xc = torch.from_numpy(_x(1, 21, cfg.d_model, seed=13)[0])
    capacity = max(int(cfg.moe.top_k * 21 * cfg.moe.capacity_factor
                       / cfg.moe.n_experts), 4)
    y_gshard, aux = bm._route_chunk(cfg, params, xc, capacity)
    assert float(aux["moe_dropped"]) > 0
    route = bm.route

    def summed(cfg_, params_, xc_):
        logits, probs, gates, idx = route(cfg_, params_, xc_)
        keep = bm.arrival_positions(idx, cfg_.moe.n_experts).reshape(
            idx.shape) < capacity
        return logits, probs, (gates * keep).sum(1, keepdim=True).expand(
            gates.shape), idx

    monkeypatch.setattr(bm, "route", summed)
    y_sum, _ = bm._route_chunk_gather(cfg, params, xc, capacity)
    _close(y_sum, y_gshard, "gshard vs gather with summed gates")
    monkeypatch.setattr(bm, "route", route)
    y_gather, _ = bm._route_chunk_gather(cfg, params, xc, capacity)
    assert float((y_gather - y_gshard).abs().max()) > 1e-3


def test_moe_gather_dispatch_matches_gshard():
    """``test_perf_paths.py``'s check on the port: bf16 inputs of scale
    0.3 (where both dispatches' outputs are within its loose tolerance
    despite C17), ``moe_dropped`` equal."""
    cfg = get_smoke_config("olmoe-1b-7b")
    params = common.init_params(0, bm.moe_table(cfg), device="cpu")
    x = torch.from_numpy(_x(2, 64, cfg.d_model, seed=1, scale=0.3)).to(
        torch.bfloat16)
    outs = {d: bm.moe_apply(_dispatch(cfg, d), params, x)
            for d in ("gshard", "gather")}
    np.testing.assert_allclose(_np(outs["gshard"][0]), _np(outs["gather"][0]),
                               atol=2e-3, rtol=2e-2)
    assert float(outs["gshard"][1]["moe_dropped"]) == float(
        outs["gather"][1]["moe_dropped"])


def test_moe_aux_terms_present():
    cfg = get_smoke_config("olmoe-1b-7b")
    _, params = _moe_params()
    _, aux = bm.moe_apply(cfg, params, torch.from_numpy(
        _x(2, 16, cfg.d_model, seed=2)))
    assert {"moe_aux", "moe_z", "moe_dropped"} <= set(aux)
    assert float(aux["moe_aux"]) >= 0.0 and float(aux["moe_z"]) >= 0.0


# ---------------------------------------------------------------- MLA

@functools.lru_cache(maxsize=None)
def _mla_params():
    jcfg = jget_smoke("deepseek-v2-lite-16b")
    params = jinit(jax.random.PRNGKey(3), jbm.mla_table(jcfg),
                   dtype=jnp.float32)
    return params, {k: torch.from_numpy(np.array(v))
                    for k, v in params.items()}


def test_mla_prefill_and_decode_match_jax(mesh11, rules_decode):
    jcfg = jget_smoke("deepseek-v2-lite-16b")
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    jparams, params = _mla_params()
    b, s, max_seq = 2, 21, 29
    x = _x(b, s + 1, cfg.d_model, seed=4)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))

    def jmla(mode, cache, x_, positions):
        return jax.jit(functools.partial(jbm.mla_apply, jcfg, rules_decode,
                                         mode=mode))(
            jparams, x_, cache=cache, positions=positions)

    with mesh11:
        jy, jcache = jmla("prefill", None, jnp.asarray(x[:, :s]),
                          jnp.asarray(pos))
    y, cache = bm.mla_apply(cfg, params, torch.from_numpy(x[:, :s]),
                            mode="prefill", cache=None,
                            positions=torch.from_numpy(pos.copy()))
    assert y.shape == (b, s, cfg.d_model)
    _close(y, jy, "prefill y")
    assert set(cache) == set(jcache) == {"c_kv", "k_pe"}
    for name in cache:
        _close(cache[name], jcache[name], f"prefill cache {name}")

    # decode from bf16 caches padded to max_seq (as served)
    full = bm.init_mla_cache(cfg, b, max_seq, torch.bfloat16,
                             torch.device(CPU))
    for name, big in full.items():
        big[:, :s] = cache[name]
    jfull = {k: jnp.asarray(_np(v)).astype(jnp.bfloat16)
             for k, v in full.items()}
    step_pos = np.full((b, 1), s, dtype=np.int32)
    with mesh11:
        jy2, jcache2 = jmla("decode", jfull, jnp.asarray(x[:, s:]),
                            jnp.asarray(step_pos))
    y2, cache2 = bm.mla_apply(cfg, params, torch.from_numpy(x[:, s:]),
                              mode="decode", cache=full,
                              positions=torch.from_numpy(step_pos),
                              index=s)
    _close(y2, jy2, "decode y")
    for name in cache2:
        assert cache2[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(cache2[name]), _np(jcache2[name]))


# ------------------------------------------------------------- models

MODEL_ARCHS = ("deepseek-v2-lite-16b", "olmoe-1b-7b")


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = jget_smoke(arch)
    params = jinit(jax.random.PRNGKey(0), japi.param_table(jcfg),
                   dtype=jnp.float32)
    model = convert.params_from_numpy(
        get_smoke_config(arch), {k: np.asarray(v) for k, v in params.items()},
        device=CPU, dtype=torch.float32)
    return jcfg, params, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_chunked_prefill_and_decode_match_jax(arch, monkeypatch, mesh11,
                                              rules_decode):
    """Two 16-token routing chunks in every MoE layer of the prefill;
    the decode step routes its 2 tokens as one chunk."""
    jcfg, jparams, model = _model(arch)
    cfg = get_smoke_config(arch)
    b, s, max_seq = 2, 16, 24
    toks = _tokens(cfg, b, s + 1, seed=8)
    monkeypatch.setattr(jbm, "MOE_CHUNK", 16)
    monkeypatch.setattr(bm, "MOE_CHUNK", 16)
    with mesh11:
        jlogits, jcaches = jax.jit(functools.partial(
            japi.prefill, jcfg, rules_decode))(
                jparams, {"tokens": jnp.asarray(toks[:, :s])})
    with torch.inference_mode():
        logits, caches = api.prefill(
            cfg, model, {"tokens": torch.from_numpy(toks[:, :s]).long()})
    _close(logits, jlogits, "prefill logits")
    assert set(caches) == set(jcaches)
    for key, layer in jcaches.items():
        assert set(caches[key]) == set(layer)
        for name, want in layer.items():
            _close(caches[key][name], want, f"prefill cache {key}.{name}")

    full = api.init_caches(cfg, b, max_seq, device=CPU)
    for key, layer in full.items():
        for name, big in layer.items():
            for slot in range(b):
                _write_slot(big, caches[key][name][slot:slot + 1], slot)
    jfull = {key: {name: jnp.asarray(_np(t)).astype(jnp.bfloat16)
                   for name, t in layer.items()}
             for key, layer in full.items()}
    step = toks[:, s:]
    with mesh11:
        jlogits2, _ = jax.jit(functools.partial(
            japi.decode_step, jcfg, rules_decode))(
                jparams, jfull, {"tokens": jnp.asarray(step),
                                 "index": jnp.int32(s)})
    with torch.inference_mode():
        logits2, _ = api.decode_step(
            cfg, model, full, {"tokens": torch.from_numpy(step).long(),
                               "index": s})
    _close(logits2, jlogits2, "decode logits")


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_decode_matches_full_forward(arch):
    """prefill(S) + decode(token S) == prefill(S+1) at the last position,
    bf16 weights from the port's own init; capacity_factor E / top_k
    gives every expert room for every token, so nothing is dropped."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = api.init_model(cfg, seed=0, device=CPU)
    b, s = 2, 32
    toks = torch.from_numpy(_tokens(cfg, b, s + 1, seed=5)).long()
    with torch.inference_mode():
        want, _ = api.prefill(cfg, model, {"tokens": toks})
        _, caches = api.prefill(cfg, model, {"tokens": toks[:, :s]})
        full = api.init_caches(cfg, b, s + 1, device=CPU)
        for key, layer in full.items():
            for name, big in layer.items():
                small = caches[key][name]
                big[tuple(slice(0, n) for n in small.shape)] = small
        got, _ = api.decode_step(cfg, model, full,
                                 {"tokens": toks[:, s:], "index": s})
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=3e-2, rtol=3e-2)

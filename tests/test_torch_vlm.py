"""The port's vlm front end (internvl2-76b smoke config: 8 patch
embeddings projected by ``patch_proj`` and prepended to the tokens)
against the JAX package's.

* Prefill with bf16 patch embeddings (cast to the f32 embedding dtype,
  as the reference casts them), then one decode step at index P + S,
  against JAX on JAX's float32 weights: logits rtol 1e-4 / atol 1e-5;
  the caches hold P + S positions.
* A prefill without ``patches`` raises ``KeyError`` in both packages.
* On the port alone: prefill(P patches + S tokens) + decode(token S at
  index P + S) == prefill(P + S + 1) at the last position, bf16
  weights, 3e-2 as the dense check.
* The f32-patch case against JAX is
  ``test_torch_models.py::test_prefill_and_decode_match_jax[internvl2]``;
  the serving engines' refusal (C15), ``test_torch_serve.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import api as japi
from repro.models.common import init_params as jinit
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import api
from torch_threads import one_thread  # noqa: F401


ARCH = "internvl2-76b"
CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jget_smoke(ARCH)
    params = jinit(jax.random.PRNGKey(4), japi.param_table(jcfg),
                   dtype=jnp.float32)
    model = convert.params_from_numpy(
        get_smoke_config(ARCH), {k: np.asarray(v) for k, v in params.items()},
        device=CPU, dtype=torch.float32)
    return jcfg, params, model


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    patches = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    return toks, torch.from_numpy(patches).to(torch.bfloat16)


def test_prefill_with_patches_and_decode_match_jax(mesh11, rules_decode):
    jcfg, jparams, model = _weights()
    cfg = get_smoke_config(ARCH)
    b, s = 2, 13
    p = cfg.n_patches
    toks, patches = _inputs(cfg, b, s, seed=1)
    jpatches = jnp.asarray(_np(patches)).astype(jnp.bfloat16)
    with mesh11:
        jlogits, jcaches = jax.jit(functools.partial(
            japi.prefill, jcfg, rules_decode))(
                jparams, {"tokens": jnp.asarray(toks[:, :s]),
                          "patches": jpatches})
    with torch.inference_mode():
        logits, caches = api.prefill(cfg, model, {
            "tokens": torch.from_numpy(toks[:, :s]).long(),
            "patches": patches})
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=1e-4,
                               atol=1e-5)
    for key, layer in jcaches.items():
        for name, want in layer.items():
            assert caches[key][name].shape == want.shape == (
                b, cfg.n_kv_heads, p + s, cfg.resolved_head_dim)
            np.testing.assert_allclose(_np(caches[key][name]), _np(want),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{key}.{name}")

    full = api.init_caches(cfg, b, p + s + 4, device=CPU)
    for key, layer in full.items():
        for name, big in layer.items():
            big[:, :, :p + s] = caches[key][name]
    jfull = {k: {n: jnp.asarray(_np(t)).astype(jnp.bfloat16)
                 for n, t in layer.items()} for k, layer in full.items()}
    with mesh11:
        jlogits2, _ = japi.decode_step(jcfg, rules_decode, jparams, jfull, {
            "tokens": jnp.asarray(toks[:, s:]), "index": jnp.int32(p + s)})
    with torch.inference_mode():
        logits2, _ = api.decode_step(cfg, model, full, {
            "tokens": torch.from_numpy(toks[:, s:]).long(), "index": p + s})
    np.testing.assert_allclose(_np(logits2), _np(jlogits2), rtol=1e-4,
                               atol=1e-5)


def test_prefill_without_patches_raises(mesh11, rules_decode):
    jcfg, jparams, model = _weights()
    cfg = get_smoke_config(ARCH)
    toks = np.zeros((1, 4), dtype=np.int32)
    with mesh11, pytest.raises(KeyError, match="patches"):
        japi.prefill(jcfg, rules_decode, jparams,
                     {"tokens": jnp.asarray(toks)})
    with pytest.raises(KeyError, match="patches"):
        api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()})


def test_decode_matches_full_forward():
    cfg = get_smoke_config(ARCH)
    model = api.init_model(cfg, seed=0, device=CPU)
    b, s = 2, 24
    p = cfg.n_patches
    toks, patches = _inputs(cfg, b, s, seed=2)
    toks = torch.from_numpy(toks).long()
    with torch.inference_mode():
        want, _ = api.prefill(cfg, model, {"tokens": toks,
                                           "patches": patches})
        _, caches = api.prefill(cfg, model, {"tokens": toks[:, :s],
                                             "patches": patches})
        full = api.init_caches(cfg, b, p + s + 1, device=CPU)
        for key, layer in full.items():
            for name, big in layer.items():
                big[:, :, :p + s] = caches[key][name]
        got, _ = api.decode_step(cfg, model, full,
                                 {"tokens": toks[:, s:], "index": p + s})
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=3e-2, rtol=3e-2)

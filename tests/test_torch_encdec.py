"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-small
smoke config) against the JAX package's ``repro.models.encdec``.

* ``sinusoid`` against JAX's over whisper's positions (0-1499) at d 64
  and 768: atol 2e-4 (no bitwise contract applies: a frequency's 1-ulp
  difference in ``exp`` (C3) grows with the position to 1.2e-4).
* ``encode`` on numpy frames, float32 weights from JAX's
  ``init_params`` carried across with ``convert``: rtol 1e-4 /
  atol 1e-5; the K4 wrapper's CPU path (``backend="cuda"`` on CPU
  tensors) gives the plain version's bits.
* C16: the serving engines keep each slot's cross K/V zero-padded to
  ``max_seq`` and decode attends over them unmasked, so the padded zero
  keys join the softmax.  A decode step from a padded cross cache: the
  port equals JAX, and differs from the same step over the unpadded
  cache.
* On the port alone: prefill(S tokens) + decode(token S) == prefill(S+1
  tokens) at the last position on the same frames (the cross cache as
  long as the frames), bf16 weights, 3e-2 as the dense check.
* The model-level prefill and decode against JAX is
  ``test_torch_models.py::test_prefill_and_decode_match_jax[whisper]``;
  the serving engine, ``test_torch_serve.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import api as japi
from repro.models import encdec as jed
from repro.models.common import init_params as jinit
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import api, encdec
from torch_threads import one_thread  # noqa: F401


ARCH = "whisper-small"
CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jget_smoke(ARCH)
    params = jinit(jax.random.PRNGKey(2), japi.param_table(jcfg),
                   dtype=jnp.float32)
    model = convert.params_from_numpy(
        get_smoke_config(ARCH), {k: np.asarray(v) for k, v in params.items()},
        device=CPU, dtype=torch.float32)
    return jcfg, params, model


def _frames(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


@pytest.mark.parametrize("d", [64, 768])
def test_sinusoid_matches_jax(d):
    pos = np.arange(1500)
    got = encdec.sinusoid(torch.from_numpy(pos), d)
    want = jed.sinusoid(jnp.asarray(pos), d)
    assert got.shape == (1500, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


def test_encode_matches_jax(mesh11, rules_decode):
    jcfg, jparams, model = _weights()
    cfg = get_smoke_config(ARCH)
    frames = _frames(2, 19, cfg.d_model)
    with mesh11:
        want = jax.jit(functools.partial(jed.encode, jcfg, rules_decode))(
            jparams, jnp.asarray(frames))
    t = torch.from_numpy(frames)
    got = encdec.encode(cfg, model, t, backend="reference")
    assert got.shape == (2, 19, cfg.d_model)
    _close(got, want, "encoder output")
    # the K4 wrapper on CPU tensors runs the plain version
    assert torch.equal(encdec.encode(cfg, model, t, backend="cuda"), got)


def test_decode_attends_over_padded_cross_cache(mesh11, rules_decode):
    """C16: a slot's cross K/V padded with zeros from its prompt length
    to ``max_seq`` take part in decode's softmax, in both packages."""
    jcfg, jparams, model = _weights()
    cfg = get_smoke_config(ARCH)
    b, s, max_seq = 1, 9, 24
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int64)
    frames = _frames(b, s, cfg.d_model, seed=4)
    with torch.inference_mode():
        _, caches = api.prefill(cfg, model, {
            "tokens": torch.from_numpy(toks[:, :s]),
            "frames": torch.from_numpy(frames)})

    def decode(pad_cross):
        full = api.init_caches(cfg, b, max_seq, device=CPU)
        for key, layer in full.items():
            for name, small in caches[key].items():
                if name.startswith("cross") and not pad_cross:
                    layer[name] = small.to(torch.bfloat16)
                else:
                    layer[name][:, :, :s] = small
        step = {"tokens": torch.from_numpy(toks[:, s:]), "index": s}
        with torch.inference_mode():
            return api.decode_step(cfg, model, full, step)[0], full

    padded, full = decode(pad_cross=True)
    exact, _ = decode(pad_cross=False)
    jfull = {k: {n: jnp.asarray(_np(t)).astype(jnp.bfloat16)
                 for n, t in layer.items()} for k, layer in full.items()}
    with mesh11:
        jpadded, _ = jed.decode_step(jcfg, rules_decode, jparams, jfull, {
            "tokens": jnp.asarray(toks[:, s:]), "index": jnp.int32(s)})
    _close(padded, jpadded, "padded cross cache")
    # the padding moves the logits by 0.65% of their largest
    scale = float(exact.abs().max())
    assert float((padded - exact).abs().max()) > 1e-3 * scale


def test_decode_matches_full_forward():
    """prefill(S) + decode(token S) == prefill(S+1) at the last position,
    on the same frames, bf16 weights from the port's own init."""
    cfg = get_smoke_config(ARCH)
    model = api.init_model(cfg, seed=0, device=CPU)
    b, s = 2, 32
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, s + 1))).long()
    frames = torch.from_numpy(_frames(b, 20, cfg.d_model, seed=6)).to(
        torch.bfloat16)
    with torch.inference_mode():
        want, _ = api.prefill(cfg, model, {"tokens": toks, "frames": frames})
        _, caches = api.prefill(cfg, model, {"tokens": toks[:, :s],
                                             "frames": frames})
        full = api.init_caches(cfg, b, s + 1, device=CPU)
        for key, layer in full.items():
            layer["cross_k"] = caches[key]["cross_k"]
            layer["cross_v"] = caches[key]["cross_v"]
            for name in ("self_k", "self_v"):
                layer[name][:, :, :s] = caches[key][name]
        got, _ = api.decode_step(cfg, model, full,
                                 {"tokens": toks[:, s:], "index": s})
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=3e-2, rtol=3e-2)

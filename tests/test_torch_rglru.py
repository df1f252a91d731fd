"""The port's RG-LRU recurrence (``repro_torch.models.blocks_rnn``) and K2's
wrapper (``repro_torch.kernels.rglru``) against the JAX package's.

* ``rglru_scan`` (K2's plain version) vs JAX's ``rglru_scan``, from a
  zero and from a nonzero h0, at the shapes of
  ``tests/test_kernels_recurrent.py``, at S not a multiple of any block
  (and of JAX's scan chunk, where it takes its unchunked branch), and at
  a ragged width.  Both return ``(h_final, h_all)``.
* The K2 wrapper on CPU tensors (its plain version) vs JAX's Pallas
  ``ops.rglru`` in interpret mode, which returns ``(h_all, h_final)``,
  as the wrapper does.  The Pallas wrapper asserts S % block_t == 0 and
  W % block_w == 0; the port's wrapper takes any S and W (checked against
  ``rglru_scan`` above).
* Tolerance of the scan against JAX: atol = rtol = 1e-5, that of
  ``tests/test_kernels_recurrent.py`` (XLA may contract a * h + x into
  one FMA where torch rounds twice, compounded over S steps).
* ``rglru_gated_scan`` (the plain version of K2's gated entry: the
  RG-LRU between its matrix products) against the layer's arithmetic as
  it stood inline in ``rglru_apply`` before the kernel took it over
  (kept below as ``_inline_layer``): bitwise, float32 and bfloat16, S of
  1 (a decode step from the cache's h), 21 and 200, ragged W, zero and
  nonzero h0, and extreme inputs: gate pre-activations of +-30 (sigmoid
  exactly 1 and ~1e-13) and of -87.5 and -100 (1 + exp(-x) past 2^126 or
  infinite), lambda of 20.5 and 25 (a exactly 0) and of -20 and -30 (a
  rounds to 1, 1 - a^2 to 0, the 1e-12 clamp decides).
* K2's gated wrapper on CPU tensors is that plain version (no launch),
  h_final written in place when asked, as decode asks.
* ``rglru_apply`` (prefill of 21 tokens, then one decode step from its
  cache) against JAX's on shared weights at recurrentgemma's smoke
  width.  Tolerance: float32 rtol 1e-4 / atol 1e-5 (those of
  ``tests/test_torch_models.py``: XLA and torch sum the matrix products
  in different orders); bfloat16 one bf16 ulp, rtol 2^-7 with atol 1e-2
  of the values' scale (an f32 value near a bf16 rounding tie can round
  either way in the two, and the gates' sigmoids are rounded to bf16).
* ``plan``, the wrapper's choice of the kernel's load path: TMA where
  every (B, S, W) array's rows start 16-byte aligned, else one element a
  thread.
* K2 itself on the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops
from repro.models import blocks_rnn as jrnn
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import rglru as rg
from repro_torch.models import blocks_rnn as trnn
from torch_threads import one_thread  # noqa: F401


TOL = 1e-5


def _inputs(b, s, w, seed, h0_scale):
    """a = sigmoid(N(0, 1)) in (0, 1); x ~ N(0, 1); h0 = h0_scale N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))).astype(
        np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = (h0_scale * rng.standard_normal((b, w))).astype(np.float32)
    return a, x, h0


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


SHAPES = [(1, 32, 16), (2, 128, 64), (2, 256, 256), (4, 64, 128),
          (2, 200, 64),        # S not a multiple of 128 or of any block
          (1, 37, 24),         # ragged S and W
          (3, 300, 40)]        # S past JAX's scan chunk, not a multiple


@pytest.mark.parametrize("h0_scale", [0.0, 5.0], ids=["zero", "h0"])
@pytest.mark.parametrize("b,s,w", SHAPES)
def test_rglru_scan_matches_jax(b, s, w, h0_scale):
    a, x, h0 = _inputs(b, s, w, seed=s + w, h0_scale=h0_scale)
    j_final, j_all = jrnn.rglru_scan(*(jnp.asarray(t) for t in (a, x, h0)))
    t_final, t_all = trnn.rglru_scan(*(torch.from_numpy(t)
                                       for t in (a, x, h0)))
    assert t_all.shape == (b, s, w) and t_final.shape == (b, w)
    assert t_all.dtype == torch.float32
    _close(t_all, j_all)
    _close(t_final, j_final)


@pytest.mark.parametrize("h0_scale", [0.0, 5.0], ids=["zero", "h0"])
@pytest.mark.parametrize("b,s,w,block_t,block_w", [
    (1, 32, 16, 16, 16), (2, 128, 64, 64, 64), (2, 256, 256, 16, 16),
    (4, 64, 128, 64, 64), (2, 64, 32, 16, 16)])
def test_rglru_wrapper_matches_pallas(b, s, w, block_t, block_w, h0_scale):
    a, x, h0 = _inputs(b, s, w, seed=b * s + w, h0_scale=h0_scale)
    j_all, j_final = ops.rglru(*(jnp.asarray(t) for t in (a, x, h0)),
                               block_t=block_t, block_w=block_w)
    launches = rg.LAUNCHES
    t_all, t_final = rg.rglru(*(torch.from_numpy(t) for t in (a, x, h0)))
    assert rg.LAUNCHES == launches          # CPU tensors: the plain version
    _close(t_all, j_all)
    _close(t_final, j_final)


def test_rglru_wrapper_takes_ragged_shapes():
    """What the Pallas wrapper refuses (S % block_t, W % block_w), the
    port's takes: the CPU path is ``rglru_scan`` in the Pallas order."""
    a, x, h0 = _inputs(2, 37, 24, seed=3, h0_scale=1.0)
    t_all, t_final = rg.rglru(*(torch.from_numpy(t) for t in (a, x, h0)))
    s_final, s_all = trnn.rglru_scan(*(torch.from_numpy(t)
                                       for t in (a, x, h0)))
    assert torch.equal(t_all, s_all) and torch.equal(t_final, s_final)
    with pytest.raises(AssertionError):
        ops.rglru(*(jnp.asarray(t) for t in (a, x, h0)), block_t=16,
                  block_w=16)


# ------------------------------------------------- the gated entry's layer

def _inline_layer(gr, gi, u, branch, rgate_bias, igate_bias, lam, h0):
    """The RG-LRU between its matrix products as ``rglru_apply`` computed
    it inline before the kernel took it over (prefill: the scan from h0;
    decode, S = 1: one step from the cache's h)."""
    r = torch.sigmoid(gr + rgate_bias).float()
    i = torch.sigmoid(gi + igate_bias).float()
    log_a = -8.0 * F.softplus(lam.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * i * u.float()
    if a.shape[1] == 1:
        h_final = a[:, 0] * h0 + gated[:, 0]
        h = h_final[:, None]
    else:
        h_final, h = trnn.rglru_scan(a, gated, h0)
    return branch * h.to(branch.dtype), h_final


def _gated_inputs(b, s, w, dtype, seed, h0_scale, extreme):
    """Gate products, u, branch, biases and lambda (normal, spread so
    the sigmoids and a cover (0, 1)), and h0 = h0_scale N(0, 1)."""
    rng = np.random.default_rng(seed)
    gr, gi = (2.0 * rng.standard_normal((b, s, w)) for _ in range(2))
    u, br = (rng.standard_normal((b, s, w)) for _ in range(2))
    rb, ib = rng.standard_normal(w), rng.standard_normal(w)
    lam = 3.0 * rng.standard_normal(w)
    if extreme:
        gr[..., 0::7], gr[..., 1::7], gr[..., 4::7] = 30.0, -30.0, -87.5
        gi[..., 2::7], gi[..., 3::7], gi[..., 5::7] = 30.0, -30.0, -100.0
        rb[0::7] = ib[2::7] = 0.0
        lam[0::5], lam[1::5], lam[2::5], lam[3::5] = 20.5, -20.0, -30.0, 25.0
    ts = [torch.from_numpy(v.astype(np.float32)).to(dtype)
          for v in (gr, gi, u, br, rb, ib, lam)]
    h0 = torch.from_numpy((h0_scale * rng.standard_normal((b, w))).astype(
        np.float32))
    return ts, h0


@pytest.mark.parametrize("extreme", [False, True], ids=["normal", "extreme"])
@pytest.mark.parametrize("h0_scale", [0.0, 5.0], ids=["zero", "h0"])
@pytest.mark.parametrize("b,s,w", [(2, 1, 24), (2, 21, 37), (1, 200, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rglru_gated_scan_matches_the_inline_layer(dtype, b, s, w, h0_scale,
                                                   extreme):
    args, h0 = _gated_inputs(b, s, w, dtype, seed=b + s + w,
                             h0_scale=h0_scale, extreme=extreme)
    y, h_final = trnn.rglru_gated_scan(*args, h0)
    want_y, want_h = _inline_layer(*args, h0)
    assert y.dtype == dtype and y.shape == (b, s, w)
    assert h_final.dtype == torch.float32 and h_final.shape == (b, w)
    assert torch.equal(y, want_y) and torch.equal(h_final, want_h)
    if h0_scale == 0.0:                     # None: the scan from zeros
        y0, h0_final = trnn.rglru_gated_scan(*args)
        assert torch.equal(y0, want_y) and torch.equal(h0_final, want_h)
    if extreme:                             # the edges were reached
        lam_sp = F.softplus(args[6].float())
        assert (torch.exp(-8.0 * lam_sp) == 0).any()
        assert (torch.exp(-8.0 * lam_sp) == 1).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rglru_gated_wrapper_on_cpu_is_the_plain_version(dtype):
    args, h0 = _gated_inputs(2, 1, 24, dtype, seed=5, h0_scale=5.0,
                             extreme=True)
    want_y, want_h = trnn.rglru_gated_scan(*args, h0)
    launches = rg.LAUNCHES
    y, h = rg.rglru_gated(*args)             # prefill: h0 zeros
    assert rg.LAUNCHES == launches
    assert torch.equal(h, trnn.rglru_gated_scan(*args)[1])
    cache_h = h0.clone()
    y, h = rg.rglru_gated(*args, cache_h, h_final=cache_h)   # decode
    assert rg.LAUNCHES == launches
    assert h is cache_h
    assert torch.equal(y, want_y) and torch.equal(cache_h, want_h)


def _layer_weights(seed):
    """The RG-LRU block's weights, normal and scaled so that the gates
    spread over (0, 1), as numpy float32 arrays by the table's names."""
    rng = np.random.default_rng(seed)
    table = jrnn.rglru_table(jget_smoke("recurrentgemma-2b"))
    out = {}
    for name, (shape, _) in table.items():
        fan_in = shape[0] if len(shape) == 2 else 1
        scale = 1.0 / np.sqrt(fan_in) if len(shape) == 2 else 1.0
        if name == "rg.lambda":
            scale = 2.0
        if name == "rg.conv_w":
            scale = 0.5
        out[name] = (scale * rng.standard_normal(shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rglru_apply_matches_jax(dtype, mesh11, rules_decode):
    jcfg = jget_smoke("recurrentgemma-2b")
    cfg = get_smoke_config("recurrentgemma-2b")
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    weights = _layer_weights(seed=11)
    params = {k: torch.from_numpy(v).to(dtype) for k, v in weights.items()}
    jparams = {k: jnp.asarray(v.float().numpy()).astype(jdt)
               for k, v in params.items()}
    b, s = 2, 21
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal(
        (b, s + 1, cfg.d_model)).astype(np.float32)).to(dtype)
    jx = jnp.asarray(x.float().numpy()).astype(jdt)
    close = (_close_to if dtype == torch.float32 else _close_bf16)

    with mesh11:
        jy, jcache = jrnn.rglru_apply(jcfg, rules_decode, jparams,
                                      jx[:, :s], mode="prefill", cache=None)
    with torch.inference_mode():
        y, cache = trnn.rglru_apply(cfg, params, x[:, :s], mode="prefill",
                                    cache=None)
    close(y, jy, "prefill y")
    close(cache["conv"], jcache["conv"], "prefill conv state")
    close(cache["h"], jcache["h"], "prefill h")

    # one decode step from the port's own cache, handed to both
    jstart = {k: jnp.asarray(v.float().numpy()).astype(jcache[k].dtype)
              for k, v in cache.items()}
    with mesh11:
        jy2, jcache2 = jrnn.rglru_apply(jcfg, rules_decode, jparams,
                                        jx[:, s:], mode="decode",
                                        cache=jstart)
    cache = {k: v.clone() for k, v in cache.items()}
    h_before = cache["h"]
    with torch.inference_mode():
        y2, cache2 = trnn.rglru_apply(cfg, params, x[:, s:], mode="decode",
                                      cache=cache)
    assert cache2["h"] is h_before           # updated in place
    close(y2, jy2, "decode y")
    close(cache2["conv"], jcache2["conv"], "decode conv state")
    close(cache2["h"], jcache2["h"], "decode h")


def _close_to(got, want, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-4, atol=1e-5, err_msg=what)


def _close_bf16(got, want, what):
    want = np.asarray(want.astype(jnp.float32))
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-2 * scale, err_msg=what)


@pytest.mark.parametrize("width,itemsize,ptrs,tma", [
    (2560, 2, [0, 5120 * 64, 1 << 20], True),   # recurrentgemma-2b, bf16
    (2560, 4, [0, 256], True),                  # rglru_fwd, f32
    (24, 4, [16, 32, 48], True),                # 96-byte rows
    (8, 2, [0], True),                          # one 16-byte row
    (100, 2, [0], False),                       # 200-byte rows
    (37, 4, [0], False),                        # ragged W
    (1, 4, [0], False),
    (2560, 2, [0, 2], False),                   # a view one element in
    (2560, 4, [8, 0], False),
])
def test_plan_takes_tma_only_on_aligned_rows(width, itemsize, ptrs, tma):
    assert rg.plan(width, itemsize, ptrs) is tma


def test_plan_on_tensors():
    """The wrapper's decision on real buffers: fresh tensors are aligned;
    a view that starts one element in is not."""
    base = torch.zeros((1, 4, 2561), dtype=torch.bfloat16)
    view = base[..., 1:]
    fresh = torch.zeros((1, 4, 2560), dtype=torch.bfloat16)
    assert rg.plan(2560, 2, [fresh.data_ptr()]) is True
    assert rg.plan(2560, 2, [view.contiguous().data_ptr()]) is True
    assert rg.plan(2560, 2, [base.data_ptr() + 2]) is False

"""The port's optimizer, compression and train step against the JAX
package's (``repro.train``).

* ``lr_at`` over steps 0..total_steps: rtol 1e-6 (the reference's f32
  ``cos`` may differ from torch's by an ulp, C3).
* ``global_norm`` and ``clip_by_global_norm``: rtol 1e-6 and 2e-6 (sums
  in other orders).
* ``adamw_update`` on shared float32 and bfloat16 parameters and float32
  gradients (spread over nine decades, five steps, no clipping so the
  norm's order of summation does not enter): ``count`` and ``lr``
  equal; parameters, ``mu`` and ``nu`` within rtol 1e-5 / atol 1e-6.
  They part at the last bits for named reasons, XLA's rewrites on the
  CPU: ``b1 * mu + (1 - b1) * g``, ``upd + wd * p`` and
  ``p - lr * upd`` become fused multiply-adds, and ``(mu / c1) / d``
  becomes ``mu / (c1 * d)``; torch rounds each operation as written
  (and its vectorized f32 sqrt on the CPU is off by an ulp in ~0.6% of
  inputs, where XLA's is correctly rounded).
  The test holds JAX's ``mu`` (every step) and first-step parameters
  bitwise to those rewritten forms and the port's bitwise to the
  written ones, and prints the share of bitwise-equal elements and the
  largest difference in ulp (PERF.md §6).  With clipping on, the
  clipping scale parts at an ulp (the norm's sums run in other orders)
  and AdamW's first steps magnify that where |g| is near eps: the
  parameters are held within the same limits where |g| >= 1e-5, and
  within twice the summed learning rates elsewhere.
* ``_NO_DECAY_SUFFIXES`` equal.
* ``quantize``/``dequantize``/``compress_with_feedback``: bitwise JAX's
  at sizes 1, 255, 256, 257, 1000 and 4096 with all-zero blocks and one
  huge element; ``compression_err`` rtol 1e-6.
* Ports of ``tests/test_train.py``'s optimizer and compression tests;
  the update made in slices of 97 elements (``OPT_CHUNK``) is bitwise
  the whole update.
* ``make_train_step`` three steps from JAX's float32 weights (accum 1,
  accum 2, and accum 1 with compression) against the reference's jitted
  ``make_train_step``: loss, xent, lr and grad norm within rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import api as japi
from repro.models.common import init_params as jinit
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import get_smoke_config
from repro_torch.train import compression, optimizer, train_step

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work here is many small ops: one intra-op thread
    keeps them fast while pytest-xdist runs several workers on the
    host's cores (the thread count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(a, b):
    return np.abs(_np(a).view(np.int32).astype(np.int64)
                  - _np(b).view(np.int32).astype(np.int64))


def test_lr_schedule_matches_jax():
    for cfg in (dict(peak_lr=1e-3, warmup_steps=10, total_steps=100),
                dict(peak_lr=3e-3, warmup_steps=0, total_steps=7,
                     end_lr_frac=0.0),
                dict(peak_lr=2e-2, warmup_steps=5, total_steps=5)):
        jc, tc = jopt.OptimizerConfig(**cfg), optimizer.OptimizerConfig(**cfg)
        for s in range(cfg["total_steps"] + 1):
            step = torch.tensor(s, dtype=torch.int32)
            got = float(optimizer.lr_at(tc, step))
            want = float(jopt.lr_at(jc, jnp.int32(s)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=f"{cfg} step {s}")


def test_no_decay_suffixes_match():
    assert optimizer._NO_DECAY_SUFFIXES == jopt._NO_DECAY_SUFFIXES


SHAPES = {"a.w": (64, 128), "b.bias": (128,), "c.norm.scale": (64,),
          "d.tm.mu_x": (32,), "e.w": (3, 32, 16)}


def _grads(rng):
    return {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-9, 0, s)
                ).astype(np.float32) for k, s in SHAPES.items()}


def test_global_norm_matches_jax():
    g = _grads(np.random.default_rng(0))
    got = float(optimizer.global_norm({k: torch.from_numpy(v)
                                       for k, v in g.items()}))
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clip_by_global_norm_matches_jax():
    g = _grads(np.random.default_rng(6))
    got, gn = optimizer.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    want, wn = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=2e-6,
                                   atol=0)


@pytest.mark.parametrize("clip", [1e9, 1.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_adamw_update_matches_jax(dt, clip):
    rng = np.random.default_rng(1)
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip)
    jc, tc = jopt.OptimizerConfig(**kw), optimizer.OptimizerConfig(**kw)
    jp = {k: jnp.asarray(0.05 * rng.standard_normal(s), jnp.float32
                         ).astype(jdt) for k, s in SHAPES.items()}
    tp = {k: torch.from_numpy(_np(v)).to(dt) for k, v in jp.items()}
    jo, to = jopt.init_opt_state(jp), optimizer.init_opt_state(tp)
    update = jax.jit(lambda p, g, o: jopt.adamw_update(jc, p, g, o))
    lr_sum = 0.0
    for step in range(5):
        g = _grads(rng)
        mu0 = {k: v.clone() for k, v in to.mu.items()}
        jmu0 = {k: np.asarray(v) for k, v in jo.mu.items()}
        p0 = {k: _np(v).copy() for k, v in tp.items()}
        jp, jo, jm = update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jo)
        tp, to, tm = optimizer.adamw_update(
            tc, tp, {k: torch.from_numpy(v) for k, v in g.items()}, to)
        assert int(to.count) == int(jo.count) == step + 1
        assert float(tm["lr"]) == float(jm["lr"])
        lr_sum += float(tm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for what, a, b in (("params", tp, jp), ("mu", to.mu, jo.mu),
                           ("nu", to.nu, jo.nu)):
            n = sum(v.numel() for v in a.values())
            same = sum(int((_ulps(a[k], b[k]) == 0).sum()) for k in a)
            worst = max(int(_ulps(a[k], b[k]).max()) for k in a)
            print(f"{dt} clip {clip} step {step} {what}: {same}/{n} "
                  f"bitwise, largest difference {worst} ulp")
            for k in a:
                x, y = _np(a[k]), _np(b[k])
                if what == "params" and clip != 1e9:
                    # the clipping scale parts at an ulp (the norm's sums
                    # run in other orders), and AdamW's g / (|g| + eps)
                    # magnifies that where |g| is near eps: compare where
                    # |g| >= 1e-5; elsewhere a step moves p by <= lr
                    assert np.abs(x - y).max() <= 2 * lr_sum, k
                    firm = np.abs(g[k]) >= 1e-5
                    x, y = x[firm], y[firm]
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{what} {k}")
        if clip == 1e9 and step == 0 and dt == torch.float32:
            _first_update_traced(tc, p0, to, jp, tp, float(tm["lr"]))
        if clip == 1e9 and step > 0:
            # where they part: XLA fuses b1 * mu + (1 - b1) * g
            # (each package's from its own previous mu)
            for k, gk in g.items():
                t = (np.float32(1 - tc.b1) * gk).astype(np.float64)
                fused = (np.float64(np.float32(tc.b1))
                         * jmu0[k].astype(np.float64) + t).astype(np.float32)
                plain = (np.float32(tc.b1) * mu0[k].numpy()
                         + np.float32(1 - tc.b1) * gk).astype(np.float32)
                assert not _ulps(fused, jo.mu[k]).any(), k
                assert not _ulps(plain, to.mu[k]).any(), k


def _first_update_traced(cfg, p0, opt, jp, tp, lr):
    """The first step's parameters, from moments both packages hold
    bitwise: the port's are the update as written, evaluated op by op in
    f32 (with torch's CPU sqrt); JAX's are the same with XLA's rewrites,
    ``(mu / c1) / d`` into ``mu / (c1 * d)`` and ``upd + wd * p``,
    ``p - lr * upd`` into fused multiply-adds, and a correctly rounded
    sqrt."""
    f32, f64 = np.float32, np.float64
    c1, c2 = f32(1 - f32(cfg.b1)), f32(1 - f32(cfg.b2))
    lr, wd, eps = f32(lr), f32(cfg.weight_decay), f32(cfg.eps)
    for k, p in p0.items():
        mu, nu = opt.mu[k].numpy(), opt.nu[k].numpy()
        den = (np.sqrt(nu / c2) + eps).astype(f32)
        # torch's vectorized f32 sqrt on the CPU is not correctly rounded
        # in ~0.6% of inputs (core/prng.py::sqrt_f32); on the card it is
        t_den = (torch.sqrt(torch.from_numpy(nu / c2)).numpy() + eps)
        plain = (mu / c1 / t_den).astype(f32)
        fused = (mu / (c1 * den).astype(f32)).astype(f32)
        if optimizer._decays(k):
            plain = (plain + wd * p).astype(f32)
            fused = (f64(fused) + f64(wd) * f64(p)).astype(f32)
        plain = (p - lr * plain).astype(f32)
        fused = (f64(p) - f64(lr) * f64(fused)).astype(f32)
        assert not _ulps(plain, tp[k]).any(), k
        assert not _ulps(fused, jp[k]).any(), k


def test_adamw_moves_params_against_gradient():
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.ones((4, 4))}
    opt = optimizer.init_opt_state(params)
    cfg = optimizer.OptimizerConfig(peak_lr=0.1, warmup_steps=0,
                                    total_steps=10, weight_decay=0.0)
    new_params, opt, metrics = optimizer.adamw_update(cfg, params, grads, opt)
    assert float(new_params["w"][0, 0]) < 1.0
    assert float(metrics["grad_norm"]) > 0


def test_lr_schedule_shape():
    cfg = optimizer.OptimizerConfig(peak_lr=1e-3, warmup_steps=10,
                                    total_steps=100, end_lr_frac=0.1)
    lrs = [float(optimizer.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1e-3) < 1e-9          # peak at end of warmup
    assert lrs[-1] <= lrs[1]
    assert abs(lrs[-1] - 1e-4) < 1e-6          # decays to 10% of peak


# ---------------------------------------------------------- compression

def _compress_cases():
    rng = np.random.default_rng(2)
    for n in (1, 255, 256, 257, 1000, 4096):
        x = (3.0 * rng.standard_normal(n)).astype(np.float32)
        if n >= 512:
            x[256:512] = 0.0                      # an all-zero block
            x[-1] = 3e37                          # one huge element
        yield n, x


def test_quantize_dequantize_bitwise_jax():
    for n, x in _compress_cases():
        jc = jcomp.quantize(jnp.asarray(x))
        tc = compression.quantize(torch.from_numpy(x))
        assert tc.q.dtype == torch.int8
        assert np.array_equal(tc.q.numpy(), np.asarray(jc.q)), n
        assert np.array_equal(_ulps(tc.scale, jc.scale), 0 * _np(jc.scale))
        shape = (n,) if n % 8 else (8, n // 8)
        got = compression.dequantize(tc, shape)
        want = jcomp.dequantize(jc, shape)
        assert got.shape == shape
        assert np.array_equal(_ulps(got, want), 0 * _np(want)), n


def test_compress_with_feedback_bitwise_jax():
    rng = np.random.default_rng(3)
    grads = {f"g{n}": x.reshape(-1) for n, x in _compress_cases()}
    errs = {k: (1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in grads.items()}
    jo, je, jerr = jcomp.compress_with_feedback(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in errs.items()})
    to, te, terr = compression.compress_with_feedback(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in errs.items()})
    for k in grads:
        assert np.array_equal(_ulps(to[k], jo[k]), 0 * _np(jo[k])), k
        assert np.array_equal(_ulps(te[k], je[k]), 0 * _np(je[k])), k
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-6)


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32) * 3.0)
    c = compression.quantize(x)
    y = compression.dequantize(c, x.shape)
    err = (x - y).abs().numpy()
    scale = float(c.scale.max())
    assert err.max() <= scale * 0.5 + 1e-6   # half-ULP of int8 grid


def test_error_feedback_accumulates_dropped_signal():
    """With EF, the quantization error is carried, not lost: summing
    many tiny identical gradients eventually transmits them."""
    g = {"w": torch.full((compression.BLOCK,), 1e-6)}
    big = {"w": torch.full((compression.BLOCK,), 1.0)}
    err = compression.init_error_buffers(g)
    sent = torch.zeros_like(g["w"])
    for _ in range(10):
        # a large component keeps the block scale coarse
        grads = {"w": g["w"] + big["w"]}
        out, err, _ = compression.compress_with_feedback(grads, err)
        sent = sent + out["w"] - big["w"]
    # 10 steps of 1e-6 -> ~1e-5 transmitted despite coarse quantization
    assert float(sent.mean()) > 5e-6


# -------------------------------------------- the step against JAX's

@pytest.mark.parametrize("accum,compress", [(1, False), (2, False),
                                            (1, True)],
                         ids=["accum1", "accum2", "compress"])
def test_three_steps_match_jax(accum, compress, rules_train, mesh11):
    jcfg, cfg = jget_smoke("llama3.2-1b"), get_smoke_config("llama3.2-1b")
    kw = dict(peak_lr=3e-3, warmup_steps=1, total_steps=8)
    jp = jinit(jax.random.PRNGKey(0), japi.param_table(jcfg),
               dtype=jnp.float32)
    js = jts.TrainState(jp, jopt.init_opt_state(jp),
                        jcomp.init_error_buffers(jp) if compress else None)
    jstep = jax.jit(jts.make_train_step(jcfg, rules_train,
                                        jopt.OptimizerConfig(**kw),
                                        compress=compress,
                                        accum_steps=accum))
    state = train_step.init_train_state(0, cfg, compress=compress,
                                        dtype=torch.float32, device=CPU)
    step = train_step.make_train_step(cfg, optimizer.OptimizerConfig(**kw),
                                      compress=compress, accum_steps=accum,
                                      device=CPU)
    data = JSyntheticLM(JDataConfig(cfg.vocab_size, 32, 4, seed=1))
    for i in range(3):
        batch = data.batch(i)
        with mesh11:
            js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        assert sorted(m) == sorted(jm)
        for k in ("loss", "xent", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")


def test_update_in_slices_is_bitwise_the_whole_update(monkeypatch):
    """``OPT_CHUNK`` bounds the update's temporaries; every operation is
    elementwise, so slicing changes no bit."""
    rng = np.random.default_rng(4)
    cfg = optimizer.OptimizerConfig(peak_lr=1e-2, warmup_steps=1,
                                    total_steps=5)
    outs = []
    for chunk in (optimizer.OPT_CHUNK, 97):
        monkeypatch.setattr(optimizer, "OPT_CHUNK", chunk)
        params = {k: torch.from_numpy(
            (0.05 * np.random.default_rng(5).standard_normal(s)
             ).astype(np.float32)).to(torch.bfloat16)
            for k, s in SHAPES.items()}
        opt = optimizer.init_opt_state(params)
        for step in range(3):
            g = _grads(np.random.default_rng(10 + step))
            params, opt, _ = optimizer.adamw_update(
                cfg, params, {k: torch.from_numpy(v) for k, v in g.items()},
                opt)
        outs.append((params, opt))
    (p0, o0), (p1, o1) = outs
    for k in p0:
        assert torch.equal(p0[k], p1[k])
        assert torch.equal(o0.mu[k], o1.mu[k])
        assert torch.equal(o0.nu[k], o1.nu[k])

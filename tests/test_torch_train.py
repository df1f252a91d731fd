"""The port's training losses and gradients against the JAX package's.

* ``common.chunked_softmax_xent``: value and gradients with respect to x
  and the unembedding against ``jax.value_and_grad`` (rtol 1e-5 on the
  value; gradients within 1e-5 of their tensor's max |g|), at S a
  multiple of the chunk, S with a remainder, and an all-zero mask (the
  denominator's ``max(., 1)``: loss 0, gradients 0).
* ``api.train_loss`` for all ten architectures at smoke size on JAX's
  float32 weights: the loss and every metric (``xent``, ``moe_aux``,
  ``moe_z``, ``moe_dropped``, ``loss``) within rtol 1e-5, every
  parameter's gradient within 1e-4 of its tensor's max |g| (the
  reference's ``value_and_grad``, jitted).  No input parts them: the
  largest differences (recorded in PERF.md) are ~1e-7 on the loss and
  ~2e-6 of max |g|, the sums of XLA and torch running in other orders.
  S = 40 with ``logit_chunk`` 32 and ``q_block`` 16: a logits remainder
  and three query blocks.
* Remat (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)
  on and off give bitwise the same loss and gradients, and so do a model
  (per-layer parameters) and its flat dict (stacked tensors).
* Ports of ``tests/test_models_smoke.py``'s
  ``test_train_step_runs_and_is_finite`` (every architecture, bf16
  weights from the port's init: the reference's) and
  ``test_moe_aux_losses_present``, and of ``tests/test_train.py``'s
  training tests (accumulation equivalence, a short run's falling loss,
  compressed training).
* Serving is unchanged by trainable parameters: ``api.prefill`` and
  ``decode_step`` build no autograd graph and give the same bits with
  ``requires_grad`` on and off, and the kernel wrappers (K2's two
  entries, K3, K4) refuse an input that requires a gradient under grad
  mode, before any launch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import api as japi
from repro.models.common import chunked_softmax_xent as jxent
from repro.models.common import init_params as jinit
from repro_torch import convert
from repro_torch.configs import ARCH_ORDER, get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import api, common
from repro_torch.train import (OptimizerConfig, init_train_state,
                               make_train_step)
from torch_threads import one_thread  # noqa: F401

B, S = 2, 40
CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_to_scale(got, want, tol, what):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(_np(got) - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of max |g| (limit {tol})"


# ------------------------------------------------------------- the loss

@pytest.mark.parametrize("s,zero_mask", [(64, False), (45, False),
                                         (45, True)],
                         ids=["chunks", "remainder", "zero-mask"])
def test_chunked_softmax_xent_matches_jax(s, zero_mask):
    rng = np.random.default_rng(s)
    b, d, v, chunk = 2, 16, 40, 16
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.int32) if zero_mask else (
        rng.random((b, s)) < 0.7).astype(np.int32)
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda x, w: jxent(x, labels, w, mask, chunk), argnums=(0, 1))(x, w)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = common.chunked_softmax_xent(tx, torch.from_numpy(labels), tw,
                                       torch.from_numpy(mask), chunk)
    loss.backward()
    if zero_mask:
        assert float(loss) == 0.0 == float(jl)
        assert not tx.grad.any() and not tw.grad.any()
        return
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close_to_scale(tx.grad, jgx, 1e-5, "dx")
    _close_to_scale(tw.grad, jgw, 1e-5, "dw")


# ------------------------------------------------- train_loss, 10 archs

def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)),
             "mask": (rng.random((b, s)) < 0.8).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (0.1 * rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (0.1 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            if k in ("tokens", "labels") else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_f32(arch):
    return jinit(jax.random.PRNGKey(0), japi.param_table(jget_smoke(arch)),
                 dtype=jnp.float32)


def _port_grads(cfg, params_np, batch):
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params_np.items()}
    loss, metrics = api.train_loss(cfg, tp, _torch_batch(batch))
    loss.backward()
    return loss, metrics, {k: p.grad for k, p in tp.items()}


@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_train_loss_and_grads_match_jax(arch, rules_train, mesh11):
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jp = _jax_f32(arch)
    batch = _batch(cfg, 1)
    with mesh11:
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda p, b: japi.train_loss(jcfg, rules_train, p, b),
            has_aux=True))(jp, {k: jnp.asarray(v, jnp.int32 if k in (
                "tokens", "labels") else None) for k, v in batch.items()})
    loss, metrics, grads = _port_grads(cfg, jp, batch)
    assert sorted(metrics) == sorted(jm)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert sorted(grads) == sorted(jg)
    for k in jg:
        _close_to_scale(grads[k], jg[k], 1e-4, k)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b", "rwkv6-7b",
                                  "recurrentgemma-2b", "whisper-small"])
def test_remat_on_and_off_give_the_same_gradients(arch):
    import dataclasses
    cfg = get_smoke_config(arch)
    assert cfg.remat
    params = {k: np.asarray(v) for k, v in _jax_f32(arch).items()}
    batch = _batch(cfg, 2)
    l1, _, g1 = _port_grads(cfg, params, batch)
    l0, _, g0 = _port_grads(dataclasses.replace(cfg, remat=False), params,
                            batch)
    assert torch.equal(l1, l0)
    for k in g1:
        assert torch.equal(g1[k], g0[k]), k


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "whisper-small"])
def test_train_loss_of_a_model_is_that_of_its_flat_dict(arch):
    """``api.train_loss`` takes a model (gradients land on its per-layer
    parameters) or the reference's flat dict (on the stacked tensors):
    the same loss and, stacked, the same gradients."""
    cfg = get_smoke_config(arch)
    params = {k: np.asarray(v) for k, v in _jax_f32(arch).items()}
    loss, _, grads = _port_grads(cfg, params, _batch(cfg, 3))
    model = convert.params_from_numpy(cfg, params, device=CPU,
                                      dtype=torch.float32)
    model.requires_grad_(True)
    got, _ = api.train_loss(cfg, model, _torch_batch(_batch(cfg, 3)))
    got.backward()
    assert torch.equal(got.detach(), loss.detach())
    for name, shape, tensors in model.table_entries():
        g = torch.stack([t.grad for t in tensors]).reshape(shape)
        assert torch.equal(g, grads[name]), name


# ------------------------------- ports of the reference's smoke tests

def _smoke_batch(cfg, seed):
    """``test_models_smoke._batch``'s layout: B=2, S=32, full mask, bf16
    patches or frames of scale 0.1."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 32))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 32))),
             "mask": torch.ones((2, 32), dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (0.1 * torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model)))).to(torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = (0.1 * torch.from_numpy(rng.standard_normal(
            (2, 32, cfg.d_model)))).to(torch.bfloat16)
    return batch


@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_train_step_runs_and_is_finite(arch):
    cfg = get_smoke_config(arch)
    params = common.init_params(0, api.param_table(cfg), device=CPU)
    loss, metrics = api.train_loss(cfg, params, _smoke_batch(cfg, 1))
    assert np.isfinite(float(loss)), f"{arch}: loss not finite"
    assert 0.0 < float(loss) < 20.0
    assert np.isfinite(float(metrics["xent"]))


def test_moe_aux_losses_present():
    cfg = get_smoke_config("olmoe-1b-7b")
    params = common.init_params(0, api.param_table(cfg), device=CPU)
    loss, metrics = api.train_loss(cfg, params, _smoke_batch(cfg, 1))
    assert "moe_aux" in metrics and "moe_z" in metrics
    assert float(metrics["moe_aux"]) >= 0.0
    # total loss includes the aux terms
    assert float(metrics["loss"]) >= float(metrics["xent"])


# ------------------------------------- ports of tests/test_train.py

def test_grad_accumulation_equivalence():
    """accum=2 over a batch == accum=1 over the same batch."""
    cfg = get_smoke_config("llama3.2-1b")
    opt_cfg = OptimizerConfig(warmup_steps=0, total_steps=10,
                              clip_norm=1e9)  # no clipping interference
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=1))
    batch = data.batch(0)
    outs = {}
    for accum in (1, 2):
        state = init_train_state(0, cfg, device=CPU)
        step = make_train_step(cfg, opt_cfg, accum_steps=accum, device=CPU)
        state, m = step(state, batch)
        outs[accum] = (state.params["embed"], m["loss"])
    np.testing.assert_allclose(_np(outs[1][0]), _np(outs[2][0]), atol=2e-2)
    # bf16 params, f32 grads: small tolerance
    assert abs(float(outs[1][1]) - float(outs[2][1])) < 2e-2


def _short_run(arch, steps, seq, seed, compress=False):
    cfg = get_smoke_config(arch)
    state = init_train_state(0, cfg, compress=compress, device=CPU)
    step = make_train_step(
        cfg, OptimizerConfig(peak_lr=3e-3, warmup_steps=2, total_steps=30),
        compress=compress, accum_steps=1, device=CPU)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, 4, seed=seed))
    losses = []
    for i in range(steps):
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
    return losses, m


def test_loss_decreases_short_run():
    losses, _ = _short_run("granite-3-2b", 12, 32, 0)
    assert min(losses[6:]) < losses[0], losses


def test_compressed_training_still_learns():
    losses, m = _short_run("llama3.2-1b", 10, 32, 3, compress=True)
    assert min(losses[5:]) < losses[0]
    assert "compression_err" in m


# ------------------------------------------------ serving is unchanged

@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b",
                                  "whisper-small"])
def test_serving_builds_no_graph_with_trainable_parameters(arch):
    cfg = get_smoke_config(arch)
    frozen = api.init_model(cfg, seed=0, device=CPU)
    trainable = api.init_model(cfg, seed=0, device=CPU).requires_grad_(True)
    assert all(p.requires_grad for p in trainable.parameters())
    batch = _smoke_batch(cfg, 4)
    del batch["labels"], batch["mask"]
    got = {}
    for name, model in (("frozen", frozen), ("trainable", trainable)):
        logits, caches = api.prefill(cfg, model, batch, "reference")
        assert not logits.requires_grad
        full = api.init_caches(cfg, 2, 40, device=CPU)
        with torch.inference_mode():
            for key, layer in full.items():
                for n, big in layer.items():
                    small = caches[key][n]
                    big[tuple(slice(0, m) for m in small.shape)] = small
        step, _ = api.decode_step(cfg, model, full, {
            "tokens": batch["tokens"][:, -1:], "index": 32}, "reference")
        assert not step.requires_grad
        got[name] = (logits, step)
    for a, b in zip(got["frozen"], got["trainable"]):
        assert torch.equal(a, b)


def test_kernel_wrappers_refuse_autograd():
    t = torch.zeros((1, 2, 8, 16), requires_grad=True)
    a = torch.zeros((1, 4, 8), requires_grad=True)
    g = torch.zeros((1, 4, 8))
    b8 = torch.zeros((8,))
    calls = {
        "flash_attention": lambda: fa.flash_attention(t, t, t),
        "rglru": lambda: rg.rglru(a, g, torch.zeros((1, 8))),
        "rglru_gated": lambda: rg.rglru_gated(g, a, g, g, b8, b8, b8),
        "wkv6": lambda: wk.wkv6(*(torch.zeros((1, 3, 2, 16)),) * 3,
                                torch.zeros((1, 3, 2, 16),
                                            requires_grad=True),
                                torch.zeros((2, 16))),
    }
    for name, call in calls.items():
        before = (fa.LAUNCHES, rg.LAUNCHES, wk.LAUNCHES)
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert (fa.LAUNCHES, rg.LAUNCHES, wk.LAUNCHES) == before
        with torch.no_grad():
            call()                      # the plain version on the CPU

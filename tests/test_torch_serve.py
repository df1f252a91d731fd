"""The port's serving engine and CLI (``repro_torch.serve``,
``repro_torch.launch.serve``) against the JAX package's.

* ``ServingEngine`` in both packages on llama3.2-1b, rwkv6-7b,
  recurrentgemma-2b, olmoe-1b-7b, deepseek-v2-lite-16b and whisper-small
  smoke configs with the same weights (JAX's ``init_params``, carried
  across with ``convert``; float32, but bfloat16 for whisper, whose
  reference engine fails on float32 weights: C16): 10 requests of
  uneven prompt lengths (two lengths for the three new families), 3
  slots, ``max_seq=32``; for recurrentgemma
  also 6 requests of 20 and 27 tokens, longer than its smoke window of
  16, so that the local layer's prefill ring and decode ring wrap.
  Whisper's prefills get zero frames of the prompt's length and its
  decode attends over each slot's zero-padded cross cache (C16); the MoE
  prefills drop choices at capacity.  Per request, ``output``,
  ``first_token_t`` and ``finish_t`` are equal.  A token stream that
  parts from JAX's passes only if the port's own top-1 minus top-2 logit
  gap at the first differing token is below ``LOGIT_TOL`` (a near tie
  that summation order can flip) and the pair is listed in
  ``DIVERGENCES``.  One is: whisper's request 0 at its 6th token, a gap
  of 6.1e-5, one bf16 step of its logits (the other 9 streams equal).
* The admission override of ``tests/test_substrate.py`` (one slot,
  shortest prompt first): same admission order and outputs.  Its
  shortest prompt has 2 tokens, 3 for recurrentgemma: the reference's
  depthwise conv fails on fewer than ``conv_width - 1`` tokens (ROADMAP
  C8); the port serves them, and its 2-token prefill equals two decode
  steps from empty caches (``test_short_prompt``).  With one
  slot the reference's ``_write_slot`` finds no batch axis in a dense
  cache and leaves the slot unwritten; the port reproduces that
  (ROADMAP C7).
* ``_write_slot`` itself against JAX's on dense KV, RWKV state and
  token-shift leaves, recurrentgemma's ring KV (a prompt longer than the
  window), f32 ``h`` and conv-history leaves (a prompt shorter than the
  conv's history too), a slot past the end, one slot, one-token prompts:
  bitwise.
* ``python -m repro_torch.launch.serve --smoke --device cpu`` prints the
  reference driver's two lines, for every arch but internvl2-76b.
* C15: the reference engine feeds a vlm prefill no patch embeddings and
  fails with ``KeyError('patches')``; the port's engine and CLI refuse
  the config, naming C15.
* ``python -m repro_torch.examples.serve_twin --device cpu`` prints the
  reference ``examples/serve_twin.py``'s four lines.
"""
import functools
import pathlib
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import api as japi
from repro.models.common import init_params as jinit
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve.engine import _write_slot as jwrite_slot
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.examples import serve_twin
from repro_torch.launch import serve as tserve
from repro_torch.models import api
from repro_torch.serve import Request, ServingEngine
from repro_torch.serve.engine import _write_slot
from torch_threads import one_thread  # noqa: F401


ARCHS = ("llama3.2-1b", "rwkv6-7b", "recurrentgemma-2b")
NEW_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b", "whisper-small")
ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-3
DIVERGENCES = {("whisper-small", 0): 5}   # (arch, req_id): first
#                                            differing token index


#: Whisper serves in bf16: with f32 weights the reference engine's bf16
#: stub frames turn its encoder scan's carry f32, which the scan refuses
#: (ROADMAP C16)
BF16_ARCHS = ("whisper-small",)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = jget_smoke(arch)
    bf16 = arch in BF16_ARCHS
    params = jinit(jax.random.PRNGKey(0), japi.param_table(jcfg),
                   dtype=jnp.bfloat16 if bf16 else jnp.float32)
    model = convert.params_from_numpy(
        get_smoke_config(arch), {k: np.asarray(v.astype(jnp.float32))
                                 for k, v in params.items()},
        device="cpu", dtype=torch.bfloat16 if bf16 else torch.float32)
    return jcfg, params, model


def _prompts(vocab, n, seed, lengths=(3, 6, 11, 15)):
    rng = np.random.default_rng(seed)
    lengths = rng.choice(lengths, size=n)
    return [rng.integers(0, vocab, int(s)).astype(np.int32) for s in lengths]


def _serve(engine, request_cls, prompts, max_new):
    reqs = [request_cls(req_id=i, prompt=p, max_new_tokens=int(m))
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained(max_iters=1000)
    return reqs


@pytest.mark.parametrize("arch,n,lengths,max_seq", [
    *((arch, 10, (3, 6, 11, 15), 32) for arch in ARCHS),
    # two prompt lengths: each is a compile of the reference's prefill
    *((arch, 10, (5, 13), 32) for arch in NEW_ARCHS),
    ("recurrentgemma-2b", 6, (20, 27), 48)],
    ids=[*ARCHS, *NEW_ARCHS, "recurrentgemma-2b-long"])
def test_engine_matches_jax(arch, n, lengths, max_seq, mesh11, rules_decode):
    jcfg, params, model = _weights(arch)
    cfg = get_smoke_config(arch)
    prompts = _prompts(cfg.vocab_size, n, seed=3, lengths=lengths)
    max_new = np.random.default_rng(4).integers(2, 9, size=n)
    with mesh11:
        jeng = JEngine(jcfg, rules_decode, params, batch_slots=3,
                       max_seq=max_seq)
        want = _serve(jeng, JRequest, prompts, max_new)
    eng = ServingEngine(cfg, model, batch_slots=3, max_seq=max_seq,
                        device="cpu")
    got = _serve(eng, Request, prompts, max_new)
    found = {}
    for g, w in zip(got, want):
        assert (g.first_token_t, g.finish_t) == (w.first_token_t,
                                                 w.finish_t), g.req_id
        assert len(g.margins) == len(g.output)
        if g.output != w.output:
            t = next(i for i, (a, b) in enumerate(zip(g.output, w.output))
                     if a != b)
            assert g.margins[t] < LOGIT_TOL, (
                f"request {g.req_id} parts from JAX at token {t} with a "
                f"top-2 gap of {g.margins[t]}")
            found[(arch, g.req_id)] = t
    assert found == {k: v for k, v in DIVERGENCES.items() if k[0] == arch}
    assert all(r is None for r in eng.active) and not eng.queue


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_override_matches_jax(arch, mesh11, rules_decode):
    jcfg, params, model = _weights(arch)
    cfg = get_smoke_config(arch)
    # the reference cannot prefill recurrentgemma on fewer than
    # conv_width - 1 = 3 tokens (ROADMAP C8; test_short_prompt below)
    short = 3 if cfg.family == "hybrid" else 2
    prompts = [np.arange(8, dtype=np.int32),
               np.arange(short, dtype=np.int32),
               np.arange(4, dtype=np.int32)]

    def shortest_first(log):
        def admit(queue):
            idx = min(range(len(queue)), key=lambda i: len(queue[i].prompt))
            log.append(queue[idx].req_id)
            return idx
        return admit

    jorder, torder = [], []
    with mesh11:
        jeng = JEngine(jcfg, rules_decode, params, batch_slots=1,
                       max_seq=24, admission=shortest_first(jorder))
        want = _serve(jeng, JRequest, prompts, [2, 2, 2])
    eng = ServingEngine(cfg, model, batch_slots=1, max_seq=24,
                        admission=shortest_first(torder), device="cpu")
    got = _serve(eng, Request, prompts, [2, 2, 2])
    assert torder == jorder == [1, 2, 0]     # shortest prompt first
    for g, w in zip(got, want):
        assert g.output == w.output
        assert (g.first_token_t, g.finish_t) == (w.first_token_t,
                                                 w.finish_t)


@pytest.mark.parametrize("big,small,slot", [
    ((3, 2, 10, 4), (1, 2, 6, 4), 1),      # dense KV, 3 slots
    ((3, 2, 10, 4), (1, 2, 6, 4), 5),      # slot past the end: clamped
    ((1, 2, 10, 4), (1, 2, 6, 4), 0),      # one slot: left unwritten (C7)
    ((1, 2, 10, 4), (1, 2, 1, 4), 0),      # one slot, 1-token prompt
    ((1, 1, 10, 4), (1, 1, 1, 4), 0),      # MQA, one slot, 1 token
    ((2, 3, 4, 4), (1, 3, 4, 4), 1),       # RWKV wkv state
    ((2, 8), (1, 8), 0),                   # RWKV token shift
    ((1, 8), (1, 8), 0),                   # equal shapes: replaced
    ((3, 1, 16, 8), (1, 1, 16, 8), 2),     # ring KV, prompt > window
    ((3, 1, 16, 8), (1, 1, 9, 8), 1),      # ring KV, prompt < window
    ((2, 64), (1, 64), 1),                 # RG-LRU h (f32)
    ((3, 3, 64), (1, 3, 64), 0),           # conv history
    ((3, 3, 64), (1, 2, 64), 2)],          # conv history, 2-token prompt
    ids=["kv", "kv-clamp", "one-slot", "one-slot-1tok", "mqa-1tok",
         "wkv", "shift", "equal", "ring", "ring-short", "rglru-h", "conv",
         "conv-short"])
def test_write_slot_matches_jax(big, small, slot):
    rng = np.random.default_rng(len(big) * 10 + slot)
    b = rng.standard_normal(big).astype(np.float32)
    s = rng.standard_normal(small).astype(np.float32)
    want = np.asarray(jwrite_slot(jnp.asarray(b), jnp.asarray(s), slot))
    got = torch.from_numpy(b.copy())
    _write_slot(got, torch.from_numpy(s), slot)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS)
def test_cli_prints_two_lines(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--requests", "5", "--slots", "2", "--max-seq", "24",
                 "--max-new", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert re.fullmatch(r"served 5 requests, 15 tokens in [\d.]+s "
                        r"\([\d.]+ tok/s\)", lines[0])
    assert re.fullmatch(r"mean TTFT [\d.]+ engine-steps, mean tokens/req "
                        r"3\.0", lines[1])
    with pytest.raises(SystemExit, match="production"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--mesh", "production"])


def test_short_prompt(mesh11, rules_decode):
    """C8: the reference's prefill fails on a 2-token recurrentgemma
    prompt; the port's prefill logits and conv history (two zero rows
    before the prompt's, cw - 1 = 3 rows) equal two decode steps from
    zero f32 caches.  atol = rtol = 1e-5 (the same f32 arithmetic in
    another order: a width-4 conv against a 2-row history)."""
    jcfg, params, model = _weights("recurrentgemma-2b")
    cfg = get_smoke_config("recurrentgemma-2b")
    prompt = np.array([[5, 77]], dtype=np.int32)
    with mesh11, pytest.raises(TypeError):
        japi.prefill(jcfg, rules_decode, params,
                     {"tokens": jnp.asarray(prompt)})
    toks = torch.from_numpy(prompt).long()
    with torch.inference_mode():
        want, caches = api.prefill(cfg, model, {"tokens": toks})
        step = api.init_caches(cfg, 1, 16, dtype=torch.float32, device="cpu")
        for i in range(2):
            got, step = api.decode_step(cfg, model, step,
                                        {"tokens": toks[:, i:i + 1],
                                         "index": i})
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    conv = caches["seg1.l0"]["conv"]
    assert conv.shape == (1, 3, 64)
    np.testing.assert_allclose(step["seg1.l0"]["conv"].numpy(),
                               conv.numpy(), atol=1e-5, rtol=1e-5)


def test_vlm_refused_by_both_engines(mesh11, rules_decode):
    """C15: the JAX engine's prefill of a vlm request fails for want of
    patch embeddings; the port refuses the config up front."""
    jcfg = jget_smoke("internvl2-76b")
    cfg = get_smoke_config("internvl2-76b")
    params = jinit(jax.random.PRNGKey(0), japi.param_table(jcfg),
                   dtype=jnp.float32)
    with mesh11:
        jeng = JEngine(jcfg, rules_decode, params, batch_slots=2,
                       max_seq=24)
        jeng.submit(JRequest(req_id=0, prompt=np.arange(5, dtype=np.int32),
                             max_new_tokens=2))
        with pytest.raises(KeyError, match="patches"):
            jeng.run_until_drained()
    model = api.init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="C15"):
        ServingEngine(cfg, model, batch_slots=2, max_seq=24, device="cpu")
    with pytest.raises(SystemExit, match="C15"):
        tserve.main(["--arch", "internvl2-76b", "--smoke", "--device",
                     "cpu"])


def test_serve_twin_prints_the_reference_report(capsys):
    runpy.run_path(str(ROOT / "examples" / "serve_twin.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    serve_twin.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert len(want.splitlines()) == 4
    assert got == want

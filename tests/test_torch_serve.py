"""The port's serving engine and CLI (``repro_torch.serve``,
``repro_torch.launch.serve``) against the JAX package's.

* ``ServingEngine`` in both packages on llama3.2-1b and rwkv6-7b smoke
  configs with the same float32 weights (JAX's ``init_params``, carried
  across with ``convert``): 10 requests of uneven prompt lengths, 3
  slots, ``max_seq=32``.  Per request, ``output``, ``first_token_t`` and
  ``finish_t`` are equal.  A token stream that parts from JAX's would
  pass only if the port's own top-1 minus top-2 logit gap at the first
  differing token were below ``LOGIT_TOL`` (a near tie that float32
  summation order can flip) and the pair were listed in ``DIVERGENCES``;
  none was found, so the list is empty.
* The admission override of ``tests/test_substrate.py`` (one slot,
  shortest prompt first): same admission order and outputs.  With one
  slot the reference's ``_write_slot`` finds no batch axis in a dense
  cache and leaves the slot unwritten; the port reproduces that
  (ROADMAP C7).
* ``_write_slot`` itself against JAX's on dense KV, RWKV state and
  token-shift leaves, a slot past the end, one slot, one-token prompts:
  bitwise.
* ``python -m repro_torch.launch.serve --smoke --device cpu`` prints the
  reference driver's two lines, for both archs.
"""
import functools
import re

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
from repro_torch.launch import serve as tserve
from repro_torch.serve import Request, ServingEngine
from repro_torch.serve.engine import _write_slot

ARCHS = ("llama3.2-1b", "rwkv6-7b")
LOGIT_TOL = 1e-3
DIVERGENCES = {}          # (arch, req_id): first differing token index


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = jget_smoke(arch)
    params = jinit(jax.random.PRNGKey(0), japi.param_table(jcfg),
                   dtype=jnp.float32)
    model = convert.params_from_numpy(
        get_smoke_config(arch), {k: np.asarray(v) for k, v in
                                 params.items()},
        device="cpu", dtype=torch.float32)
    return jcfg, params, model


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.choice([3, 6, 11, 15], size=n)
    return [rng.integers(0, vocab, int(s)).astype(np.int32) for s in lengths]


def _serve(engine, request_cls, prompts, max_new):
    reqs = [request_cls(req_id=i, prompt=p, max_new_tokens=int(m))
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained(max_iters=1000)
    return reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch, mesh11, rules_decode):
    jcfg, params, model = _weights(arch)
    cfg = get_smoke_config(arch)
    prompts = _prompts(cfg.vocab_size, 10, seed=3)
    max_new = np.random.default_rng(4).integers(2, 9, size=10)
    with mesh11:
        jeng = JEngine(jcfg, rules_decode, params, batch_slots=3,
                       max_seq=32)
        want = _serve(jeng, JRequest, prompts, max_new)
    eng = ServingEngine(cfg, model, batch_slots=3, max_seq=32, device="cpu")
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
    prompts = [np.arange(8, dtype=np.int32), np.arange(2, dtype=np.int32),
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
    ((1, 8), (1, 8), 0)],                  # equal shapes: replaced
    ids=["kv", "kv-clamp", "one-slot", "one-slot-1tok", "mqa-1tok",
         "wkv", "shift", "equal"])
def test_write_slot_matches_jax(big, small, slot):
    rng = np.random.default_rng(len(big) * 10 + slot)
    b = rng.standard_normal(big).astype(np.float32)
    s = rng.standard_normal(small).astype(np.float32)
    want = np.asarray(jwrite_slot(jnp.asarray(b), jnp.asarray(s), slot))
    got = torch.from_numpy(b.copy())
    _write_slot(got, torch.from_numpy(s), slot)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
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

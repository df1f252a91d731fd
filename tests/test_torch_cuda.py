"""K1, K1', K2, K3 and K4 against their plain versions on a CUDA card.  Every test is marked ``cuda`` and skips on a host without
one: a CUDA kernel has no CPU mode.  This file imports neither JAX nor
the JAX package, so that it runs on the GPU machine, which has no JAX:

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

* K4 (``kernels.flash_attention``) vs ``models.attention.full_attention``:
  every head dim and dtype it takes (float32 refuses D = 256), causal and
  not, ragged Sq and Sk (including Sq != Sk and single rows), q/k/v as
  strided views of (B, S, H, D) projections; then recurrentgemma's local
  layer (bf16, Hq 10, Hkv 1, D 256) with windows of 100 (not a multiple
  of the key tile, so a row's first tile can lie wholly outside its
  window) and 2048, at ragged S up to 3072, and the window in float32.
  The bf16 kernel's edges: Sq and Sk of 127, 129 and 1000 (TMA's zero
  fill of ragged tiles), B=2 with views of a fused QKV layout at every
  head dim, GQA groups 1, 4 and 10, windows from 1 to 2048 at S up to
  3072, and one ``LAUNCHES`` per call.
  Tolerance: float32 atol = rtol = 2e-5, bfloat16 3e-2 (JAX's own flash
  tests' tolerances).
* K3 (``kernels.wkv6``) vs ``models.blocks_rnn.wkv_scan`` from a zero
  state: every head size it takes, S of 1, 37 and 1000.  Tolerance:
  atol = rtol = 2e-4 (``tests/test_kernels_recurrent.py``'s).
* K2 (``kernels.rglru``) vs ``models.blocks_rnn.rglru_scan``: zero and
  nonzero h0, ragged S and W, recurrentgemma's width, and the 8-column
  strips' edges (W of 8, 9, 17 and 2568; S of 64 and 65, a chunk and
  one step).  Bitwise: both round the product and the sum apart.
* K2's gated entry (``kernels.rglru.rglru_gated``) vs
  ``models.blocks_rnn.rglru_gated_scan``, bfloat16 and float32: a
  decode step (1, 1, 2560) from h0 = 5 N(0, 1) written in place,
  (2, 37, 24), (3, 129, 2560), (1, 2048, 2560) and (1, 3072, 2560),
  with gate pre-activations of +-30, -87.5 and -100 and lambda of 20.5,
  25, -20 and -30 (sigmoid exactly 1, the exact reciprocal past 2^126,
  a exactly 0 and 1, the 1e-12 clamp), widths that take the
  one-element path (W of 37 and, in bf16, 20 and 100) and a TMA box
  past W (100 in f32); then a sweep of pre-activations over [-90, 40]
  and lambda over [-25, 25] at (1, 4096, 2560).  Bitwise: the kernel
  repeats the plain version's operations and roundings.  One
  ``LAUNCHES`` per call.
* K3 at B = 2 for every head size and S of 1, 7, 16, 17 and 1000 (one
  step, less than a chunk, one chunk, a chunk and one step, a short
  tail chunk), with w holding exact zeros and exact ones, and with w
  made as ``rwkv_time_mix`` makes it, exp(-exp(x)), x spread from exact
  1.0 to exact 0.  Same tolerance.
* K1' (``kernels.policy_eval.policy_eval_pass``) vs its plain version,
  the batched pass on the shared rows expanded to k, at k = 32 and
  J = 1024 and at the largest J.  Bitwise (integers).
* K1 (``kernels.policy_eval.policy_eval_pass_batched``) vs its plain
  version, ``core.backfill.schedule_pass_batched``, on forks built to
  steer the warp-parallel backfill walk: more than 32 candidates,
  rejections at the first lane of a round, at the last, and in every
  lane, a candidate that passes the pre-test and fails once earlier
  lanes start, candidates bounded by ``extra``; C1's forced end-time
  ties; ``limit < J``; J not a multiple of 32 or 256; every rows-per-
  thread layout up to J = 4096 (k = 1), rows that are not 16-byte
  aligned; no head and an empty queue; K1' on the same shared rows.
  Bitwise.
* K1 with ``limit = 0`` (a replay step where no live fork has a queued
  job, which the drain never passes) on forks with running jobs only,
  empty forks and dead forks: it starts nothing and returns ``free0``,
  bitwise its plain version.
* The trace replay (``DrainEngine.replay_grid``) with backend ``cuda``
  against ``reference`` on the card, on a (4 scenarios x 7 policies)
  grid and a (2 x 32) DRAS-sweep grid with hoisted static forks:
  ``start_t``, ``end_t``, ``deadlocked``, ``events``, ``iters``,
  ``pass_invocations``, ``costs`` and ``best`` identical; K1 launched
  once per host iteration on ``cuda``, never on ``reference``.
* A block of ``des.REPLAY_BLOCK`` replay steps under
  ``torch.cuda.set_sync_debug_mode("error")``: no step waits for the
  device.
* K1 at the Monte-Carlo paths' fork counts, k = 2048 (a 64-member fan
  of the k=32 pool) and 16,384 (S·F·P = 8 × 64 × 32), on tight random
  forks: bitwise its plain version, one launch each.
* The threefry PRNG (``core.prng``) on the card against the CPU: keys,
  bits, uniforms, normals, ``exp_f32`` and the fans' member draws and
  domain fragilities identical (every operation is IEEE-exact).
* A fan grid (S=2 × F=8 × P=7, noise, burst, failures) with backend
  ``cuda`` against ``reference`` on the card, and against
  ``replay_grid`` of its ``materialize_fan`` rows; ``decide_fan``,
  ``decide_ensemble`` and ``decide_race`` on a snapshot, cuda against
  reference: identical in every field; K1 launched on every cuda path.
* ``prng.sin_f32`` (glibc's ``sinf``) on the card against the CPU over
  ±1e5 rad and the region around 120 rad: identical.
* The learner (``learn.train``): a generation's costs on ``cuda``
  identical to ``reference`` on the card; a run resumed from its
  generation-2 checkpoint on the card identical to the uninterrupted
  one (θ, history, held-out cost); K1 launched by both.
* Twin snapshots on the card: a co-simulation killed after four cycles,
  snapshot, restored into a fresh ``cuda`` twin and run to the end
  makes the uninterrupted run's decisions (an ensemble twin, so the key
  chain rides the snapshot).
* The fleet engine on the card: ``sharded_replay_grid`` streamed in
  blocks of 2 and 3 scenarios, and on two shards of ``cuda:0``, against
  the one-shot ``replay_grid`` (every field, metrics included);
  ``sharded_whatif`` and ``sharded_fan_grid`` on two shards against
  ``decide`` and ``fan_grid``; K1 launched by each.  A stream under
  ``set_sync_debug_mode("warn")`` synchronises exactly once per read of
  the replay loop's condition (one a ``des.REPLAY_BLOCK`` steps of each
  piece): its uploads, concatenation, metrics and selection wait for
  nothing.  ``make_fleet_mesh`` takes the local cards and refuses other
  counts; a mesh naming a card past the last raises.
* K4 at whisper-small's audio shapes (B=1, H=12, D=64, bf16): encoder
  self-attention at S=1500 and cross attention at Sq=448, Sk=1500, both
  non-causal; 3e-2.
* The serving families of the eighth slice on the card, at smoke size:
  ``moe_apply`` (both dispatches, chunked by ``MOE_CHUNK`` = 16) on cuda
  against the same call on the CPU (routing, hence ``moe_dropped``,
  equal; y and aux rtol 1e-4 / atol 1e-5 in float32, no TF32); MLA's
  absorbed decode on cuda against the CPU and against the full
  forward; whisper and olmoe prefills with K4 (``backend="cuda"``)
  against the plain versions, and K4's launches a prefill (whisper: 2
  encoder + 2 x 2 decoder layers; olmoe: 2 layers).
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.cluster import workload
from repro_torch.core import des
from repro_torch.core.engine import (DrainEngine, make_order_fn,
                                     replay_inputs)
from repro_torch.core.fan import FanSpec
from repro_torch.core.policies import parse_pool
from repro_torch.core.whatif import (sharded_fan_grid, sharded_replay_grid,
                                     sharded_whatif)
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh
from repro_torch.kernels import policy_eval as pe
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.attention import full_attention
from repro_torch.core.backfill import schedule_pass_batched
from repro_torch.models.blocks_rnn import (rglru_gated_scan, rglru_scan,
                                          wkv_scan)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("d", (32, 64, 128, 256))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_flash_attention_matches_plain_version(d, dtype, tol):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    if d not in fa.HEAD_DIMS[dtype]:
        q = torch.zeros((1, 2, 8, d), device="cuda", dtype=dtype)
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention(q, q, q)
        return
    for b, hq, hkv, sq, sk in ((2, 4, 2, 100, 100), (1, 8, 1, 65, 200),
                               (1, 32, 8, 1000, 1000), (3, 2, 2, 1, 1)):
        for causal in (True, False):
            def proj(h, s):
                return torch.randn((b, s, h, d), generator=gen,
                                   device="cuda").to(dtype).transpose(1, 2)
            q, k, v = proj(hq, sq), proj(hkv, sk), proj(hkv, sk)
            launches = fa.LAUNCHES
            got = fa.flash_attention(q, k, v, causal=causal)
            want = full_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert fa.LAUNCHES == launches + 1
            assert got.dtype == dtype and got.shape == want.shape
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)


def _bf16_views(gen, b, s, h, d, width=None):
    """(B, H, S, D) bf16 views of a (B, S, width, D) projection: heads
    [0, h) of it, so the head and sequence strides are the projection's
    (``width`` > h leaves gaps, as a fused QKV projection does)."""
    full = torch.randn((b, s, width or h, d), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    return full[:, :, :h].transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", (64, 256))
@pytest.mark.parametrize("sq,sk", [(127, 127), (129, 129), (1000, 1000),
                                   (129, 127), (127, 1000), (1000, 129)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_ragged_lengths(d, sq, sk, causal):
    """Sq and Sk off the 128-row query tile and the key tile: TMA's zero
    fill of the ragged tiles, and the mask on them."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(sq * 7 + sk + d)
    q = _bf16_views(gen, 1, sq, 4, d)
    k = _bf16_views(gen, 1, sk, 2, d)
    v = _bf16_views(gen, 1, sk, 2, d)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = full_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", (32, 64, 128, 256))
def test_flash_attention_strided_batch(d):
    """B=2, q/k/v as strided views of wider (B, S, H, D) projections (a
    fused QKV layout), the output as the wrapper's transposed buffer."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(d + 2)
    q = _bf16_views(gen, 2, 300, 4, d, width=8)
    k = _bf16_views(gen, 2, 300, 2, d, width=6)
    v = _bf16_views(gen, 2, 300, 2, d, width=6)
    assert not q.is_contiguous() and fa.tma_ready(q) and fa.tma_ready(k)
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal)
        want = full_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", (64, 256))
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (10, 1)],
                         ids=["group1", "group4", "group10"])
def test_flash_attention_gqa_groups(d, hq, hkv):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(hq * 10 + hkv + d)
    q = _bf16_views(gen, 1, 520, hq, d)
    k = _bf16_views(gen, 1, 520, hkv, d)
    v = _bf16_views(gen, 1, 520, hkv, d)
    got = fa.flash_attention(q, k, v, causal=True)
    want = full_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 63, 100, 200, 1000, 2048])
@pytest.mark.parametrize("s", [129, 1000, 3072])
def test_flash_attention_window_edges(window, s):
    """D=256 (64-key tiles): windows that are and are not multiples of
    the key tile, narrower and wider than a 128-row query tile."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(window + s)
    q = _bf16_views(gen, 1, s, 10, 256)
    k = _bf16_views(gen, 1, s, 1, 256)
    v = _bf16_views(gen, 1, s, 1, 256)
    got = fa.flash_attention(q, k, v, window=window)
    want = full_attention(q, k, v, causal=True, local_window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.cuda
def test_flash_attention_counts_each_launch():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = _bf16_views(gen, 1, 200, 4, 64)
    k = _bf16_views(gen, 1, 200, 2, 64)
    fa.LAUNCHES = 0
    for n in range(1, 4):
        fa.flash_attention(q, k, k, causal=n % 2 == 1)
        assert fa.LAUNCHES == n
    full_attention(q, k, k)
    assert fa.LAUNCHES == 3


@pytest.mark.cuda
@pytest.mark.parametrize("n", wk.HEAD_SIZES)
def test_wkv6_matches_plain_version(n):
    _card()
    rng = np.random.default_rng(n)
    for b, s, h in ((1, 1, 2), (2, 37, 3), (1, 1000, 8)):
        r, k, v = (torch.from_numpy(rng.standard_normal(
            (b, s, h, n)).astype(np.float32)).cuda() for _ in range(3))
        w = torch.sigmoid(torch.from_numpy(rng.standard_normal(
            (b, s, h, n)).astype(np.float32))).cuda()
        u = torch.from_numpy(rng.standard_normal((h, n)).astype(
            np.float32)).cuda()
        launches = wk.LAUNCHES
        y, st = wk.wkv6(r, k, v, w, u)
        st_ref, y_ref = wkv_scan(torch.zeros((b, h, n, n), device="cuda"),
                                 r, k, v, w, u)
        torch.cuda.synchronize()
        assert wk.LAUNCHES == launches + 1
        torch.testing.assert_close(y, y_ref, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(st, st_ref, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [100, 2048])
def test_flash_attention_window_matches_plain_version(window):
    """recurrentgemma-2b's local layer: bf16, Hq 10, Hkv 1, D 256."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(window)
    for s in (1, 100, 333, 2048, 2500, 3072):
        def proj(h):
            return torch.randn((1, s, h, 256), generator=gen, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
        q, k, v = proj(10), proj(1), proj(1)
        launches = fa.LAUNCHES
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        want = full_attention(q, k, v, causal=True, local_window=window)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == launches + 1
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", (32, 64, 128))
def test_flash_attention_window_f32_matches_plain_version(d):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    for s, window in ((200, 100), (130, 64), (65, 1)):
        q = torch.randn((2, 4, s, d), generator=gen, device="cuda")
        k = torch.randn((2, 2, s, d), generator=gen, device="cuda")
        v = torch.randn((2, 2, s, d), generator=gen, device="cuda")
        got = fa.flash_attention(q, k, v, window=window)
        want = full_attention(q, k, v, causal=True, local_window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", [(1, 1, 1), (2, 37, 24), (1, 300, 100),
                                   (3, 129, 2560), (1, 2048, 2560),
                                   (1, 64, 8), (2, 65, 9), (1, 200, 17),
                                   (1, 129, 2568)])
def test_rglru_matches_plain_version(b, s, w):
    _card()
    rng = np.random.default_rng(s + w)
    a = torch.sigmoid(torch.from_numpy(rng.standard_normal(
        (b, s, w)).astype(np.float32))).cuda()
    x = torch.from_numpy(rng.standard_normal((b, s, w)).astype(
        np.float32)).cuda()
    for h0 in (torch.zeros((b, w), device="cuda"),
               torch.from_numpy(5.0 * rng.standard_normal((b, w)).astype(
                   np.float32)).cuda()):
        launches = rg.LAUNCHES
        h_all, h_final = rg.rglru(a, x, h0)
        want_final, want_all = rglru_scan(a, x, h0)
        torch.cuda.synchronize()
        assert rg.LAUNCHES == launches + 1
        assert torch.equal(h_all, want_all)
        assert torch.equal(h_final, want_final)


def _gated_case(b, s, w, dtype, seed, sweep=False):
    """The gated entry's inputs, made with numpy: gate products with
    extreme pre-activations (or a sweep of them), biases, lambda, u and
    the branch."""
    rng = np.random.default_rng(seed)
    if sweep:
        gr, gi = (rng.uniform(-90.0, 40.0, (b, s, w)) for _ in range(2))
        lam = rng.uniform(-25.0, 25.0, w)
    else:
        gr, gi = (2.0 * rng.standard_normal((b, s, w)) for _ in range(2))
        lam = 3.0 * rng.standard_normal(w)
        gr[..., 0::7], gr[..., 1::7], gr[..., 4::7] = 30.0, -30.0, -87.5
        gi[..., 2::7], gi[..., 3::7], gi[..., 5::7] = 30.0, -30.0, -100.0
        lam[0::5], lam[1::5], lam[2::5], lam[3::5] = 20.5, -20.0, -30.0, 25.0
    u, br = (rng.standard_normal((b, s, w)) for _ in range(2))
    rb, ib = rng.standard_normal(w), rng.standard_normal(w)
    return [torch.from_numpy(v.astype(np.float32)).to(dtype).cuda()
            for v in (gr, gi, u, br, rb, ib, lam)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", [(1, 1, 2560), (2, 37, 24), (2, 37, 37),
                                   (2, 21, 20), (1, 100, 100),
                                   (3, 129, 2560), (1, 2048, 2560),
                                   (1, 3072, 2560)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_rglru_gated_matches_plain_version(dtype, b, s, w):
    _card()
    args = _gated_case(b, s, w, dtype, seed=b * s + w)
    rng = np.random.default_rng(w)
    h0 = torch.from_numpy((5.0 * rng.standard_normal((b, w))).astype(
        np.float32)).cuda()
    for start in (None, h0):
        want_y, want_h = rglru_gated_scan(*args, start)
        launches = rg.LAUNCHES
        y, h = rg.rglru_gated(*args, start)
        torch.cuda.synchronize()
        assert rg.LAUNCHES == launches + 1
        assert torch.equal(y, want_y) and torch.equal(h, want_h)
    cache_h = h0.clone()                       # decode: h in place
    y, h = rg.rglru_gated(*args, cache_h, h_final=cache_h)
    torch.cuda.synchronize()
    assert h is cache_h
    assert torch.equal(y, want_y) and torch.equal(cache_h, want_h)


@pytest.mark.cuda
def test_rglru_gated_sweep_matches_plain_version():
    _card()
    args = _gated_case(1, 4096, 2560, torch.bfloat16, seed=1, sweep=True)
    y, h = rg.rglru_gated(*args)
    want_y, want_h = rglru_gated_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


@pytest.mark.cuda
def test_shared_pass_matches_plain_version():
    _card()
    import sys
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    for k, J, seed, collide in ((3, 64, 0, True), (32, 1024, 1, True),
                                (32, 1024, 2, False), (8, pe.MAX_J, 3, True)):
        args = chip_smoke.shared_passes(torch, k, J, seed, collide)
        launches = pe.SHARED_LAUNCHES
        s_k, f_k = pe.policy_eval_pass(*args)
        s_p, f_p = pe.shared_pass_plain(*args)
        torch.cuda.synchronize()
        assert pe.SHARED_LAUNCHES == launches + 1
        assert torch.equal(s_k, s_p) and torch.equal(f_k, f_p)


def _wkv_case(b, s, h, n, seed, w_kind):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h, n)).astype(np.float32)).cuda() for _ in range(3))
    if w_kind == "model":
        # rwkv_time_mix's decay: from exact 1.0 (x < ~-17) to exact 0
        # (x > ~4.5)
        x = torch.from_numpy(rng.uniform(-30.0, 6.0, (b, s, h, n)).astype(
            np.float32)).cuda()
        w = torch.exp(-torch.exp(x))
    else:
        w = torch.sigmoid(torch.from_numpy(rng.standard_normal(
            (b, s, h, n)).astype(np.float32))).cuda()
        pick = torch.from_numpy(rng.random((b, s, h, n))).cuda()
        w = torch.where(pick < 0.15, 0.0, torch.where(pick > 0.85, 1.0, w))
    u = torch.from_numpy(rng.standard_normal((h, n)).astype(
        np.float32)).cuda()
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("w_kind", ["zeros_ones", "model"])
@pytest.mark.parametrize("s", (1, 7, 16, 17, 1000))
@pytest.mark.parametrize("n", wk.HEAD_SIZES)
def test_wkv6_chunks_and_extreme_decays(n, s, w_kind):
    _card()
    r, k, v, w, u = _wkv_case(2, s, 3, n, seed=n * s, w_kind=w_kind)
    assert (w == 0.0).any() and (w == 1.0).any()
    launches = wk.LAUNCHES
    y, st = wk.wkv6(r, k, v, w, u)
    st_ref, y_ref = wkv_scan(torch.zeros((2, 3, n, n), device="cuda"),
                             r, k, v, w, u)
    torch.cuda.synchronize()
    assert wk.LAUNCHES == launches + 1
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, y_ref, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(st, st_ref, atol=2e-4, rtol=2e-4)


# ---- K1's backfill walk -------------------------------------------------
QUEUED, RUNNING = 1, 2

#: C1's forced end-time tie (tests/test_torch_backfill.py::C1_STATE) and
#: two more of that file's tie states, as (total, running, queued).
TIE_FORKS = [
    (10, [(4, 100.0), (4, 100.0)], [(5, 50.0), (2, 1000.0)]),
    (12, [(3, 50.0), (3, 50.0), (3, 50.0)],
     [(7, 10.0), (2, 500.0), (1, 20.0), (2, 60.0)]),
    (9, [(3, 80.0), (3, 80.0), (2, 120.0)],
     [(4, 5.0), (1, 80.0), (1, 81.0), (1, 400.0)]),
]


def _fork(J, free0, running, queued, now=0.0):
    """One fork's rows: running jobs [(nodes, end)] in the first slots,
    queued jobs [(nodes, est)] after them, ranked in that order; the
    order lists the queued slots first, then every other slot."""
    state = np.zeros(J, np.int32)
    nodes = np.zeros(J, np.int32)
    est = np.full(J, 3600.0, np.float32)
    end = np.full(J, np.inf, np.float32)
    for s, (nd, e) in enumerate(running):
        state[s], nodes[s], end[s] = RUNNING, nd, e
    q0 = len(running)
    for c, (nd, e) in enumerate(queued):
        state[q0 + c], nodes[q0 + c], est[q0 + c] = QUEUED, nd, e
    q = list(range(q0, q0 + len(queued)))
    order = np.array(q + list(range(q0)) + list(range(q0 + len(q), J)),
                     np.int32)
    return order, state, nodes, est, end, free0, now


def _walk_forks():
    """Forks whose head blocks at rank 0, so that rank 1 + l is lane l of
    the walk's first round (the shadow comes from one running job)."""
    a, b = 10.0, 500.0          # est: cond_a holds / fails (shadow 100)
    forks = {
        # 6 + 6 > 10: lane 1 passes the pre-test, fails the scan; then
        # every later lane, 69 candidates over three rounds, is rejected
        "every_lane": (10, [(4, 100.0)], [(11, 50.0)] + [(6, a)] * 70),
        # alternating large cond_a and small extra-bound jobs
        "alternating": (20, [(10, 100.0)],
                        [(25, 50.0)] + [(15, a), (1, b)] * 30),
        # lanes 0..30 fit, lane 31 tips over; 4 more start in round 2
        "last_lane": (35, [(10, 100.0)],
                      [(40, 50.0)] + [(1, a)] * 31 + [(5, a)]
                      + [(1, a)] * 32),
        # round 1 takes 32 of 33 nodes; lane 0 of round 2 no longer fits
        "first_lane": (33, [(10, 100.0)],
                       [(40, 50.0)] + [(1, a)] * 32 + [(2, a)]
                       + [(1, a)] * 31),
        # extra (6) bounds the !cond_a jobs, free (10) the others
        "extra_bound": (10, [(8, 100.0)],
                        [(12, 50.0)] + [(2, b), (1, a)] * 30),
        "no_head": (64, [(4, 10.0)], [(2, 5.0)] * 20),
        "empty_queue": (8, [(4, 10.0), (2, 10.0)], []),
    }
    forks.update({f"tie_{i}": (total - sum(n for n, _ in run), run, q)
                  for i, (total, run, q) in enumerate(TIE_FORKS)})
    return forks


def _stack(forks, J, limit=None, offset=0):
    """(k, J) pass inputs on the card from ``_fork`` rows; ``offset``
    shifts every row array off a 16-byte boundary."""
    cols = list(zip(*forks))

    def dev(rows, dtype):
        a = np.stack(rows).astype(dtype)
        buf = torch.empty(a.size + offset, dtype=torch.from_numpy(a).dtype,
                          device="cuda")
        t = buf[offset:].view(a.shape)
        t.copy_(torch.from_numpy(a))
        return t
    order, state, nodes, est, end = (
        dev(cols[0], np.int32), dev(cols[1], np.int32),
        dev(cols[2], np.int32), dev(cols[3], np.float32),
        dev(cols[4], np.float32))
    free0 = torch.tensor(cols[5], dtype=torch.int32, device="cuda")
    now = torch.tensor(cols[6], dtype=torch.float32, device="cuda")
    lim = (None if limit is None
           else torch.tensor([limit], dtype=torch.int32, device="cuda"))
    return order, state, nodes, est, end, free0, now, lim


def _assert_k1(args):
    launches = pe.LAUNCHES
    s_k, f_k = pe.policy_eval_pass_batched(*args)
    s_p, f_p = schedule_pass_batched(*args)
    torch.cuda.synchronize()
    assert pe.LAUNCHES == launches + 1
    assert torch.equal(s_k, s_p) and torch.equal(f_k, f_p)
    return s_p


@pytest.mark.cuda
@pytest.mark.parametrize("J", (77, 96, 1000, 1024, 1500, 2050, 4096))
def test_pass_walk_forks(J):
    _card()
    forks = _walk_forks()
    rows = [_fork(J, free0, run, q) for free0, run, q in forks.values()]
    started = _assert_k1(_stack(rows, J)).cpu()
    names = list(forks)
    # the walk's outcomes the forks were built for (plain version's)
    got = {n: int(started[i].sum()) for i, n in enumerate(names)}
    assert got["every_lane"] == 1 and got["last_lane"] == 31 + 4
    assert got["first_lane"] == 32 + 1 and got["no_head"] == 20
    assert got["empty_queue"] == 0
    # misaligned rows take the kernel's scalar loads: same answers
    _assert_k1(_stack(rows, J, offset=1))
    # limit < J: a rank limit that cuts the candidates
    _assert_k1(_stack(rows, J, limit=40))


@pytest.mark.cuda
@pytest.mark.parametrize("k,J,seed", [(1, pe.MAX_J, 0), (64, 96, 1),
                                      (64, 1000, 2), (32, 1024, 3),
                                      (16, 3001, 4)])
def test_pass_tight_random_forks(k, J, seed):
    """Random forks with small jobs and tight free nodes: many candidates
    per fork, most rejected by the walk, with shadow-time ties."""
    _card()
    rng = np.random.default_rng(seed)
    forks = []
    for _ in range(k):
        n_run = int(rng.integers(0, min(J // 4, 200)))
        n_q = int(rng.integers(0, J - n_run))
        run = [(int(rng.integers(1, 8)), float(rng.integers(1, 6) * 600))
               for _ in range(n_run)]
        q = [(int(rng.integers(1, 8)), float(rng.integers(1, 8) * 600))
             for _ in range(n_q)]
        forks.append(_fork(J, int(rng.integers(0, 40)), run, q,
                           now=float(rng.integers(0, 2) * 600)))
    _assert_k1(_stack(forks, J))
    _assert_k1(_stack(forks, J, limit=J // 3))


@pytest.mark.cuda
def test_shared_pass_walk_forks():
    """K1' on the shared rows of each walk fork, k = 8 orders: the
    fork's own and seven random shuffles of its queued ranks."""
    _card()
    J = 200
    rng = np.random.default_rng(0)
    for free0, run, q in _walk_forks().values():
        order, state, nodes, est, end, f0, now = _fork(J, free0, run, q)
        nq = len(q)
        orders = [order] + [np.concatenate([rng.permutation(order[:nq]),
                                            order[nq:]]) for _ in range(7)]
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
        args = (dev(np.stack(orders)), dev(state), dev(nodes), dev(est),
                dev(end), torch.tensor([f0], dtype=torch.int32,
                                       device="cuda"),
                torch.tensor([now], dtype=torch.float32, device="cuda"),
                None)
        s_k, f_k = pe.policy_eval_pass(*args)
        s_p, f_p = pe.shared_pass_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p) and torch.equal(f_k, f_p)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_pass_with_limit_zero_starts_nothing(seed):
    """``limit = 0``, as a replay step passes it when no live fork has a
    queued job: forks with running jobs only, empty forks, and dead
    forks whose queued jobs each need more than the free nodes.  Nothing
    starts and free = free0, bitwise the plain version.  (The limit's
    contract is that no rank at or past it holds a queued slot; a
    smaller limit is not an input of the pass.)"""
    _card()
    rng = np.random.default_rng(seed)
    J = (64, 1024, pe.MAX_J)[seed]
    forks = []
    for f in range(12):
        run = [(int(rng.integers(1, 8)), float(rng.integers(1, 6) * 600))
               for _ in range(int(rng.integers(0, 20)))]
        free0 = int(rng.integers(0, 40))
        dead = [(free0 + int(rng.integers(1, 9)),
                 float(rng.integers(1, 8) * 600))
                for _ in range(int(rng.integers(1, 5)))]
        forks.append(_fork(J, free0, run, dead if f % 3 == 2 else []))
    args = _stack(forks, J, limit=0)
    started = _assert_k1(args)
    assert not started.any()
    assert torch.equal(pe.policy_eval_pass_batched(*args)[1], args[5])


def _replay_grids():
    small = workload.stack_scenarios(
        [workload.bursty_trace(24, 16, 4.0 + s, (1, 12), (30.0, 400.0),
                               seed=s) for s in range(4)], 16, max_jobs=64)
    dras = workload.stack_scenarios(
        [workload.poisson_trace(100, 64, 20.0, (1, 11), (300.0, 86400.0),
                                seed=s) for s in range(2)], 64)
    return [(small, parse_pool("extended").spec),
            (dras, parse_pool("extended,wfp:a=1..5x5:tau=600..7200x5").spec)]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [0, 1], ids=["s4p7", "dras_s2p32"])
def test_replay_cuda_matches_reference(grid):
    _card()
    scen, pool = _replay_grids()[grid]
    pe.LAUNCHES = 0
    got = DrainEngine("cuda", device="cuda").replay_grid(scen, pool)
    torch.cuda.synchronize()
    launches = pe.LAUNCHES
    want = DrainEngine("reference", device="cuda").replay_grid(scen, pool)
    torch.cuda.synchronize()
    assert pe.LAUNCHES == launches
    # one launch a host step: whole blocks until the condition is down
    steps = -(-int(got.result.iters) // des.REPLAY_BLOCK) * des.REPLAY_BLOCK
    assert launches == min(steps, 2 * scen.capacity + 2)
    for name in ("start_t", "end_t", "deadlocked", "events", "costs",
                 "best"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("iters", "pass_invocations"):
        assert int(getattr(got.result, name)) == \
            int(getattr(want.result, name)), name
    assert not got.deadlocked.any()


@pytest.mark.cuda
def test_replay_block_does_not_synchronise():
    """The replay's body, K1 included, queues a whole block without
    waiting for the device: ``set_sync_debug_mode("error")`` raises on
    any synchronising call.  The run then ends as ``replay_grid`` does."""
    _card()
    scen, pool = _replay_grids()[1]
    engine = DrainEngine("cuda", device="cuda")
    states, arrival_t, true_rt, pool_t, _ = replay_inputs(scen, pool,
                                                          "cuda")
    plan = engine.plan(pool)
    order_fn = make_order_fn(states, pool_t, plan * 2, torch.isfinite(
        arrival_t))
    step = des.make_replay_step(arrival_t, true_rt, order_fn,
                                engine.pass_fn())
    c = des.replay_init(states)
    for _ in range(des.REPLAY_BLOCK):          # first block: builds, loads
        c = step(c)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(des.REPLAY_BLOCK):
            c = step(c)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    while bool(des.replay_cond(c, arrival_t)):
        c = step(c)
    want = engine.replay_grid(scen, pool)
    assert int(c.it) == int(want.result.iters) > 2 * des.REPLAY_BLOCK
    assert torch.equal(c.st.jobs.start_t, want.result.state.jobs.start_t)
    assert torch.equal(c.events, want.result.events)


@pytest.mark.cuda
@pytest.mark.parametrize("k,J", [(2048, 256), (16384, 128)])
def test_pass_at_fan_fork_counts(k, J):
    """``<<<k, ...>>>`` puts forks on gridDim.x: k = 16,384 is one long
    grid of blocks.  64 distinct random forks tiled to k, each copy's
    order rotated among its queued ranks so copies differ."""
    _card()
    rng = np.random.default_rng(k)
    forks = []
    for _ in range(64):
        n_run = int(rng.integers(0, J // 4))
        n_q = int(rng.integers(0, J - n_run))
        run = [(int(rng.integers(1, 8)), float(rng.integers(1, 6) * 600))
               for _ in range(n_run)]
        q = [(int(rng.integers(1, 8)), float(rng.integers(1, 8) * 600))
             for _ in range(n_q)]
        forks.append(_fork(J, int(rng.integers(0, 40)), run, q))
    tiled = []
    for i in range(k):
        order, *rest = forks[i % 64]
        nq = int((rest[0] == QUEUED).sum())
        if nq:
            shift = (i // 64) % nq
            order = np.concatenate([np.roll(order[:nq], shift),
                                    order[nq:]])
        tiled.append((order, *rest))
    _assert_k1(_stack(tiled, J))
    _assert_k1(_stack(tiled, J, limit=J // 2))


@pytest.mark.cuda
def test_prng_on_the_card_matches_the_cpu():
    from repro_torch.core import fan, prng
    _card()
    s = torch.arange(8).repeat_interleave(64)
    phi = torch.arange(64).repeat(8)
    cpu = fan._member_draws(0, s, phi, 1024)
    gpu = fan._member_draws(0, s.cuda(), phi.cuda(), 1024)
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(0), s), phi)
    gkeys = prng.fold_in(prng.fold_in(prng.PRNGKey(0, device="cuda"),
                                      s.cuda()), phi.cuda())
    assert torch.equal(keys, gkeys.cpu())
    assert torch.equal(prng.bits(keys, (3, 5)), prng.bits(gkeys, (3, 5)).cpu())
    assert torch.equal(prng.split(keys[7], 9), prng.split(gkeys[7], 9).cpu())
    assert torch.equal(prng.normal(keys, (300,)),
                       prng.normal(gkeys, (300,)).cpu())
    x = torch.linspace(-80.0, 80.0, 100_001)
    assert torch.equal(prng.exp_f32(x), prng.exp_f32(x.cuda()).cpu())
    assert torch.equal(fan.lognormal_scale(cpu[0], 0.3),
                       fan.lognormal_scale(gpu[0], 0.3).cpu())
    assert torch.equal(fan._domain_fragility(3, torch.arange(8), 4),
                       fan._domain_fragility(3, torch.arange(8).cuda(),
                                             4).cpu())


def _fan_grid_case():
    from repro_torch.core.fan import FanSpec
    scen = workload.stack_scenarios(
        [workload.bursty_trace(24, 16, 4.0 + s, (1, 12), (30.0, 400.0),
                               seed=s) for s in range(2)], 16, max_jobs=64)
    spec = FanSpec(n=8, runtime_noise=0.3, burst_amplitude=0.2,
                   failure_prob=0.2, failure_domains=2, seed=5)
    return scen, parse_pool("extended").spec, spec


@pytest.mark.cuda
def test_fan_grid_cuda_matches_reference():
    from repro_torch.core.fan import materialize_fan
    _card()
    scen, pool, spec = _fan_grid_case()
    pe.LAUNCHES = 0
    got = DrainEngine("cuda", device="cuda").fan_grid(scen, pool, spec,
                                                      "cvar:0.9:score")
    torch.cuda.synchronize()
    assert pe.LAUNCHES > 0
    launches = pe.LAUNCHES
    ref = DrainEngine("reference", device="cuda")
    want = ref.fan_grid(scen, pool, spec, "cvar:0.9:score")
    assert pe.LAUNCHES == launches
    for name in ("start_t", "end_t", "deadlocked", "events",
                 "member_costs", "costs", "best", "cost_ci", "fan_width"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    mat = ref.replay_grid(materialize_fan(scen, spec, device="cuda"), pool,
                          "avg_wait")
    assert torch.equal(mat.start_t.reshape(got.start_t.shape), got.start_t)
    assert torch.equal(mat.end_t.reshape(got.end_t.shape), got.end_t)


@pytest.mark.cuda
def test_monte_carlo_decisions_cuda_match_reference():
    from repro_torch.core import prng, state as st
    from repro_torch.core.fan import FanSpec
    from repro_torch.core.race import RaceSpec
    _card()
    rng = np.random.default_rng(0)
    snap = st.empty_state(128, 64, device="cpu")
    for j in range(90):
        snap = st.add_job(snap, j, float(j), int(rng.integers(1, 9)),
                          float(rng.integers(1, 20) * 300))
    free = 64
    for j in range(90):
        nd = int(snap.jobs.nodes[j])
        if nd <= free:
            snap = st.start_job(snap, j, float(j))
            free -= nd
    snap = snap._replace(now=torch.tensor(100.0))
    pool = parse_pool("extended,wfp:a=1..3x3").spec
    cuda = DrainEngine("cuda", device="cuda")
    ref = DrainEngine("reference", device="cuda")
    spec = FanSpec(n=16, runtime_noise=0.3, failure_prob=0.1, seed=2)
    calls = {
        "decide_fan": lambda e: e.decide_fan(snap, pool, spec,
                                             "p95:avg_wait"),
        "decide_ensemble": lambda e: e.decide_ensemble(
            snap, pool, prng.PRNGKey(4), 8, 0.3),
        "decide_race": lambda e: e.decide_race(
            snap, pool, RaceSpec(fan=spec, f0=4), "p95:avg_wait")[0],
    }
    for name, call in calls.items():
        pe.LAUNCHES = 0
        got = call(cuda)
        torch.cuda.synchronize()
        assert pe.LAUNCHES > 0, name
        pe.LAUNCHES = 0
        want = call(ref)
        assert pe.LAUNCHES == 0, name
        for f in ("policy_index", "costs", "run_mask", "deadlocked",
                  "cost_ci", "fan_width"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (name, f)
        assert got.fan_size == want.fan_size


@pytest.mark.cuda
def test_sin_on_the_card_matches_the_cpu():
    from repro_torch.core import prng
    _card()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.uniform(-1e5, 1e5, 1 << 20), rng.uniform(110.0, 130.0, 1 << 16),
        rng.uniform(-1.0, 1.0, 1 << 16)]).astype(np.float32))
    got = prng.sin_f32(x.cuda()).cpu()
    assert torch.equal(got.view(torch.int32), prng.sin_f32(x).view(
        torch.int32))


def _learn_split():
    return workload.split_scenarios(
        np.random.default_rng(3),
        lambda r: workload.poisson_trace(48, 32, 20.0, (1, 12),
                                         (60.0, 1800.0), rng=r), 3, 2, 32)


@pytest.mark.cuda
def test_generation_costs_cuda_match_reference():
    from repro_torch.core.policies import FAM_WFP, theta_pool
    from repro_torch.learn import family_space
    from repro_torch.learn.strategy import draw_eps
    _card()
    train_scen, _ = _learn_split()
    thetas = family_space("wfp").decode(draw_eps(0, 0, 16, 3, True))
    pool = theta_pool(FAM_WFP, thetas).spec
    pe.LAUNCHES = 0
    got = DrainEngine("cuda", device="cuda").generation_costs(
        train_scen, pool, "score")
    torch.cuda.synchronize()
    assert pe.LAUNCHES > 0
    want = DrainEngine("reference", device="cuda").generation_costs(
        train_scen, pool, "score")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_train_resume_on_the_card(tmp_path):
    import dataclasses
    from repro_torch.learn import TrainConfig, load_trained_pool, train
    _card()
    split = _learn_split()
    cfg = TrainConfig(family="wfp", strategy="cem", population=8,
                      generations=3, objective="score", seed=1, patience=0)
    eng = DrainEngine("cuda", device="cuda")
    pe.LAUNCHES = 0
    full = train(*split, cfg, engine=eng,
                 checkpoint_dir=str(tmp_path / "full"))
    assert pe.LAUNCHES > 0
    part = str(tmp_path / "part")
    train(*split, dataclasses.replace(cfg, generations=2), engine=eng,
          checkpoint_dir=part)
    resumed = train(*split, cfg, engine=eng, checkpoint_dir=part,
                    resume=True)
    assert np.array_equal(full.theta, resumed.theta)
    assert full.history == resumed.history
    assert full.best_heldout == resumed.best_heldout
    assert torch.equal(load_trained_pool(part).spec.theta,
                       load_trained_pool(str(tmp_path / "full")).spec.theta)


@pytest.mark.cuda
def test_twin_snapshot_restore_on_the_card(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.cluster.emulator import ClusterEmulator
    from repro_torch.core.events import EventBus
    from repro_torch.core.twin import SchedTwin
    _card()
    trace = workload.poisson_trace(40, 32, 6.0, (1, 16), (30.0, 900.0),
                                   seed=4)
    eng = DrainEngine("cuda", device="cuda")

    def make_twin(bus, em):
        return SchedTwin(bus=bus, qrun=em.qrun, total_nodes=32,
                         max_jobs=em.max_jobs, pool="extended",
                         free_nodes_probe=lambda: em.free_nodes,
                         jobs_probe=em.jobs_view, engine=eng, ensemble=4,
                         seed=2)

    def build():
        bus = EventBus()
        em = ClusterEmulator(trace, 32, bus=bus, engine=eng)
        return bus, em, make_twin(bus, em)

    def decisions(twin):
        return [(c.time, c.policy, c.started_jobs)
                for c in twin.telemetry.cycles]

    _, em, twin = build()
    em.run(on_event=twin.pump, on_quiesce=twin.flush)
    ref = decisions(twin)
    bus, em, twin = build()
    mgr = CheckpointManager(str(tmp_path))
    holder = {"twin": twin}

    def pump():
        t = holder["twin"]
        t.pump()
        if t is twin and len(t.telemetry.cycles) >= 4:
            t.snapshot(mgr)
            holder["twin"] = make_twin(bus, em)
            holder["twin"].restore(mgr)

    em.run(on_event=pump, on_quiesce=lambda: holder["twin"].flush())
    assert holder["twin"] is not twin
    assert decisions(holder["twin"]) == ref


def _fleet_grid():
    return workload.stack_scenarios(
        [workload.bursty_trace(24, 16, 4.0 + s, (1, 12), (30.0, 400.0),
                               seed=s) for s in range(5)], 16, max_jobs=64)


@pytest.mark.cuda
@pytest.mark.parametrize("devices,block", [(("cuda:0",), 2),
                                           (("cuda:0",), 3),
                                           (("cuda:0", "cuda:0"), 2)],
                         ids=["b2", "b3", "two_shards_b2"])
def test_fleet_stream_matches_one_shot_on_the_card(devices, block):
    _card()
    scen = _fleet_grid()
    pool = parse_pool("extended,wfp:a=1..3x3").spec
    engine = DrainEngine("cuda", device="cuda")
    want = engine.replay_grid(scen, pool)
    pe.LAUNCHES = 0
    got = sharded_replay_grid(FleetMesh(devices), engine=engine,
                              block_size=block)(scen, pool)
    torch.cuda.synchronize()
    assert pe.LAUNCHES > 0
    for name in ("start_t", "end_t", "deadlocked", "events", "costs",
                 "best"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name, x in got.metrics._asdict().items():
        assert torch.equal(x, getattr(want.metrics, name)), name


@pytest.mark.cuda
def test_fleet_whatif_and_fan_on_two_shards_of_the_card():
    _card()
    from repro_torch.core.state import empty_state
    from repro_torch.core import sync
    from repro_torch.core.events import Event, EventKind
    engine = DrainEngine("cuda", device="cuda")
    mesh = FleetMesh(["cuda:0", "cuda:0"])
    st = empty_state(64, 16, device="cpu")
    for j in workload.poisson_trace(40, 16, 5.0, (1, 12), (60.0, 900.0),
                                    seed=3):
        st, _ = sync.apply_event(st, Event(
            EventKind.QUEUEJOB, j.submit_t, j.job_id,
            {"nodes": float(j.nodes), "est_runtime": float(j.est_runtime)}))
    pool = parse_pool("extended,wfp:a=1..3x3")     # k=10
    pe.LAUNCHES = 0
    got = sharded_whatif(mesh, engine=engine)(st, pool)
    assert pe.LAUNCHES > 0
    want = engine.decide(st, pool.spec)
    for name in ("policy_index", "costs", "run_mask", "deadlocked"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    scen = workload.stack_scenarios(
        [workload.poisson_trace(20, 16, 6.0, (1, 12), (30.0, 400.0),
                                seed=s) for s in range(2)], 16)
    spec = FanSpec(n=4, runtime_noise=0.3, failure_prob=0.2)
    want = engine.fan_grid(scen, pool.spec, spec, "cvar:0.9:score")
    pe.LAUNCHES = 0
    got = sharded_fan_grid(mesh, engine=engine, objective="cvar:0.9:score",
                           fan=spec, block_size=6)(scen, pool)
    assert pe.LAUNCHES > 0
    for name in ("start_t", "end_t", "deadlocked", "events",
                 "member_costs", "costs", "best", "cost_ci", "fan_width"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_fleet_stream_reads_only_in_the_replay_loop(monkeypatch):
    _card()
    scen = _fleet_grid()
    pool = parse_pool("extended,wfp:a=1..3x3").spec
    run = sharded_replay_grid(FleetMesh(["cuda:0", "cuda:0"]),
                              engine=DrainEngine("cuda", device="cuda"),
                              block_size=2, prefetch_depth=2)
    run(scen, pool)                              # loads K1
    torch.cuda.synchronize()
    reads = []
    cond = des.replay_cond
    monkeypatch.setattr(des, "replay_cond",
                        lambda c, a: (reads.append(1), cond(c, a))[1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run(scen, pool)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == len(reads) > 0
    assert int(out.result.iters) > 0


@pytest.mark.cuda
def test_make_fleet_mesh_on_the_card():
    _card()
    n = torch.cuda.device_count()
    mesh = make_fleet_mesh()
    assert mesh.shape == {"data": n, "model": 1}
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(n))
    assert make_fleet_mesh(1).devices == (torch.device("cuda", 0),)
    for bad in (0, n + 1):
        with pytest.raises(ValueError, match="outside"):
            make_fleet_mesh(bad)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetMesh([f"cuda:{n}"])
    assert FleetMesh(["cuda", "cuda"]).devices == (
        torch.device("cuda", torch.cuda.current_device()),) * 2


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(1500, 1500), (448, 1500)],
                         ids=["encoder", "cross"])
def test_flash_attention_whisper_shapes(sq, sk):
    """q at three times unit scale peaks the softmax, so outputs are O(1)
    and the limit can see a single missing key (at unit scale over 1,500
    keys the mean |o| is ~0.03, the size of the limit itself)."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = _bf16_views(gen, 1, sq, 12, 64)
    q = (3.0 * q.float()).to(torch.bfloat16)
    k = _bf16_views(gen, 1, sk, 12, 64)
    v = _bf16_views(gen, 1, sk, 12, 64)
    got = fa.flash_attention(q, k, v, causal=False)
    want = full_attention(q, k, v, causal=False)
    short = full_attention(q, k[:, :, :-1], v[:, :, :-1], causal=False)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(short.float(), want.float(), atol=3e-2,
                                   rtol=3e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)


def _smoke(arch, head_dim=16, **moe):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch, head_dim=head_dim)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["gather", "gshard"])
def test_moe_dispatch_on_the_card_matches_the_cpu(dispatch, monkeypatch):
    _card()
    from repro_torch.device import resolve_device
    from repro_torch.models import blocks_moe as bm
    from repro_torch.models.common import init_params
    resolve_device("cuda")            # no TF32
    monkeypatch.setattr(bm, "MOE_CHUNK", 16)
    cfg = _smoke("olmoe-1b-7b", dispatch=dispatch)
    params = init_params(bm.moe_table(cfg), torch.Generator().manual_seed(0),
                         torch.float32)
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    for n_tok in (32, 48, 42):        # two chunks, three, ragged
        xs = x.reshape(-1, cfg.d_model)[:n_tok].reshape(1, n_tok, -1)
        want, waux = bm.moe_apply(cfg, params, xs)
        got, aux = bm.moe_apply(cfg, {k: v.cuda() for k, v in params.items()},
                                xs.cuda())
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)
        assert float(aux["moe_dropped"]) == float(waux["moe_dropped"])
        for key in ("moe_aux", "moe_z"):
            torch.testing.assert_close(aux[key].cpu(), waux[key], atol=1e-5,
                                       rtol=1e-4)


@pytest.mark.cuda
def test_mla_decode_on_the_card():
    _card()
    from repro_torch.models import api
    cfg = _smoke("deepseek-v2-lite-16b", capacity_factor=4.0)
    b, s = 2, 40
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1),
                         generator=torch.Generator().manual_seed(2))
    cpu_model = api.init_model(cfg, seed=0, dtype=torch.float32,
                               device="cpu")
    cuda_model = api.init_model(cfg, seed=0, dtype=torch.float32,
                                device="cuda")
    cuda_model.load_state_dict(cpu_model.state_dict())
    got = {}
    for dev, model in (("cpu", cpu_model), ("cuda", cuda_model)):
        t = toks.to(dev)
        with torch.inference_mode():
            want, _ = api.prefill(cfg, model, {"tokens": t})
            _, caches = api.prefill(cfg, model, {"tokens": t[:, :s]})
            full = api.init_caches(cfg, b, s + 1, device=dev)
            for key, layer in full.items():
                for name, big in layer.items():
                    small = caches[key][name]
                    big[tuple(slice(0, n) for n in small.shape)] = small
            step, _ = api.decode_step(cfg, model, full,
                                      {"tokens": t[:, s:], "index": s})
        torch.testing.assert_close(step.cpu(), want.cpu(), atol=3e-2,
                                   rtol=3e-2)
        got[dev] = step.cpu()
    torch.testing.assert_close(got["cuda"], got["cpu"], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,per_prefill", [("whisper-small", 6),
                                              ("olmoe-1b-7b", 2)])
def test_family_prefill_through_k4(arch, per_prefill):
    _card()
    from repro_torch.models import api
    from repro_torch.serve.engine import prefill_batch
    cfg = _smoke(arch, head_dim=32)       # K4 takes head dims 32-256
    model = api.init_model(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, 37),
                         generator=torch.Generator().manual_seed(3)).cuda()
    batch = prefill_batch(cfg, toks)
    with torch.inference_mode():
        fa.LAUNCHES = 0
        got, _ = api.prefill(cfg, model, batch, "cuda")
        assert fa.LAUNCHES == per_prefill
        want, _ = api.prefill(cfg, model, batch, "reference")
        assert fa.LAUNCHES == per_prefill
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)

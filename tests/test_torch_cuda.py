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
* A block of ``des.REPLAY_BLOCK`` replay steps (K1 and the order kernel)
  under ``torch.cuda.set_sync_debug_mode("error")``: no step waits for
  the device.
* The replay under a CUDA ``torch.profiler``: its spans and phases
  (``core.telemetry``) are host ranges, on no device event, and the
  grid is bitwise an unprofiled one's; so are a fan decision's
  ``decision``, ``drain`` and ``drain.read``, and its outcome.
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
* A train step (f32, TF32 off) of llama3.2-1b, olmoe-1b-7b, rwkv6-7b,
  recurrentgemma-2b and whisper-small at smoke size on the card against
  the CPU from the same initial weights: loss and grad norm within rtol
  1e-5, moments within 1e-4 of their tensor's max |x|, parameters
  within 1e-4 of max |p| where |g| >= 1e-3 max |g| and within 2·lr
  anywhere (AdamW's first step, lr·g/(|g| + eps), magnifies last-bit
  gradient differences where |g| is near eps).  The kernel wrappers
  (K2's two entries, K3, K4) refuse CUDA inputs that require a gradient
  under grad mode, before any launch, and run them under
  ``torch.no_grad()``.
* The order kernel (``kernels.priority_order``) against its plain
  version (``priority_order_plain``), each run as ``engine.OrderStage``
  on CUDA tensors: at the Polaris drain's shape (8,192 forks, J = 1,024)
  and a farm-shaped batch (49,152 forks interleaved s·P + p, J = 256),
  every test pool (the Polaris sweep, the paper's, integer ids, random
  θ) at J from 8 to ``MAX_J`` under hoist plans None, partial and
  all-static, and forks planted with -0.0/+0.0 ties, ±inf and NaN keys
  (with ``torch.argsort(stable=True)``'s order of such a row pinned):
  bitwise, one ``LAUNCHES`` a call.  Its keys equal
  ``priority_key_spec`` (and integer ids the id stack's) bitwise (C3).
  On ``cuda`` the drain and the replay launch it once a step, as K1, on
  ``reference`` never; a Polaris-size ``decide_fan`` gives the reference
  backend's winner, costs and ``run_mask``; J > ``MAX_J`` raises.
* The step kernel (``kernels.drain_step``) against its plain version
  (``drain_step_plain``) on copies of the same arguments, every tensor
  either writes compared by its bits: random forks in every layout (a
  warp a fork at J <= 256, 64 to 512 threads a fork above; J of 32 to
  4,096, J not a multiple of 32, k = 1), the inputs of the first, middle
  and last iterations of a Polaris fan drain (8,192 forks, J = 1,024),
  and planted forks (ties at the next end, stale ends, deadlocks, dead
  and drained forks, no running job, a NaN end).  A Polaris fan drain
  on ``cuda`` gives ``reference``'s started sets, times, states,
  ``iters``, deadlocks, winner, costs and ``run_mask``; the kernel
  launches once a drain iteration, never in a replay, never on
  ``reference``; J > ``MAX_J`` and wrong dtypes raise before a launch.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.cluster import workload
from repro_torch.core import des
from repro_torch.core.engine import DrainEngine, OrderStage, replay_inputs
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
    """The replay's body, K1 and the order kernel included, queues a
    whole block without waiting for the device:
    ``set_sync_debug_mode("error")`` raises on any synchronising call.
    The run then ends as ``replay_grid`` does."""
    _card()
    scen, pool = _replay_grids()[1]
    engine = DrainEngine("cuda", device="cuda")
    states, arrival_t, true_rt, pool_t, _ = replay_inputs(scen, pool,
                                                          "cuda")
    plan = engine.plan(pool)
    order_fn = engine.order_fn(states, pool_t, plan * 2,
                               torch.isfinite(arrival_t))
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
def test_replay_ranges_stay_on_the_host():
    """A reader of the device trace counts every device event as work,
    so the replay's ranges must not land there."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    scen, pool = _replay_grids()[0]
    engine = DrainEngine("cuda", device="cuda")
    want = engine.replay_grid(scen, pool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = engine.replay_grid(scen, pool)
        torch.cuda.synchronize()
    ranges = {"grid", "replay", "replay.read", "replay.event",
              "replay.apply", "replay.order", "replay.pass",
              "replay.starts"}
    cuda = torch.autograd.DeviceType.CUDA
    dev = {e.name for e in prof.events() if e.device_type == cuda}
    host = {e.name for e in prof.events() if e.device_type != cuda}
    assert ranges <= host and not ranges & dev
    assert any("pass_kernel" in n for n in dev)
    for name in ("start_t", "end_t", "deadlocked", "events", "costs",
                 "best"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_decision_ranges_stay_on_the_host():
    """The same for the twin's decision and its drain: ``decision``,
    ``drain`` and ``drain.read`` are host ranges only, and a profiled
    decision is the unprofiled one."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.events import Event, EventBus, EventKind
    from repro_torch.core.twin import SchedTwin
    trace = workload.poisson_trace(60, 32, 6.0, (1, 16), (30.0, 900.0),
                                   seed=4)
    engine = DrainEngine("cuda", device="cuda")

    def decide():
        twin = SchedTwin(bus=EventBus(), qrun=lambda jobs, t: None,
                         total_nodes=32, max_jobs=64, pool="extended",
                         engine=engine, device="cuda",
                         objective="cvar:0.75:score",
                         fan=FanSpec(n=8, runtime_noise=0.3,
                                     failure_prob=0.2, seed=3))
        for j in trace:
            twin.bus.publish(Event(EventKind.QUEUEJOB, j.submit_t, j.job_id,
                                   {"nodes": float(j.nodes),
                                    "est_runtime": float(j.est_runtime)}))
        twin.pump()
        c = twin.telemetry.cycles[-1]
        return c.policy, c.costs, c.started_jobs, c.cost_ci, c.fan_width

    want = decide()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = decide()
        torch.cuda.synchronize()
    ranges = {"decision", "drain", "drain.read"}
    cuda = torch.autograd.DeviceType.CUDA
    dev = {e.name for e in prof.events() if e.device_type == cuda}
    host = {e.name for e in prof.events() if e.device_type != cuda}
    assert ranges <= host and not ranges & dev
    assert any("pass_kernel" in n for n in dev)
    assert got == want


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
    params = init_params(0, bm.moe_table(cfg), torch.float32, "cpu")
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b", "rwkv6-7b",
                                  "recurrentgemma-2b", "whisper-small"])
def test_train_step_on_the_card_matches_the_cpu(arch):
    """One train step (f32, TF32 off) from the same initial weights on
    the card and on the CPU: loss and grad norm within rtol 1e-5, the
    moments within 1e-4 of their tensor's max |x|, the parameters within
    1e-4 of max |p| where |g| >= 1e-3 of its tensor's max |g| (below,
    AdamW's first step magnifies last-bit gradient differences) and
    within 2·lr anywhere."""
    _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import api
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train.optimizer import lr_at
    from repro_torch.train.train_step import batch_on
    cfg = get_smoke_config(arch)
    opt = OptimizerConfig(peak_lr=3e-3, warmup_steps=1, total_steps=8)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=1)).batch(0)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((4, 32, cfg.d_model))
    out = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(0, cfg, dtype=torch.float32, device=dev)
        if dev == "cpu":
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in state.params.items()}
            loss, _ = api.train_loss(cfg, leaves,
                                     batch_on(batch, torch.device("cpu")))
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        step = make_train_step(cfg, opt, accum_steps=1, device=dev)
        out[dev] = step(state, batch)
    (sc, mc), (sg, mg) = out["cpu"], out["cuda"]
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=0)
    lr = float(lr_at(opt, torch.tensor(1)))
    for what, a, b in (("params", sg.params, sc.params),
                       ("mu", sg.opt.mu, sc.opt.mu),
                       ("nu", sg.opt.nu, sc.opt.nu)):
        for k in b:
            scale = float(b[k].abs().max()) or 1.0
            d = (a[k].detach().cpu() - b[k].detach()).abs()
            if what == "params":
                assert float(d.max()) <= 2 * lr, (k, float(d.max()))
                d = d[grads[k].abs() >= 1e-3 * grads[k].abs().max()]
            assert float(d.max()) <= 1e-4 * scale, (what, k, float(d.max()),
                                                    scale)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_autograd_on_the_card():
    _card()
    q = torch.zeros((1, 2, 64, 64), device="cuda", requires_grad=True)
    a = torch.zeros((1, 16, 64), device="cuda", requires_grad=True)
    g = torch.zeros((1, 16, 64), device="cuda")
    b = torch.zeros((64,), device="cuda")
    r = torch.zeros((1, 16, 2, 64), device="cuda", requires_grad=True)
    calls = {
        "flash_attention": lambda: fa.flash_attention(q, q, q),
        "rglru": lambda: rg.rglru(a, g, torch.zeros((1, 64), device="cuda")),
        "rglru_gated": lambda: rg.rglru_gated(a, g, g, g, b, b, b),
        "wkv6": lambda: wk.wkv6(r, r, r, r,
                                torch.zeros((2, 64), device="cuda")),
    }
    for name, call in calls.items():
        before = (fa.LAUNCHES, rg.LAUNCHES, wk.LAUNCHES)
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert (fa.LAUNCHES, rg.LAUNCHES, wk.LAUNCHES) == before, name
        with torch.no_grad():
            call()


# ---- the order kernel (kernels.priority_order) --------------------------
def _order_states(k, J, frac_q, seed, planted=False):
    """k forks of J slots on the card: a share ``frac_q`` of the slots
    queued, submits around each fork's clock, estimates below the 1 s
    floor; ``planted``: submits on a 600 s grid, so keys repeat."""
    from repro_torch.core.state import JobTable, SimState
    rng = np.random.default_rng(seed)
    state = rng.choice(4, size=(k, J), p=[0.05, frac_q, 0.25,
                                          0.7 - frac_q]).astype(np.int32)
    now = rng.uniform(0.0, 2e4, size=k).astype(np.float32)
    if planted:
        submit = now[:, None] - rng.integers(-2, 4, size=(k, J)) * 600.0
    else:
        submit = now[:, None] - rng.uniform(-100.0, 5e3, size=(k, J))
    est = rng.choice([0.5, 300.0, 3600.0, 86400.0], size=(k, J))
    nodes = rng.integers(1, 496, size=(k, J)).astype(np.int32)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt,  # noqa: E731
                                                 device="cuda")
    jobs = JobTable(submit_t=t(submit), nodes=t(nodes, torch.int32),
                    est_runtime=t(est), start_t=t(submit), end_t=t(submit),
                    state=t(state, torch.int32))
    free = torch.full((k,), 560, dtype=torch.int32, device="cuda")
    return SimState(jobs=jobs, free_nodes=free, total_nodes=free.clone(),
                    now=t(now))


def _order_pools():
    """The Polaris sweep, the paper's pool, integer ids and random θ of
    every family (exponents off {1, 2, 3}, τ = inf on one row)."""
    import sys
    sys.path.insert(0, "tests")
    from test_torch_order import _random_pool
    from repro_torch.core.policies import EXTENDED_POOL
    return {"polaris": parse_pool(DRAS).spec,
            "paper": parse_pool("paper").spec,
            "ids": torch.tensor(EXTENDED_POOL, dtype=torch.int32),
            "random_theta": _random_pool(11)}


DRAS = "extended,wfp:a=1..5x5:tau=600..7200x5"


def _assert_order_stage(pool, states, plans):
    """The kernel's order (one launch a call) against its plain
    version's on every state, under every hoist plan: bitwise."""
    from repro_torch.core.state import QUEUED as Q
    from repro_torch.kernels import priority_order as po
    s0 = states[0]
    ever = s0.jobs.state == Q
    for plan in plans:
        want_fn = OrderStage(s0, pool, plan, ever, po.priority_order_plain)
        got_fn = OrderStage(s0, pool, plan, ever, po.priority_order)
        for st in states:
            launches = po.LAUNCHES
            got = got_fn(st)
            assert po.LAUNCHES == launches + 1
            want = want_fn(st)
            torch.cuda.synchronize()
            assert torch.equal(got, want), plan


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["polaris", "farm"])
def test_order_kernel_matches_plain_stage(shape):
    """At the Polaris drain's shape (the k=32 sweep x 256 futures = 8,192
    forks, J = 1,024) and a farm-shaped batch (the paper's pool x 16,384
    scenarios, interleaved s·P + p, J = 256), over queued shares from 0.65
    to 0.05: the kernel's order is the plain stage's, hoisted and not."""
    from repro_torch.core.engine import tile_pool
    _card()
    if shape == "polaris":
        pool, S, J, fracs = parse_pool(DRAS).spec, 256, 1024, (0.65, 0.2,
                                                                0.05)
    else:
        pool, S, J, fracs = parse_pool("paper").spec, 16384, 256, (0.1,
                                                                    0.4)
    pool = tile_pool(pool, S).to("cuda")
    k = pool.family.shape[0]
    engine = DrainEngine("cuda", device="cuda")
    states = [_order_states(k, J, f, seed=i, planted=i % 2 == 1)
              for i, f in enumerate(fracs)]
    _assert_order_stage(pool, states, (engine.plan(pool), None))


@pytest.mark.cuda
@pytest.mark.parametrize("J", [8, 150, 256, 1024, 4096])
def test_order_kernel_small_pools_every_plan(J):
    """Every test pool at J from 8 to the kernel's largest (sorts above
    1,024 words pass through shared memory), hoist plans None, partial
    and all-static."""
    from repro_torch.core.engine import tile_pool
    from repro_torch.core.policies import time_invariant_mask
    _card()
    for name, pool in _order_pools().items():
        pool = tile_pool(pool, 3)
        k = pool.shape[0] if isinstance(pool, torch.Tensor) else \
            pool.family.shape[0]
        mask = time_invariant_mask(pool)
        partial = tuple(bool(b) for b in mask) if mask.any() else \
            tuple(i % 2 == 0 for i in range(k))
        states = [_order_states(k, J, f, seed=J + i, planted=i == 1)
                  for i, f in enumerate((0.6, 0.3, 0.0))]
        _assert_order_stage(pool.to("cuda"), states,
                            (None, partial, (True,) * k))


@pytest.mark.cuda
@pytest.mark.parametrize("J", [8, 150, 256, 1024])
def test_order_kernel_planted_keys(J):
    """-0.0 ties +0.0, -inf first, +inf after every finite key (and tied
    with the slots that are not queued), NaN last, ties in slot order:
    ``torch.argsort(stable=True)``'s order on the card, pinned here on a
    raw row, and the kernel's on forks planted with such keys."""
    import sys
    sys.path.insert(0, "tests")
    from test_torch_order import _planted
    _card()
    nan, inf = float("nan"), float("inf")
    row = torch.tensor([0.0, -0.0, inf, -inf, nan, 1.0, -0.0, inf, nan,
                        -1.0], device="cuda")
    row = row.repeat(J // 10 + 1)[:J] if J >= 10 else row[:J]
    got = torch.argsort(row, stable=True).cpu()
    assert torch.equal(got, torch.argsort(row.cpu(), stable=True))
    pool, st = _planted(J)
    _assert_order_stage(pool.to("cuda"), [st.to("cuda")],
                        (None, (False, True, False, True, False)))


@pytest.mark.cuda
def test_order_kernel_keys_match_torch():
    """C3: the kernel's keys (its ``priority_keys`` entry) equal
    ``policies.priority_key_spec`` run as torch's CUDA ops, bitwise, over
    the Polaris sweep (exponents 1 to 5, τ = inf and finite), random θ
    and planted rows; integer ids lifted to their rows equal
    ``policies.priority_key``'s id stack (its EXPF row divides by a host
    scalar, which torch runs as a reciprocal product on the card)."""
    import sys
    sys.path.insert(0, "tests")
    from test_torch_order import _planted
    from repro_torch.core import policies
    from repro_torch.core.engine import tile_pool
    from repro_torch.core.state import QUEUED as Q
    from repro_torch.kernels import priority_order as po
    _card()
    cases = []
    for name, pool in _order_pools().items():
        pool = tile_pool(pool, 8).to("cuda")
        k = pool.shape[0] if isinstance(pool, torch.Tensor) else \
            pool.family.shape[0]
        for i in range(2):
            cases.append((name, pool, _order_states(k, 1024, 0.5, seed=i,
                                                    planted=i == 1)))
    pool, st = _planted(256)
    cases.append(("planted", pool.to("cuda"), st.to("cuda")))
    for name, pool, st in cases:
        jobs = st.jobs
        got = po.priority_keys(jobs.state, jobs.submit_t, jobs.est_runtime,
                               jobs.nodes, st.now,
                               *po.pool_rows(pool, st.now.device))
        if isinstance(pool, torch.Tensor):
            want = policies.priority_key(jobs, st.now, pool.long())
        else:
            want = policies.priority_key_spec(jobs, st.now, pool)
        want = torch.where(jobs.state == Q, want, torch.inf)
        torch.cuda.synchronize()
        same = (got == want) | (got.isnan() & want.isnan())
        assert bool(same.all()), (name, int((~same).sum()))


@pytest.mark.cuda
def test_order_kernel_counts_one_launch_a_step():
    """On ``cuda`` the drain and the replay launch the order kernel once
    a step (``drain.steps``, ``replay.steps``), as K1; on ``reference``
    neither launches."""
    from repro_torch.core import telemetry
    from repro_torch.kernels import priority_order as po
    _card()
    scen, pool = _replay_grids()[1]
    snapshot = chip_smoke_snapshot()
    for backend in ("cuda", "reference"):
        engine = DrainEngine(backend, device="cuda")
        before = (pe.LAUNCHES, po.LAUNCHES)
        engine.decide(snapshot, pool)
        torch.cuda.synchronize()
        n = telemetry.SPANS.roots[-1].counts()
        k1, order = pe.LAUNCHES - before[0], po.LAUNCHES - before[1]
        want = n["drain.steps"] if backend == "cuda" else 0
        assert k1 == order == want
        before = (pe.LAUNCHES, po.LAUNCHES)
        engine.replay_grid(scen, pool)
        torch.cuda.synchronize()
        n = telemetry.SPANS.roots[-1].counts()
        k1, order = pe.LAUNCHES - before[0], po.LAUNCHES - before[1]
        want = n["replay.steps"] if backend == "cuda" else 0
        assert k1 == order == want


def chip_smoke_snapshot():
    """The Polaris mirror of ``chip_smoke.py`` (560 nodes, 1,024 slots,
    ~100 running and ~600 queued jobs)."""
    import chip_smoke
    return chip_smoke.polaris_snapshot(None)


@pytest.mark.cuda
def test_polaris_fan_decision_cuda_matches_reference():
    """A Polaris-size fan decision (the k=32 sweep x 16 futures with noise
    and failures, J = 1,024; the reference pass's (k, J, J) shadow
    tables do not fit the card at the cell's 256 futures), after the
    three running jobs due first have ended so that some job starts: the
    ``cuda`` backend (K1 and the order kernel) returns the ``reference``
    backend's winner, costs and a non-empty ``run_mask``."""
    from repro_torch.core import sync
    from repro_torch.core.events import Event, EventKind
    _card()
    snapshot = chip_smoke_snapshot()
    jobs = snapshot.jobs
    running = (jobs.state == 2).nonzero().flatten().tolist()
    running.sort(key=lambda j: float(jobs.end_t[j]))
    for j in running[:3]:
        snapshot, _ = sync.apply_event(snapshot, Event(
            EventKind.JOBOBIT, max(float(jobs.end_t[j]),
                                   float(snapshot.now)), j))
    pool = parse_pool(DRAS).spec
    fan = FanSpec(n=16, runtime_noise=0.3, failure_prob=0.1,
                  failure_frac=0.1, seed=7)
    got = DrainEngine("cuda", device="cuda").decide_fan(
        snapshot, pool, fan, "cvar:0.9:score")
    want = DrainEngine("reference", device="cuda").decide_fan(
        snapshot, pool, fan, "cvar:0.9:score")
    torch.cuda.synchronize()
    assert int(got.policy_index) == int(want.policy_index)
    assert torch.equal(got.costs, want.costs)
    assert bool(got.run_mask.any())
    assert torch.equal(got.run_mask, want.run_mask)


@pytest.mark.cuda
def test_order_kernel_refuses_tables_past_max_j():
    from repro_torch.kernels import priority_order as po
    _card()
    pool = parse_pool("paper").spec.to("cuda")
    st = _order_states(3, po.MAX_J + 1, 0.5, seed=0)
    stage = OrderStage(st, pool, None, st.jobs.state == 1, po.priority_order)
    launches = po.LAUNCHES
    with pytest.raises(ValueError, match="MAX_J"):
        stage(st)
    assert po.LAUNCHES == launches


# ---- the step kernel (kernels.drain_step) --------------------------------
def _step_inputs(k, J, seed, queued=0.3, running=0.3, device="cuda"):
    """A drain step's arguments on the card: k forks of J slots, the
    pass's starts among the queued slots (and on forks that are not
    active, which the step must clear), running jobs whose ends lie on a
    60 s grid (ties at the next end) and some before the clock (stale),
    dead forks and drained ones; ``active`` as the loop keeps it."""
    from repro_torch.core.state import QUEUED as Q
    from repro_torch.core.state import JobTable, SimState
    rng = np.random.default_rng(seed)
    rest = 1.0 - queued - running
    state = rng.choice(4, size=(k, J), p=[rest / 2, queued, running,
                                          rest / 2]).astype(np.int32)
    drained = rng.random(k) < 0.1
    state[drained] = np.where(state[drained] == Q, 3, state[drained])
    now = (rng.integers(10, 1000, size=k) * 60.0).astype(np.float32)
    est = rng.choice([0.0, 0.5, 300.0, 3600.0, 86400.0],
                     size=(k, J)).astype(np.float32)
    end = (now[:, None] + rng.integers(-10, 240, size=(k, J)) * 60.0
           ).astype(np.float32)
    nodes = rng.integers(1, 496, size=(k, J)).astype(np.int32)
    started = (state == Q) & (rng.random((k, J)) < 0.2)
    dead = rng.random(k) < 0.1
    active = ~dead & (state == Q).any(1)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt,  # noqa: E731
                                                 device=device)
    i32 = torch.int32
    jobs = JobTable(submit_t=t(end - 2 * est), nodes=t(nodes, i32),
                    est_runtime=t(est), start_t=t(end - est),
                    end_t=t(end), state=t(state, i32))
    free = t(rng.integers(0, 560, size=k), i32)
    st = SimState(jobs=jobs, free_nodes=free, total_nodes=free.clone(),
                  now=t(now))
    return (st, t(started, torch.bool), t(active, torch.bool),
            t(dead, torch.bool), t(rng.integers(0, 99, size=k), i32),
            t([int(rng.integers(0, J))], i32))


def _planted_step(J, device="cuda"):
    """One fork a planted case, padded to J slots with empty ones: three
    ends tied at the next end, one of them a start's; ends before the
    clock; a queued job larger than the cluster and nothing running (a
    deadlock); a dead fork with a start to clear, and a drained one; no
    running job, its queued jobs starting (one of 0 s, which ends at
    once); a start whose end is NaN (dead); the last queued job starting
    beside an end at +inf (the fork drains); a queued job that does not
    fit the free nodes, nothing running (a deadlock)."""
    from repro_torch.core.state import DONE, INVALID, QUEUED, RUNNING
    from repro_torch.core.state import JobTable, SimState
    inf, nan = float("inf"), float("nan")
    # (state, nodes, est, end, started) per job; now, free, dead per fork
    forks = [
        ([(RUNNING, 4, 600.0, 1600.0, 0), (RUNNING, 8, 900.0, 1600.0, 0),
          (RUNNING, 2, 100.0, 2000.0, 0), (QUEUED, 50, 60.0, -1.0, 0),
          (QUEUED, 1, 600.0, -1.0, 1)], 1000.0, 10, False),
        ([(RUNNING, 4, 600.0, 900.0, 0), (RUNNING, 3, 60.0, 400.0, 0),
          (RUNNING, 5, 60.0, 1200.0, 0), (QUEUED, 40, 60.0, -1.0, 0)],
         1000.0, 0, False),
        ([(QUEUED, 600, 3600.0, -1.0, 0), (DONE, 4, 60.0, 50.0, 0)],
         1000.0, 560, False),
        ([(QUEUED, 600, 3600.0, -1.0, 1), (RUNNING, 4, 60.0, 2000.0, 0)],
         1000.0, 556, True),
        ([(DONE, 4, 60.0, 50.0, 0), (RUNNING, 4, 60.0, 2000.0, 0)],
         1000.0, 556, False),
        ([(QUEUED, 10, 0.0, -1.0, 1), (QUEUED, 20, 300.0, -1.0, 1),
          (QUEUED, 600, 60.0, -1.0, 0)], 1000.0, 560, False),
        ([(QUEUED, 10, nan, -1.0, 1), (QUEUED, 20, 300.0, -1.0, 0)],
         1000.0, 560, False),
        ([(QUEUED, 10, 300.0, -1.0, 1), (RUNNING, 5, 60.0, inf, 0)],
         1000.0, 20, False),
        ([(QUEUED, 10, 300.0, -1.0, 0), (INVALID, 0, 0.0, -1.0, 0)],
         1000.0, 5, False),
    ]
    k = len(forks)
    f32 = np.zeros((4, k, J), np.float32)          # est, end, start, submit
    i32 = np.zeros((2, k, J), np.int32)            # state, nodes
    started = np.zeros((k, J), bool)
    now = np.zeros(k, np.float32)
    free = np.zeros(k, np.int32)
    dead = np.zeros(k, bool)
    f32[1:] = -1.0
    for f, (jobs, t_now, n_free, is_dead) in enumerate(forks):
        for j, (code, n, e, end, go) in enumerate(jobs):
            slot = (j * 97) % J if J > 97 else j   # spread over the row
            i32[:, f, slot] = code, n
            f32[:2, f, slot] = e, end
            started[f, slot] = go
        now[f], free[f], dead[f] = t_now, n_free, is_dead
    active = ~dead & (i32[0] == QUEUED).any(1)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt,  # noqa: E731
                                                 device=device)
    jobs = JobTable(submit_t=t(f32[3]), nodes=t(i32[1], torch.int32),
                    est_runtime=t(f32[0]), start_t=t(f32[2]),
                    end_t=t(f32[1]), state=t(i32[0], torch.int32))
    st = SimState(jobs=jobs, free_nodes=t(free, torch.int32),
                  total_nodes=t(np.full(k, 560), torch.int32), now=t(now))
    return (st, t(started, torch.bool), t(active, torch.bool),
            t(dead, torch.bool), t(np.zeros(k), torch.int32),
            t([7], torch.int32))


def _assert_step(args):
    """The kernel (one launch) and its plain version on copies of
    ``args``: every tensor either writes, bitwise (floats by their bits,
    NaNs included)."""
    from chip_smoke import step_args, step_tensors
    from repro_torch.kernels import drain_step as ds
    got, want = step_args(args), step_args(args)
    launches = ds.LAUNCHES
    ds.drain_step(*got)
    assert ds.LAUNCHES == launches + 1
    ds.drain_step_plain(*want)
    torch.cuda.synchronize()
    names = ("start_t", "end_t", "state", "free_nodes", "now", "started",
             "active", "dead", "iters", "limit")
    for name, a, b in zip(names, step_tensors(got), step_tensors(want)):
        assert torch.equal(a, b), (name, int((a != b).sum()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("k,J", [(96, 256), (64, 4096), (1, 1024), (1, 77),
                                 (33, 300), (8, 1500), (500, 32)])
def test_drain_step_matches_plain_version(k, J):
    """Every layout (a warp a fork at J <= 256, a block a fork above, 4
    and 16 slots a thread), J not a multiple of 32, a single fork: the
    kernel writes the plain version's bits."""
    _card()
    for seed in range(3):
        _assert_step(_step_inputs(k, J, seed=seed + J))
        _assert_step(_step_inputs(k, J, seed=seed, queued=0.05,
                                  running=0.6))


def _assert_planted(J, args):
    """The outcomes of ``_planted_step(J)``'s forks after one step."""
    from repro_torch.core.state import DONE, RUNNING
    st, started, active, dead, iters, limit = args
    state = st.jobs.state.cpu()
    slot = lambda j: (j * 97) % J if J > 97 else j        # noqa: E731
    assert [int(state[0, slot(j)]) for j in range(5)] == [
        DONE, DONE, RUNNING, 1, DONE]                      # three tied
    assert float(st.now[0]) == 1600.0 and int(st.free_nodes[0]) == 22
    assert [int(state[1, slot(j)]) for j in range(3)] == [
        DONE, DONE, RUNNING]                               # stale ends
    assert float(st.now[1]) == 1000.0 and int(st.free_nodes[1]) == 7
    assert not bool(started[3].any())                      # dead: cleared
    assert int(state[5, slot(0)]) == DONE                  # 0 s job
    assert int(st.free_nodes[5]) == 540
    assert dead.cpu().tolist() == [False, False, True, True, False, False,
                                   True, False, True]
    assert active.cpu().tolist() == [True, True, False, False, False,
                                     True, False, False, False]
    assert iters.cpu().tolist() == [1, 1, 1, 0, 0, 1, 1, 1, 1]
    assert int(limit) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("J", [16, 256, 1024, 4096])
def test_drain_step_planted_forks(J):
    """Ties at the next end, stale ends, a deadlock, dead and drained
    forks, no running job, a NaN end, a fork drained by its last start:
    bitwise the plain version, and the planted outcomes hold."""
    _card()
    _assert_planted(J, _assert_step(_planted_step(J)))


@pytest.mark.cuda
def test_drain_step_matches_plain_version_on_a_polaris_cycle(monkeypatch):
    """The step's inputs at the first, middle and last iterations of a
    real Polaris fan drain (the k=32 sweep x 256 futures = 8,192 forks,
    J = 1,024, the cell's noise and failures): bitwise its plain
    version."""
    from chip_smoke import step_args
    from repro_torch.kernels import drain_step as ds
    _card()
    snapshot = chip_smoke_snapshot()
    pool = parse_pool(DRAS).spec
    fan = FanSpec(n=256, runtime_noise=0.3, failure_prob=0.1,
                  failure_frac=0.1, seed=3)
    engine = DrainEngine("cuda", device="cuda")
    real, seen, n = ds.drain_step, [], [0]

    def counted(*args):
        n[0] += 1
        return real(*args)
    monkeypatch.setattr(ds, "drain_step", counted)
    engine.decide_fan(snapshot, pool, fan, "cvar:0.9:score")
    total = n[0]
    assert total > 100
    picks, n[0] = {0, total // 2, total - 1}, 0

    def capture(*args):
        if n[0] in picks:
            seen.append(step_args(args))
        n[0] += 1
        return real(*args)
    monkeypatch.setattr(ds, "drain_step", capture)
    engine.decide_fan(snapshot, pool, fan, "cvar:0.9:score")
    monkeypatch.setattr(ds, "drain_step", real)
    assert n[0] == total and len(seen) == 3
    for args in seen:
        _assert_step(args)


@pytest.mark.cuda
def test_polaris_fan_drain_cuda_matches_reference_bitwise(monkeypatch):
    """A Polaris fan decision (the k=32 sweep x 16 futures, J = 1,024,
    failures on half the members, up to a quarter of the nodes) on
    ``cuda`` (the order kernel, K1 and the step kernel) and on
    ``reference``: the drains' started sets, start and end times,
    states, clocks, free nodes, ``iters``, deadlocks and passes, and the
    decisions' winners, costs (by their bits) and ``run_mask``,
    identical."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import sync
    from repro_torch.core.events import Event, EventKind
    _card()
    drains = []
    run = engine_mod.simulate_to_drain_batched

    def recorded(*args):
        drains.append(run(*args))
        return drains[-1]
    monkeypatch.setattr(engine_mod, "simulate_to_drain_batched", recorded)
    snapshot = chip_smoke_snapshot()
    jobs = snapshot.jobs
    running = (jobs.state == 2).nonzero().flatten().tolist()
    running.sort(key=lambda j: float(jobs.end_t[j]))
    for j in running[:3]:
        snapshot, _ = sync.apply_event(snapshot, Event(
            EventKind.JOBOBIT, max(float(jobs.end_t[j]),
                                   float(snapshot.now)), j))
    pool = parse_pool(DRAS).spec
    fan = FanSpec(n=16, runtime_noise=0.3, failure_prob=0.5,
                  failure_frac=0.25, seed=11)
    got = DrainEngine("cuda", device="cuda").decide_fan(
        snapshot, pool, fan, "cvar:0.9:score")
    want = DrainEngine("reference", device="cuda").decide_fan(
        snapshot, pool, fan, "cvar:0.9:score")
    torch.cuda.synchronize()
    a, b = drains
    assert bool(a.first_started.any()) and int(a.iters.max()) > 100
    for x, y in ((a.first_started, b.first_started), (a.iters, b.iters),
                 (a.deadlocked, b.deadlocked),
                 (a.pass_invocations, b.pass_invocations),
                 (a.state.free_nodes, b.state.free_nodes),
                 (a.state.jobs.state, b.state.jobs.state)):
        assert torch.equal(x, y)
    for x, y in ((a.state.jobs.start_t, b.state.jobs.start_t),
                 (a.state.jobs.end_t, b.state.jobs.end_t),
                 (a.state.now, b.state.now)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert int(got.policy_index) == int(want.policy_index)
    assert torch.equal(got.costs.view(torch.int32),
                       want.costs.view(torch.int32))
    assert torch.equal(got.run_mask, want.run_mask)
    assert torch.equal(got.deadlocked, want.deadlocked)


@pytest.mark.cuda
def test_drain_step_counts_one_launch_an_iteration():
    """On ``cuda`` a drain launches the step kernel once an iteration
    (``drain.steps``, K1's launches), a replay grid never; on
    ``reference`` neither launches it."""
    from repro_torch.core import telemetry
    from repro_torch.kernels import drain_step as ds
    _card()
    scen, pool = _replay_grids()[1]
    snapshot = chip_smoke_snapshot()
    for backend in ("cuda", "reference"):
        engine = DrainEngine(backend, device="cuda")
        before = (pe.LAUNCHES, ds.LAUNCHES)
        engine.decide(snapshot, pool)
        torch.cuda.synchronize()
        n = telemetry.SPANS.roots[-1].counts()
        k1, step = pe.LAUNCHES - before[0], ds.LAUNCHES - before[1]
        want = n["drain.steps"] if backend == "cuda" else 0
        assert k1 == step == want
        before = (pe.LAUNCHES, ds.LAUNCHES)
        engine.replay_grid(scen, pool)
        torch.cuda.synchronize()
        n = telemetry.SPANS.roots[-1].counts()
        assert n["replay.steps"] > 0
        assert ds.LAUNCHES == before[1]
        assert pe.LAUNCHES - before[0] == (
            n["replay.steps"] if backend == "cuda" else 0)


@pytest.mark.cuda
def test_drain_step_refuses_bad_arguments():
    """J > ``MAX_J`` and wrong dtypes raise before any launch."""
    from repro_torch.kernels import drain_step as ds
    _card()
    args = _step_inputs(2, ds.MAX_J + 1, seed=0)
    launches = ds.LAUNCHES
    with pytest.raises(ValueError, match="MAX_J"):
        ds.drain_step(*args)
    st, started, active, dead, iters, limit = _step_inputs(4, 64, seed=1)
    bad = [(st, started.to(torch.uint8), active, dead, iters, limit),
           (st, started, active.int(), dead, iters, limit),
           (st, started, active, dead, iters.long(), limit),
           (st, started, active, dead, iters, limit.long()),
           (st._replace(now=st.now.double()), started, active, dead, iters,
            limit),
           (st._replace(jobs=st.jobs._replace(end_t=st.jobs.end_t.half())),
            started, active, dead, iters, limit)]
    for args in bad:
        with pytest.raises(TypeError, match="dtype"):
            ds.drain_step(*args)
    with pytest.raises(ValueError, match="contiguous"):
        ds.drain_step(st, started.t().contiguous().t(), active, dead, iters,
                      limit)
    assert ds.LAUNCHES == launches

"""The dry run's counter (``repro_torch.counting``) on meta tensors, and
its roofline (``repro_torch.launch.cost``).

* Trip counts: six 64x64 matmuls in ``trip(6)`` count 6·2·64³ FLOPs,
  the same FLOPs and bytes as the six run in full (the counterpart of
  ``test_hlo_analysis.py::test_real_scan_flops_counted_with_trips``).
* HBM bytes: views are free; an elementwise op reads its inputs and
  writes its output; a write into a slice of a cache costs twice the
  slice, never the buffer (``hlo_analysis._inplace_update_bytes``); a
  broadcast input is read once.
* Live and peak bytes on hand-computed allocation sequences, a storage
  freed when its last view goes, and a trip's kept outputs counted n
  times.
* ``Roofline.finalize``: terms and bottleneck at the H100 SXM's
  data-sheet rates (the counterpart of
  ``test_hlo_analysis.py::test_finalize_terms_and_bottleneck``).
* ``trip_scan`` against the full loop: ``wkv_scan`` and
  ``rglru_gated_scan`` at S = 8 on meta, forward (one step runs) and
  under autograd (three steps run: the first and last steps' backward
  differ from the others'): FLOPs, bytes and kernel calls exact; the peak
  exact in the forward and within ``PEAK_RTOL`` under autograd (measured:
  0.1% for wkv, 3.4% for the gated RG-LRU, under the full loop's).
  ``trip_map`` against the full MoE chunk loop likewise (FLOPs and bytes
  exact; peak within ``MOE_PEAK_RTOL``: 0.4% forward, 31% under
  autograd, where the tripped chunk's saved tensors stand for all).
* The kernels' meta branches (K2's two entries, K3, K4): the plain
  version's shapes and dtypes, one call and the kernel's ``work`` counted,
  no launch, the plain version never called; the CPU path bitwise as
  before.  K4's ``work`` is computed only under a counter, and its pair
  count is the plain version's mask's, Sq != Sk included.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import wkv6 as wk
from repro_torch import counting
from repro_torch.launch import cost
from repro_torch.models import attention, blocks_moe, blocks_rnn

META = dict(device="meta")
PEAK_RTOL = 0.05
MOE_PEAK_RTOL = 0.35


def test_trip_counts_the_body_n_times():
    x = torch.empty((64, 64), **META)
    with counting.CostCounter() as full:
        y = x
        for _ in range(6):
            y = y @ x
    with counting.CostCounter() as tripped:
        with tripped.trip(6):
            y = x @ x
    assert tripped.flops == full.flops == 6 * 2 * 64 ** 3
    assert tripped.bytes == full.bytes == 6 * 3 * 64 * 64 * 4


def test_views_are_free_and_ops_move_their_tensors():
    x = torch.empty((4, 8, 16), **META)
    b = torch.empty((16,), **META)
    with counting.CostCounter() as c:
        x.transpose(0, 1)
        x.reshape(32, 16)
        x[:, 2:5]
        x[1]
        x.unsqueeze(0).expand(3, 4, 8, 16)
        x.view(-1)
    assert c.bytes == 0 and c.flops == 0
    with counting.CostCounter() as c:
        x + x
    assert c.bytes == 3 * x.numel() * 4
    with counting.CostCounter() as c:
        x * b            # b is broadcast: read once
    assert c.bytes == 2 * x.numel() * 4 + b.numel() * 4
    with counting.CostCounter() as c:
        x.float()        # already f32: no copy
    assert c.bytes == 0


def test_slice_write_costs_twice_the_slice():
    cache = torch.empty((2, 4, 1024, 64), dtype=torch.bfloat16, **META)
    new = torch.empty((2, 4, 1, 64), dtype=torch.bfloat16, **META)
    with counting.CostCounter() as c:
        attention.update_cache(cache, cache, new, new, 17)
    assert c.bytes == 2 * (2 * new.numel() * 2)      # K and V
    idx = torch.empty((8,), dtype=torch.int64, **META)
    src = torch.empty((8,), **META)
    buf = torch.empty((4096,), **META)
    with counting.CostCounter() as c:
        buf[idx] = src
    assert c.bytes == 2 * (8 * 8 + 8 * 4)
    with counting.CostCounter() as c:
        buf.mul_(2.0)    # in place: read and written
    assert c.bytes == 2 * 4096 * 4


def test_live_and_peak_bytes():
    n = 1000
    with counting.CostCounter() as c:
        a = torch.empty((n,), **META)                 # 4000
        b = a * 2                                     # 8000
        assert (c.live, c.peak) == (8 * n, 8 * n)
        del a
        d = b + 1                                     # a freed: 8000
        assert (c.live, c.peak) == (8 * n, 8 * n)
        v = d.view(10, 100)                           # a view: nothing
        del d
        e = torch.cat([b, b])                         # d alive via v
        assert (c.live, c.peak) == (16 * n, 16 * n)
        del v, b
        f = e.sum()                                   # 4 bytes
        assert c.live == 8 * n + 4 and c.peak == 16 * n
        del e, f
    base = torch.empty((n,), **META)
    c = counting.CostCounter()
    assert c.track({"w": base, "again": base[1:]}) == 4 * n
    with c:
        kept = []
        with c.trip(5):
            kept.append(base * 3)
        assert c.live == 4 * n + 5 * 4 * n and c.base == 4 * n
        assert c.peak == 4 * n + 5 * 4 * n
        del kept
        base + 1
        assert c.live == 2 * 4 * n


def test_finalize_terms_and_bottleneck():
    rl = cost.Roofline(flops=cost.PEAK_FLOPS_BF16,
                       bytes_accessed=cost.HBM_BW * 2)
    rl.finalize(model_flops=cost.PEAK_FLOPS_BF16 * 0.5)
    assert abs(rl.t_compute - 1.0) < 1e-9
    assert abs(rl.t_memory - 2.0) < 1e-9
    assert rl.t_collective == 0.0
    assert rl.bottleneck == "memory"
    assert abs(rl.useful_ratio - 0.5) < 1e-9
    assert (cost.PEAK_FLOPS_BF16, cost.HBM_BW, cost.OP_RATE) == (
        989e12, 3.35e12, 67e12)


def _wkv(grad):
    b, s, h, n = 2, 8, 3, 16
    r, k, v, w = (torch.empty((b, s, h, n), requires_grad=grad, **META)
                  for _ in range(4))
    u = torch.empty((h, n), requires_grad=grad, **META)
    state0 = torch.zeros((b, h, n, n), **META)   # held, as the block does
    state, y = blocks_rnn.wkv_scan(state0, r, k, v, w, u)
    assert y.shape == (b, s, h, n) and state.shape == (b, h, n, n)
    if grad:
        y.sum().backward()


def _rglru_gated(grad):
    b, s, w = 2, 8, 24
    bf = dict(dtype=torch.bfloat16, requires_grad=grad, **META)
    gates = [torch.empty((b, s, w), **bf) for _ in range(4)] + [
        torch.empty((w,), **bf) for _ in range(3)]
    y, h = blocks_rnn.rglru_gated_scan(*gates)
    assert y.shape == (b, s, w) and y.dtype == torch.bfloat16
    assert h.shape == (b, w) and h.dtype == torch.float32
    if grad:
        y.float().sum().backward()


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "autograd"])
@pytest.mark.parametrize("scan", [_wkv, _rglru_gated],
                         ids=["wkv_scan", "rglru_gated_scan"])
def test_trip_scan_counts_the_full_loop(scan, grad, monkeypatch):
    with monkeypatch.context() as m, counting.CostCounter() as full:
        m.setattr(counting, "tripping", lambda t: False)    # every step
        scan(grad)
    steps = []
    for name in ("wkv_step", "_rglru_step"):
        fn = getattr(blocks_rnn, name)
        monkeypatch.setattr(blocks_rnn, name,
                            lambda *a, fn=fn: steps.append(1) or fn(*a))
    with counting.CostCounter() as tripped:
        scan(grad)
    assert len(steps) == (3 if grad else 1)
    assert tripped.flops == full.flops
    assert tripped.bytes == full.bytes
    assert tripped.kernel_calls == full.kernel_calls == {}
    if grad:
        assert abs(tripped.peak - full.peak) <= PEAK_RTOL * full.peak
    else:
        assert tripped.peak == full.peak


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "autograd"])
def test_trip_map_counts_the_full_chunk_loop(grad, monkeypatch):
    monkeypatch.setattr(blocks_moe, "MOE_CHUNK", 16)
    cfg = get_smoke_config("olmoe-1b-7b")
    table = blocks_moe.table(cfg)

    def run(trips):
        params = {k: torch.empty(shape, requires_grad=grad, **META)
                  for k, (shape, _) in table.items()}
        x = torch.empty((2, 40, cfg.d_model), requires_grad=grad, **META)
        with monkeypatch.context() as m, counting.CostCounter() as c:
            if not trips:                                   # every chunk
                m.setattr(counting, "tripping", lambda t: False)
            y, aux = blocks_moe.moe_apply(cfg, params, x)
            assert y.shape == x.shape
            assert set(aux) == {"moe_aux", "moe_z", "moe_dropped"}
            if grad:
                (y.sum() + aux["moe_aux"] + aux["moe_z"]).backward()
        return c
    full, tripped = run(False), run(True)
    assert tripped.flops == full.flops > 0
    assert tripped.bytes == full.bytes
    assert abs(tripped.peak - full.peak) <= MOE_PEAK_RTOL * full.peak


def _kernel_cases():
    bf = dict(dtype=torch.bfloat16)
    gated = [(2, 5, 24)] * 4 + [(24,)] * 3
    return {
        "flash_attention": (
            fa, fa.flash_attention,
            [((1, 4, 40, 32), bf), ((1, 2, 40, 32), bf),
             ((1, 2, 40, 32), bf)], dict(causal=True, window=16),
            "full_attention",
            fa.work(1, 4, 2, 40, 40, 32, causal=True, window=16,
                    itemsize=2)),
        "wkv6": (wk, wk.wkv6, [((1, 6, 2, 16), {})] * 4 + [((2, 16), {})],
                 {}, "wkv_scan", wk.work(1, 6, 2, 16)),
        "rglru": (rg, rg.rglru, [((2, 5, 24), {})] * 2 + [((2, 24), {})],
                  {}, "rglru_scan", rg.work(2, 5, 24)),
        "rglru_gated": (rg, rg.rglru_gated, [(s, bf) for s in gated], {},
                        "rglru_gated_scan", rg.gated_work(2, 5, 24, 2,
                                                          False)),
    }


@pytest.mark.parametrize("kernel", list(_kernel_cases()))
def test_kernel_meta_branch(kernel, monkeypatch):
    """On meta: the plain version's shapes and dtypes, one call and its
    work counted, no launch, the plain version never run; on the CPU the
    plain version's bits, as before."""
    module, wrapper, shapes, kw, plain, work = _kernel_cases()[kernel]
    rng = np.random.default_rng(0)
    cpu = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(opts.get("dtype", torch.float32))
           for shape, opts in shapes]
    if kernel == "wkv6":
        cpu[3] = torch.sigmoid(cpu[3])
    want = wrapper(*cpu, **kw)
    want = want if isinstance(want, tuple) else (want,)
    if kernel == "flash_attention":
        ref = attention.full_attention(*cpu, causal=True, local_window=16)
        assert torch.equal(want[0], ref)
    else:
        ref = getattr(blocks_rnn, plain)(*(
            [torch.zeros((1, 2, 16, 16))] if kernel == "wkv6" else [])
            + cpu)
        ref = ref[::-1] if kernel in ("wkv6", "rglru") else ref
        assert all(torch.equal(a, b) for a, b in zip(want, ref))

    def refuse(*a, **k):
        raise AssertionError(f"{plain} ran on meta")
    target = attention if kernel == "flash_attention" else blocks_rnn
    monkeypatch.setattr(target, plain, refuse)
    if kernel == "flash_attention":
        monkeypatch.setattr(fa, "full_attention", refuse)
    launches = module.LAUNCHES
    with counting.CostCounter() as c:
        got = wrapper(*(torch.empty(s, **o, **META) for s, o in shapes),
                      **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert module.LAUNCHES == launches
    assert [(g.shape, g.dtype, g.device.type) for g in got] == [
        (w.shape, w.dtype, "meta") for w in want]
    name = "rglru" if kernel.startswith("rglru") else kernel
    assert c.kernel_calls == {name: 1}
    assert c.kernel_flops[name] == c.flops == work[0]
    assert c.kernel_bytes[name] == work[1]


@pytest.mark.parametrize("sq,sk,causal,window", [
    (40, 40, False, 0), (7, 19, True, 0), (19, 7, True, 0),
    (19, 7, True, 5), (7, 19, True, 5), (33, 33, True, 8),
    (30, 12, True, 40), (12, 30, False, 0)])
def test_k4_pairs_count_the_plain_mask(sq, sk, causal, window):
    """K4's ``causal_pairs`` is the number of (query, key) pairs the plain
    version's mask keeps (``full_attention``: both positions from 0),
    but for causal Sq == Sk, where it is half the square, as K4's bounds
    have always been stated."""
    q_pos, k_pos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal or window:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    want = sq * sk / 2 if causal and not window and sq == sk \
        else int(mask.sum())
    assert fa.causal_pairs(sq, sk, causal, window) == want


def test_k4_work_only_under_a_counter(monkeypatch):
    """Without an active counter K4's meta branch computes no ``work``."""
    def refuse(*a, **k):
        raise AssertionError("work computed")
    monkeypatch.setattr(fa, "work", refuse)
    q = torch.empty((1, 4, 40, 32), dtype=torch.bfloat16, **META)
    kv = torch.empty((1, 2, 40, 32), dtype=torch.bfloat16, **META)
    assert fa.flash_attention(q, kv, kv, window=16).shape == q.shape
    with pytest.raises(AssertionError, match="work computed"), \
            counting.CostCounter():
        fa.flash_attention(q, kv, kv, window=16)

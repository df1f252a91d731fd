"""K3 and K4, the port's model kernels, against their plain versions on
a CUDA card.  Every test is marked ``cuda`` and skips on a host without
one: a CUDA kernel has no CPU mode.  This file imports neither JAX nor
the JAX package, so that it runs on the GPU machine, which has no JAX:

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

* K4 (``kernels.flash_attention``) vs ``models.attention.full_attention``:
  every head dim and dtype it takes, causal and not, ragged Sq and Sk
  (including Sq != Sk and single rows), q/k/v as strided views of
  (B, S, H, D) projections.  Tolerance: float32 atol = rtol = 2e-5,
  bfloat16 3e-2 (JAX's own flash tests' tolerances).
* K3 (``kernels.wkv6``) vs ``models.blocks_rnn.wkv_scan`` from a zero
  state: every head size it takes, S of 1, 37 and 1000.  Tolerance:
  atol = rtol = 2e-4 (``tests/test_kernels_recurrent.py``'s).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.attention import full_attention
from repro_torch.models.blocks_rnn import wkv_scan


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_flash_attention_matches_plain_version(d, dtype, tol):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(d)
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

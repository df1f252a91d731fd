"""The traced window: K1's least bytes counted launch by launch from the
inputs each launch in the window was given, and only those (launches 3-5
of 0-6: it opens at launch 1, records from launch 3, closes at 6)."""
import pytest
import torch

from twinbench import roofline, trace
from twinbench.tests.test_twinbench_reference import _pass_inputs


@pytest.mark.parametrize("limited", (False, True))
def test_window_counts_each_launch_from_its_inputs(limited):
    from repro_torch.kernels import policy_eval
    launches = [_pass_inputs(seed) for seed in range(7)]
    limits = [torch.tensor([5 + 7 * i], dtype=torch.int32) if limited
              else None for i in range(7)]
    with trace.K1Window(start=1, warm=2, active=3) as win:
        for args, limit in zip(launches, limits):
            policy_eval.policy_eval_pass_batched(*args, limit=limit)
    want = [roofline.k1_bytes(
        args[1].shape[1], (args[1] == 1).sum(1).numpy(),
        (args[1] == 2).sum(1).numpy(),
        None if limit is None else int(limit))
        for args, limit in zip(launches[3:6], limits[3:6])]
    assert win.launch_bytes == want
    assert win.wall is not None and win.states is None

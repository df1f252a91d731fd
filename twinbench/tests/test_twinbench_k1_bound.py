"""K1's frozen bound: the least bytes of one launch, counted from its
inputs, and their time at the H100's data-sheet HBM rate."""
import numpy as np
import pytest

from twinbench import roofline


@pytest.mark.parametrize("k, J, nbytes, us", [
    (8192, 1024, 142_704_644, 42.598),    # the one-shot fleet grid's pass
    (2048, 1024, 35_676_164, 10.650),     # a streamed block's pass
    (256, 1024, 4_459_524, 1.331),        # the replay grid's pass
    (32, 1024, 557_444, 0.166),           # the k=32 drain's pass
])
def test_k1_bound(k, J, nbytes, us):
    """Every slot queued and no rank limit: the whole table is walked."""
    assert roofline.k1_bytes(J, [J] * k, [0] * k) == nbytes
    assert round(roofline.k1_bound_s(nbytes) * 1e6, 3) == us


def test_k1_bound_follows_the_limit_and_running_jobs():
    # walks min(queued, 100) ranks: 100, 10, 0; 8 B a running job
    got = roofline.k1_bytes(256, [150, 10, 0], [5, 20, 0], limit=100)
    assert got == (5 * 256 + 1200 + 40 + 12) + (5 * 256 + 120 + 160 + 12) \
        + (5 * 256 + 12) + 4


@pytest.mark.parametrize("seed", range(4))
def test_k1_bound_within_every_input_once(seed):
    """Never above five (k, J) inputs read once, the mask and the (k,)
    values written once (the count of the port's kernel table)."""
    rng = np.random.default_rng(seed)
    k, J = 64, 256
    q = rng.integers(0, J + 1, k)
    r = rng.integers(0, J + 1 - q)
    limit = int(rng.integers(1, J + 1))
    assert roofline.k1_bytes(J, q, r, limit) <= 21 * k * J + 12 * k + 4

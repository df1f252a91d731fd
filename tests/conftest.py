import jax
import numpy as np
import pytest

from repro.core.state import add_job, empty_state, start_job
from repro.distributed.sharding import make_rules
from repro.launch.mesh import make_mesh


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on a host without one")


@pytest.fixture(scope="session")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="session")
def rules_train(mesh11):
    return make_rules(mesh11, "fsdp_tp")


@pytest.fixture(scope="session")
def rules_decode(mesh11):
    return make_rules(mesh11, "decode")


def make_cluster_state(max_jobs=64, total_nodes=32, n_queued=12,
                       n_running=4, seed=0, now=500.0):
    """A consistent SimState: running jobs fit, the rest are queued."""
    rng = np.random.default_rng(seed)
    st = empty_state(max_jobs, total_nodes)
    jid = 0
    free = total_nodes
    for _ in range(n_running):
        nodes = int(rng.integers(1, max(2, free // 2 + 1)))
        if nodes > free:
            break
        st = add_job(st, jid, float(jid * 7.0), nodes,
                     float(rng.uniform(60, 600)))
        st = start_job(st, jid, float(jid * 7.0 + rng.uniform(0, 50)))
        free -= nodes
        jid += 1
    for _ in range(n_queued):
        st = add_job(st, jid, float(jid * 7.0),
                     int(rng.integers(1, total_nodes + 1)),
                     float(rng.uniform(30, 900)))
        jid += 1
    import jax.numpy as jnp
    return st._replace(now=jnp.float32(now))

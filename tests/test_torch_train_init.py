"""The port draws the reference's initial weights bit for bit (ROADMAP
C5, repaired): ``repro_torch.models.common.init_params`` and
``api.init_model`` against JAX's ``init_params(PRNGKey(seed), table)``.

* All ten architectures' smoke tables, float32 and bfloat16, seeds 0 and
  7: every entry bitwise, from ``init_params`` (the flat table) and from
  ``init_model`` (per-layer tensors, stacked entries drawn whole and
  sliced).  Tolerance: none.
* A draw made in chunks of 1,000 elements (``INIT_CHUNK``, so chunks
  cross layer boundaries of the stacked entries) is bitwise the
  one-shot draw, and a ``prng`` key gives what its int seed gives.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import api as japi
from repro.models.common import init_params as jinit
from repro_torch import convert
from repro_torch.configs import ARCH_ORDER, get_smoke_config
from repro_torch.core import prng
from repro_torch.models import api, common
from torch_threads import one_thread  # noqa: F401


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@functools.lru_cache(maxsize=None)
def _jax_init(arch, seed, dt):
    table = japi.param_table(jget_smoke(arch))
    params = jinit(jax.random.PRNGKey(seed), table, dtype=DTYPES[dt][1])
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in params.items()}


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    bad = [k for k in want
           if not np.array_equal(_bits(got[k]), _bits(want[k]))]
    assert not bad, f"entries differing from JAX's draw: {bad}"


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", ARCH_ORDER)
def test_init_matches_jax_bitwise(arch, dt, seed):
    cfg = get_smoke_config(arch)
    want = _jax_init(arch, seed, dt)
    flat = common.init_params(seed, api.param_table(cfg), DTYPES[dt][0],
                              "cpu")
    _assert_bitwise({k: v.float().numpy() for k, v in flat.items()}, want)
    model = api.init_model(cfg, seed=seed, dtype=DTYPES[dt][0], device="cpu")
    _assert_bitwise(convert.params_to_numpy(model), want)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b"])
def test_chunked_draw_is_the_one_shot_draw(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    whole = convert.params_to_numpy(api.init_model(cfg, seed=3,
                                                   dtype=torch.float32,
                                                   device="cpu"))
    monkeypatch.setattr(common, "INIT_CHUNK", 1000)
    chunked = convert.params_to_numpy(api.init_model(
        cfg, seed=prng.PRNGKey(3), dtype=torch.float32, device="cpu"))
    _assert_bitwise(chunked, whole)
    flat = common.init_params(prng.PRNGKey(3), api.param_table(cfg),
                              torch.float32, "cpu")
    _assert_bitwise({k: v.numpy() for k, v in flat.items()}, whole)

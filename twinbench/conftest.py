"""pytest settings of the benchmark's own tests (``twinbench/tests``).

Card tests carry the ``cuda`` marker and decide in a fixture whether a
card is present; on a host without one they skip.  On the machine with
the card: ``python3 -m pytest -q -m cuda twinbench/tests`` from the root
of the checkout (``src`` is put on the path by the tests)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.append(str(ROOT / "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on a host without one")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU work runs fastest on one intra-op thread while
    pytest-xdist runs several workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with CPU-sized cells added as files."""
    from twinbench.tests import tiny
    return tiny.make(tmp_path_factory.mktemp("tiny"))

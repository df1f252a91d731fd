"""What the benchmark may load: no module under ``twinbench/`` imports
JAX or the JAX package, and the reference imports nothing of the
program; names compare whole at the top level, since the program's
``repro_torch`` begins with ``repro``."""
import ast
from pathlib import Path

import pytest

from twinbench import harness

HERE = Path(harness.__file__).resolve().parent


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py"))


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_or_jax_package(rel):
    assert not set(_top_imports(HERE / rel)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("rel", [f for f in FILES
                                 if f.startswith("reference/")])
def test_reference_imports_nothing_of_program(rel):
    assert set(_top_imports(HERE / rel)) <= {"__future__", "itertools",
                                             "math", "typing", "numpy",
                                             "torch", "twinbench"}
    assert all("entries" not in line for line in
               (HERE / rel).read_text().splitlines()
               if line.startswith(("from", "import")))


@pytest.mark.parametrize("name", ("jax", "jaxlib.xla_client", "flax",
                                  "repro.core.des"))
def test_guard_refuses_loaded(name):
    with pytest.raises(SystemExit):
        harness.guard_imports(["torch", "repro_torch.core.des", name])


def test_guard_takes_program():
    harness.guard_imports(["torch", "numpy", "repro_torch",
                           "repro_torch.core.des", "twinbench.harness"])

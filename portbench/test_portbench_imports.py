"""Nothing the benchmark runs imports JAX, the JAX package (``repro``) or
its ``benchmarks``; the reference and the yardstick import nothing of the
program either.  Names are compared by their top-level part whole."""

import ast
import subprocess
import sys

import pytest

from portbench.harness import catalog
from portbench.harness.imports import FORBIDDEN, forbidden_loaded

PORTBENCH = catalog.ROOT / "portbench"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


def test_top_level_names_compared_whole():
    assert forbidden_loaded(["repro_torch", "repro_torch.kernels",
                             "reproduce", "jaxtyping", "numpy"]) == []
    assert forbidden_loaded(["repro.core.pca"]) == ["repro"]
    assert forbidden_loaded(["jaxlib.xla_client", "jax"]) == ["jax",
                                                               "jaxlib"]
    assert forbidden_loaded(["benchmarks.loadgen", "flax"]) == [
        "benchmarks", "flax"]


@pytest.mark.parametrize("path", sorted(PORTBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_source_imports_jax_or_repro(path):
    assert not (_imports(path) & set(FORBIDDEN)), path


@pytest.mark.parametrize("part", ["reference", "gen", "roofline"])
def test_yardstick_imports_nothing_of_the_program(part):
    for path in (PORTBENCH / part).rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_a_run_loads_neither(tmp_path):
    """A whole run at a tiny size on the CPU, in a fresh process, then the
    process's modules (the run's own check)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from portbench.tiny import tiny_cell\n"
        "from portbench import run\n"
        "from portbench.harness.imports import forbidden_loaded\n"
        "r = run.run_cell(tiny_cell('dpr24x.bulk', 4000), 11, 0.3, False,"
        " 'cpu')\n"
        "assert r['correct'], r\n"
        "print('FORBIDDEN', forbidden_loaded())\n" % str(catalog.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout

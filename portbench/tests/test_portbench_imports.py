"""Nothing the benchmark imports is JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program;
and a run loads neither."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "aaltoasr_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "aaltoasr_tpu_torch" not in imported(path)
    assert imported(path) <= {"__future__", "math", "numpy", "torch",
                              "portbench"}


def test_a_cell_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run, portbench.loops.asr, portbench.loops.estep\n"
            "import portbench.control\n"
            "from portbench.harness import loaded_forbidden\n"
            "import aaltoasr_tpu_torch.decoder.search_dense, "
            "aaltoasr_tpu_torch.train.driver, "
            "aaltoasr_tpu_torch.models.phone_probs\n"
            "print(loaded_forbidden())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_harness_reads_none_of_the_jax_benchmarks():
    for path in SOURCES:
        text = path.read_text()
        for old in ("bench.py", "benchmarks/", "chip_smoke"):
            assert old not in text.replace("chip_smoke.bound", ""), (path, old)

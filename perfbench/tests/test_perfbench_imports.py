"""No module of the benchmark imports JAX or the JAX package, by whole
top-level module name (the port's name, ``repro_torch``, begins with the
JAX package's); the reference imports nothing of the program; only
``perfbench/program.py`` imports the program."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.run import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


def test_only_the_adapter_imports_the_program():
    users = {p.relative_to(BENCH).as_posix() for p in FILES
             if "repro_torch" in top_level_imports(p)
             and not p.name.startswith("test_")}
    assert users <= {"program.py"}
    for p in (BENCH / "reference").rglob("*.py"):
        assert top_level_imports(p) <= {"__future__", "math", "typing",
                                        "torch", "numpy"}


def test_whole_name_check():
    assert forbidden_modules(["repro_torch", "repro_torch.core", "torch",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                              "flax.linen", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_no_cuda_no_result():
    """Without a card the run exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "lcbench_pool4k.final", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=BENCH.parent, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""

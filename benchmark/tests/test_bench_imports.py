"""Nothing the benchmark runs may load JAX or the JAX package, and its
reference takes nothing of the program.

Module names are compared by their top-level part (before the first
dot) as a whole: ``scda_tpu_torch``, the program, is not ``scda_tpu``.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "scda_tpu"}


def _sources(sub=""):
    base = os.path.join(BENCH, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = sorted(set(_imported_tops(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    tops = set(_imported_tops(path))
    assert "scda_tpu_torch" not in tops, f"{path} imports the program"
    assert not tops & FORBIDDEN


def test_whole_names_are_compared():
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    saved = dict(sys.modules)
    try:
        sys.modules["scda_tpu_torch_x"] = sys
        sys.modules["jaxlike"] = sys
        assert run.forbidden_modules() == sorted(
            {m.split(".", 1)[0] for m in saved} & set(run.FORBIDDEN))
        sys.modules["scda_tpu.models"] = sys
        assert "scda_tpu" in run.forbidden_modules()
    finally:
        for k in ("scda_tpu_torch_x", "jaxlike", "scda_tpu.models"):
            sys.modules.pop(k, None)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process, then ``sys.modules``."""
    code = f"""
import sys, time
sys.path.insert(0, {ROOT!r})
import torch
torch.set_num_threads(1)
from benchmark.tests.tiny import tiny_root
from benchmark.harness.spec import Cell
from benchmark.harness import drive
root = tiny_root({str(tmp_path)!r})
drive.run_cell(Cell('tiny_vgg16-serve-bs1', root), 5, 0.2, True,
               torch.device('cpu'), time.perf_counter())
sys.path.insert(0, {BENCH!r})
import run
print(run.forbidden_modules())
"""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "vgg16-serve-bs1", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

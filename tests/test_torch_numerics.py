"""Every entry point of the port runs with TF32 off and deterministic
algorithms (``scda_tpu_torch/utils/numerics.py``), whatever the process
had set before: the three CLIs' ``main``, each rank that
``parallel/mesh.py`` starts, and ``chip_smoke.py``, ``bench_torch.py``
and ``utils/kernel_probe.py``, whose card paths are checked on their
source here.  Each test starts from the opposite settings and restores
the process's own afterwards (``torch_numerics_state.kept``)."""

import ast
import inspect
import json
import os

import pytest
import torch

import torch_numerics_state as state
from scda_tpu_torch.utils import numerics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# PyTorch's defaults, and the opposite of each of the helper's settings.
OFF = {"cudnn.allow_tf32": True, "cuda.matmul.allow_tf32": True,
       "cudnn.deterministic": False, "cudnn.benchmark": True,
       "deterministic_algorithms": False, "deterministic_warn_only": False,
       "fill_uninitialized_memory": True, state.ENV: None}


@pytest.fixture
def numerics_off():
    with state.kept():
        state.apply(OFF)
        assert state.read() == OFF
        yield


def test_helper_sets_every_setting(numerics_off):
    numerics.set_card_numerics()
    assert state.read() == state.CARD


def test_helper_keeps_a_workspace_config_already_set(numerics_off):
    os.environ[state.ENV] = ":16:8"
    numerics.set_card_numerics()
    assert state.read() == {**state.CARD, state.ENV: ":16:8"}


def test_helper_has_no_switch():
    """No argument, and no environment variable other than cuBLAS's
    workspace (which it only sets) is read."""
    assert not inspect.signature(numerics.set_card_numerics).parameters
    src = inspect.getsource(numerics)
    assert "environ.get" not in src and "getenv" not in src


@pytest.mark.parametrize("cli, argv", [
    ("trainval", ["--device", "cpu", "--num_devices", "2", "--bs", "3"]),
    ("test_net", ["--net", "tiny", "--device", "cuda"]),
    ("demo", ["--image_dir", ".", "--net", "tiny", "--device", "cuda"]),
])
def test_cli_main_sets_the_numerics(numerics_off, monkeypatch, cli, argv):
    """Each CLI's ``main`` on the cheapest call its own tests make (it
    exits 2: a batch that does not divide, or no card)."""
    import importlib

    main = importlib.import_module(f"scda_tpu_torch.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) == 2
    assert state.read() == state.CARD


def test_gloo_rank_sets_the_numerics(tmp_path):
    """A rank that ``parallel/mesh.py`` spawns (a fresh interpreter, with
    PyTorch's defaults) reports the helper's settings after
    ``init_world``."""
    from scda_tpu_torch.parallel.mesh import spawn
    from torch_parallel_worker import report_numerics

    assert spawn(report_numerics, 1, torch.device("cpu"), str(tmp_path),
                 threads=1) == 0
    with open(tmp_path / "numerics0.json") as f:
        assert json.load(f) == state.CARD


def _main_calls(path):
    """The names called in ``main`` of the file at ``path``, in order."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [getattr(n.func, "id", getattr(n.func, "attr", None))
            for n in calls]


@pytest.mark.parametrize("path", ["chip_smoke.py", "bench_torch.py",
                                  "scda_tpu_torch/utils/kernel_probe.py",
                                  "res101_steps.py"])
def test_card_scripts_call_the_helper(path):
    """Checked on the source: their card paths need a card.  Each
    ``main`` calls the helper once, and no TF32 or determinism flag is
    set anywhere else in the file; ``chip_smoke.py`` calls it before it
    builds the kernels."""
    calls = _main_calls(path)
    assert calls.count("set_card_numerics") == 1
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    for flag in ("allow_tf32", "cudnn.deterministic", "cudnn.benchmark",
                 "use_deterministic_algorithms"):
        assert flag not in src, flag
    if path == "chip_smoke.py":
        assert calls.index("set_card_numerics") < calls.index("build")

"""The output check of ``res101_fpn-train-bs2`` fails what it must: the
faults that ``test_bench_cells.py`` plants in the other training cells,
planted in the FPN cell, on the CPU at its cut and, with the ``gpu``
marker, at the cell's own size on the card."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark.harness import drive
from benchmark.harness.spec import Cell
from benchmark.tests.test_bench_cells import (  # noqa: F401 (fixtures)
    _half_the_batch_step, _run, _state_unchanged,
    _state_unchanged_after_warm_up, few_threads, root,
)

CELL = "res101_fpn-train-bs2"


def _failing(r):
    return [k for k, c in r["checks"].items()
            if c.get("compared", True) and not c["value"] <= c["limit"]]


@pytest.mark.parametrize("broken", [_state_unchanged, _half_the_batch_step])
def test_a_broken_fpn_step_is_not_correct(root, broken):
    """A step that leaves the state as it was, or that trains on the
    first image twice in place of both."""
    r = _run(Cell("tiny_" + CELL, root), seed=11, faults={"step": broken})
    assert r["correct"] is False
    assert _failing(r), r["checks"]


def test_the_fpn_step_after_the_window_is_judged(root):
    r = _run(Cell("tiny_" + CELL, root), seed=11,
             faults={"step": _state_unchanged_after_warm_up})
    assert r["correct"] is False
    assert r["checks"]["window_update_gap"]["value"] == 1.0
    assert r["checks"]["update_gap"]["value"] <= r["checks"]["update_gap"]["limit"]


@pytest.mark.gpu
def test_half_the_batch_fails_at_the_cells_size():
    """On the card, at the cell's own size and limits, a 10 s window: the
    numbers are printed for the limits file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    r = drive.run_cell(Cell(CELL), 4300000001, 10.0, False,
                       torch.device("cuda", 0), time.perf_counter(),
                       faults={"step": _half_the_batch_step})
    print(json.dumps({"cell": CELL, "fault": "half_the_batch_step",
                      "correct": r["correct"], "checks": r["checks"]}))
    assert r["correct"] is False
    assert _failing(r), r["checks"]

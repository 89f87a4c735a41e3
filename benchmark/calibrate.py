#!/usr/bin/env python3
"""The readings the output check's limits are set from, in one process:
for each seed of ``--seeds`` a run of the cell (the program's numbers,
``--seconds`` of window, untraced), and for each of ``--control-seeds``
each control of ``--controls`` (``harness/control.py``; ``fp8`` is the
one the limits are set against).  One JSON line a reading, then a
summary line: the largest program reading and the smallest reading of
each control, of each number.

    python3 benchmark/calibrate.py --workload vgg16-serve-bs1 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --controls fp8

Exits 2 without a CUDA device.  Not run by the benchmark's own runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--controls", default="fp8")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    from benchmark.harness import control, drive
    from benchmark.harness.spec import Cell
    from benchmark.reference.precision import check_f32

    check_f32()
    cell = Cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    prog, ctrl = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        r = drive.run_cell(cell, seed, args.seconds, False, device,
                           time.perf_counter())
        nums = {k: v["value"] for k, v in r["checks"].items()}
        for k, v in nums.items():
            prog[k] = max(prog.get(k, float("-inf")), v)
        print(json.dumps({"side": "program", "seed": seed, "numbers": nums,
                          "correct": r["correct"], "metrics": r["metrics"],
                          "notes": r.get("notes"),
                          "s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    for name in [c for c in args.controls.split(",") if c]:
        low = ctrl.setdefault(name, {})
        for seed in controls:
            t0 = time.perf_counter()
            nums = {k: v for k, v in control.control_numbers(
                cell, seed, device, name).items() if not k.startswith("_")}
            for k, v in nums.items():
                low[k] = min(low.get(k, float("inf")), v)
            print(json.dumps({"side": "control", "control": name, "seed": seed,
                              "numbers": nums,
                              "s": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": prog,
                      "control_min": ctrl, "seeds": seeds,
                      "control_seeds": controls,
                      "s": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

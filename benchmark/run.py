#!/usr/bin/env python3
"""The benchmark of the PyTorch port (``scda_tpu_torch``): one run of one
cell on one GPU.

    python3 benchmark/run.py --workload vgg16-scda-bs1 --seed 7 \\
        --seconds 20 --trace 0

``--workload`` names an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, output-check limits and per-layer readers
are files under ``benchmark/`` found by name (``harness/spec.py``).  The
weights and inputs come from ``--seed``.  With ``--trace 0`` the last
line of standard output is the result with the cell's end-to-end
metrics; with ``--trace 1``, after the same untraced window, a profiler
pass gives the per-layer metrics, ``busy_s``, ``window_s`` and the
``breakdown``.  Every run then checks what its timed path produced
against the plain f32 reference (``harness/judge.py``) and prints each
number compared beside its limit, as the last lines of standard error
and under the result's last key, ``checks``.

Exits 2 without a CUDA device (or with fewer than the cell needs) and 3
when JAX or the JAX package is loaded once the window has closed; then
it prints no result.  Caches (the program's kernel library, any
PyTorch extension or Triton cache) stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "scda_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def finite(obj):
    """The result with every non-finite number as None (JSON has none)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def result_line(result: dict) -> str:
    """The result as the last line of standard output: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, then any other
    keys, and ``checks`` last."""
    head = ("correct", "attempted", "failed", "metrics", "device")
    out = {k: result[k] for k in head}
    out.update((k, v) for k, v in result.items()
               if k not in head and k != "checks")
    out["checks"] = result["checks"]
    return json.dumps(finite(out))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    from benchmark.harness.spec import Cell

    cell = Cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False; the benchmark "
              "measures the card and does not run without one", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    from benchmark.harness import drive, judge
    from benchmark.reference.precision import check_f32

    check_f32()
    result = drive.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the run must not load: {found}",
              file=sys.stderr)
        return 3
    judge.print_checks(result["checks"])
    print(result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

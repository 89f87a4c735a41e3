"""Per-layer numbers of a run on the card, from one ``torch.profiler`` pass.

:func:`profile_pass` profiles a few units of work (served images or train
steps) and returns device time and kernels per unit, the share of each
kind of kernel, the device time of each of the port's CUDA kernels, the
ten longest kernels, and the device busy share.  ``chip_smoke.py`` and
``bench_torch.py`` read the per-layer numbers of their paths from it.
The profiler slows the host about twofold, so the busy share divides the
profiled device time by a wall time the caller measured without it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# Kinds of kernel by words in their names, first match wins.
KINDS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("K1 nms", ("nms_",)),
    ("K2 roi_align", ("roi_align",)),
    ("K3 vgg_stem", ("vgg_stem",)),
    ("K4 bottleneck_chain", ("chain_wgmma", "chain_gemm")),
    ("K4 bottleneck_chain_bwd", ("chain_bwd_",)),
    ("library conv/gemm", ("cudnn", "cutlass", "xmma", "gemm", "gemv",
                           "convolve", "wgrad", "dgrad", "fprop",
                           "nchwToNhwc", "nhwcToNchw", "cublas")),
    ("copy", ("Memcpy", "Memset", "copy_kernel", "CatArray")),
    ("optimizer foreach", ("multi_tensor",)),
    ("sort/scan/reduce", ("sort", "Sort", "scan", "reduce", "Reduce",
                          "cub::", "topk", "TopK")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise", "fill",
                     "index", "gather", "scatter", "max_pool", "where",
                     "masked")),
)

# The port's own CUDA kernels (``scda_tpu_torch/csrc``), by a word of
# their device function's name.
PORT_KERNELS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("K1 nms_mask", ("nms_mask_kernel",)),
    ("K1 nms_scan", ("nms_scan_kernel",)),
    ("K2 roi_align", ("roi_align_contract_kernel",)),
    ("K2 roi_align_bwd", ("roi_align_contract_bwd_kernel",)),
    ("K3 vgg_stem", ("vgg_stem_bf16_kernel", "vgg_stem_f32_kernel")),
    ("K4 bottleneck_chain", ("chain_wgmma_kernel", "chain_gemm_f32_kernel")),
    ("K4 bottleneck_chain_bwd", ("chain_bwd_",)),
)

Row = Tuple[str, int, float]     # (kernel name, launches, device ms)


def _first(key: str, table) -> Optional[str]:
    return next((name for name, words in table
                 if any(w in key for w in words)), None)


def summarize(rows: Sequence[Row], units: int,
              wall_ms_per_unit: float) -> Dict[str, object]:
    """The per-unit numbers of a pass's device kernels ``rows`` over
    ``units`` units whose unprofiled wall time is ``wall_ms_per_unit``.
    The profiler's step annotation (``ProfilerStep*``, a device range
    over the whole step) is not a kernel and is left out; with no kernel
    left the result is ``{"error": ...}``."""
    rows = [r for r in rows if not r[0].startswith("ProfilerStep")]
    if not rows:
        return {"error": "the profiler saw no device time"}
    total = sum(ms for _, _, ms in rows)
    by_kind: Dict[str, float] = {}
    port: Dict[str, List[float]] = {name: [0, 0.0] for name, _ in PORT_KERNELS}
    for key, count, ms in rows:
        kind = _first(key, KINDS) or "other"
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        mine = _first(key, PORT_KERNELS)
        if mine:
            port[mine][0] += count
            port[mine][1] += ms
    ordered = sorted(by_kind.items(), key=lambda kv: -kv[1])
    top = sorted(rows, key=lambda r: -r[2])[:10]
    return {
        "units": units,
        "device_ms_per_unit": total / units,
        "kernels_per_unit": sum(n for _, n, _ in rows) / units,
        "wall_ms_per_unit_unprofiled": wall_ms_per_unit,
        "device_busy_share": total / units / wall_ms_per_unit,
        "share_by_kind": {k: v / total for k, v in ordered},
        "ms_per_unit_by_kind": {k: v / units for k, v in ordered},
        "port_kernels": {name: {"launches_per_unit": n / units,
                                "ms_per_unit": ms / units}
                         for name, (n, ms) in port.items() if n},
        "top_kernels": [{"name": k[:80], "per_unit": n / units,
                         "ms_per_unit": ms / units} for k, n, ms in top],
    }


def profile_pass(run: Callable[[], object], units: int,
                 wall_ms_per_unit: float) -> Dict[str, object]:
    """One ``torch.profiler`` pass over ``run()`` (``units`` units):
    :func:`summarize` of the device kernels.  A first, discarded
    ``run()`` under the profiler (its warm-up step) lets the tracer start,
    and the recorded one starts 50 ms into its step: without both, the
    pass now and then missed the first kernel of a unit.  A measurement,
    not a check."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in range(2):
            if step:
                time.sleep(0.05)
            run()
            torch.cuda.synchronize()
            prof.step()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return summarize(rows, units, wall_ms_per_unit)

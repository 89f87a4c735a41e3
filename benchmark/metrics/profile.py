"""Per-layer numbers of a traced run, from one ``torch.profiler`` pass.

``KINDS``, ``PORT_KERNELS`` and :func:`summarize` are a frozen copy of
``scda_tpu_torch/utils/profile.py`` at commit 93bf85b9b08d (kernels by
kind, the program's own kernels by name, busy share against an
unprofiled wall time).  :func:`trace_units` is that file's
``profile_pass`` (a discarded warm-up step so that the tracer has
started, the recorded step 50 ms in) returning the whole trace, and
:func:`read_trace` adds what the benchmark reads from it:

* the device time of the kernels launched inside each ``bench.*`` range
  the harness opened around a call site of the program, read from the
  range's device-side annotation (a reader whose range shows no kernel
  falls back on ``PORT_KERNELS``);
* ``busy_s``, the seconds in which a kernel ran (the union of their
  intervals), and ``window_s``, the traced window's wall time;
* the ten device operations that took most time, and the idle gaps
  between kernels summed by what the host was doing when the device
  went idle (the innermost host operation, with the ``bench.*`` range
  around it);
* ``span_ms``: the device ms of the work launched inside each of the
  program's ``scda.*`` spans, by span name (:func:`span_times`, a frozen
  copy of ``scda_tpu_torch/utils/profile.py``'s ``span_times`` at commit
  93bf85b9b08d: a kernel, copy or fill counts in a span where its
  runtime call, found by correlation id, starts while the span is open,
  on any thread, autograd's included).  Readers take it as
  ``run.trace["span_ms"]``; it is empty where the program opened no span.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    ("optimizer sgd", ("sgd_norm_", "sgd_update_")),
    ("sort/scan/reduce", ("sort", "Sort", "scan", "reduce", "Reduce",
                          "cub::", "topk", "TopK")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise", "fill",
                     "index", "gather", "scatter", "max_pool", "where",
                     "masked")),
)

PORT_KERNELS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("K1 nms_mask", ("nms_mask_kernel",)),
    ("K1 nms_scan", ("nms_scan_kernel",)),
    ("K2 roi_align", ("roi_align_contract_kernel",)),
    ("K2 roi_align_bwd", ("roi_align_contract_bwd_kernel",)),
    ("K3 vgg_stem", ("vgg_stem_bf16_kernel", "vgg_stem_f32_kernel")),
    ("K4 bottleneck_chain", ("chain_wgmma_kernel", "chain_gemm_f32_kernel")),
    ("K4 bottleneck_chain_bwd", ("chain_bwd_",)),
    ("sgd_chain", ("sgd_norm_partial_kernel", "sgd_norm_finish_kernel",
                   "sgd_update_kernel")),
)

Row = Tuple[str, int, float]     # (kernel name, launches, device ms)
RANGE_PREFIX = "bench."
SPAN_PREFIX = "scda."


def _first(key: str, table) -> Optional[str]:
    return next((name for name, words in table
                 if any(w in key for w in words)), None)


def summarize(rows: Sequence[Row], units: int,
              wall_ms_per_unit: float) -> Dict[str, object]:
    """The per-unit numbers of a pass's device kernels ``rows`` over
    ``units`` units whose unprofiled wall time is ``wall_ms_per_unit``."""
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


def trace_units(run: Callable[[], object], sync: Callable[[], None]):
    """One profiler pass over ``run()``: (events, window_s), the window
    being the recorded step's wall time from its first launch to its
    closing ``sync()``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    window_s = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in range(2):
            if step:
                time.sleep(0.05)
            t0 = time.perf_counter()
            run()
            sync()
            window_s = time.perf_counter() - t0
            prof.step()
    return list(prof.events()), window_s


def device_busy_s(run: Callable[[], object], sync: Callable[[], None]) -> float:
    """The seconds in which the device ran work (kernels, copies, fills:
    the union of their intervals) in one recorded ``run()``, after a
    discarded one, as :func:`trace_units` records; the profiler records
    the device's activity alone."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in range(2):
            if step:
                time.sleep(0.05)
            run()
            sync()
            prof.step()
    return _union_us([_span(e) for e in prof.events()
                      if _is_device(e) and not _is_annotation(e)]) / 1e6


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) == "CUDA"


def _is_annotation(e) -> bool:
    return (bool(getattr(e, "is_user_annotation", False))
            or e.name.startswith(RANGE_PREFIX)
            or e.name.startswith("ProfilerStep"))


def _span(e) -> Tuple[float, float]:
    return float(e.time_range.start), float(e.time_range.end)


def _union_us(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t <= end:
            continue
        total += t - max(s, end)
        end = t
    return total


def _range_times(kernels, annotations) -> Dict[str, float]:
    """Device ms of the kernels that run inside each ``bench.*`` range's
    device-side annotation (one stream: they are the range's)."""
    spans = sorted(_span(k) for k in kernels)
    starts = [s for s, _ in spans]
    out: Dict[str, float] = {}
    for a in annotations:
        if not a.name.startswith(RANGE_PREFIX):
            continue
        s0, s1 = _span(a)
        i = bisect.bisect_left(starts, s0 - 1e-3)
        ms = 0.0
        while i < len(spans) and spans[i][0] <= s1 + 1e-3:
            if spans[i][1] <= s1 + 1e-3:
                ms += (spans[i][1] - spans[i][0]) / 1e3
            i += 1
        out[a.name] = out.get(a.name, 0.0) + ms
    return out


def span_times(events, prefix: str = SPAN_PREFIX) -> Dict[str, float]:
    """Device ms of the work launched inside each ``prefix`` span, summed
    by name over its instances: every kernel, copy or fill whose host
    call (the runtime call with its correlation id) starts while the span
    is open, on any thread, so that a step's span holds the kernels
    autograd's thread launches for it.  A kernel counts in every span
    around it."""
    launched = {e.id: _span(e)[0] for e in events
                if not _is_device(e) and e.name.startswith("cu")}
    work = sorted((launched[e.id], (_span(e)[1] - _span(e)[0]) / 1e3)
                  for e in events if _is_device(e) and e.id in launched
                  and not getattr(e, "is_user_annotation", False))
    starts = [t for t, _ in work]
    total = [0.0]
    for _, ms in work:
        total.append(total[-1] + ms)
    out: Dict[str, float] = {}
    for e in events:
        if _is_device(e) or not e.name.startswith(prefix):
            continue
        s0, s1 = _span(e)
        ms = (total[bisect.bisect_right(starts, s1)]
              - total[bisect.bisect_left(starts, s0)])
        out[e.name] = out.get(e.name, 0.0) + ms
    return out


def _gap_labels(gaps, cpu_events, thread) -> List[str]:
    """The innermost host operation on ``thread`` at each gap's start,
    with the ``bench.*`` range around it."""
    evs = sorted((c for c in cpu_events if c.thread == thread),
                 key=lambda c: _span(c)[0])
    labels, stack, ptr = [], [], 0
    for g0, _ in gaps:
        while ptr < len(evs) and _span(evs[ptr])[0] <= g0:
            e = evs[ptr]
            while stack and _span(stack[-1])[1] < _span(e)[0]:
                stack.pop()
            stack.append(e)
            ptr += 1
        while stack and _span(stack[-1])[1] < g0:
            stack.pop()
        inner = stack[-1].name if stack else "outside any host operation"
        rng = next((e.name for e in reversed(stack)
                    if e.name.startswith(RANGE_PREFIX)), None)
        labels.append(inner if rng is None or rng == inner else f"{rng}/{inner}")
    return labels


def read_trace(events, window_s: float, units: int,
               wall_ms_per_unit: float) -> Dict[str, object]:
    """Everything the metric readers take from one traced pass."""
    dev = [e for e in events if _is_device(e)]
    annotations = [e for e in dev if _is_annotation(e)]
    kernels = [e for e in dev if not _is_annotation(e)]
    cpu = [e for e in events if not _is_device(e)]
    rows: Dict[str, List[float]] = {}
    for k in kernels:
        r = rows.setdefault(k.name, [0, 0.0])
        r[0] += 1
        r[1] += (_span(k)[1] - _span(k)[0]) / 1e3
    summary = summarize([(n, c, ms) for n, (c, ms) in rows.items()], units,
                        wall_ms_per_unit)
    spans = sorted(_span(k) for k in kernels)
    busy_us = _union_us(spans)
    ranges = _range_times(kernels, annotations)
    gaps, end = [], None
    for s, t in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = t if end is None else max(end, t)
    units_cpu = [c for c in cpu if c.name == RANGE_PREFIX + "unit"]
    thread = units_cpu[0].thread if units_cpu else None
    idle: Dict[str, float] = {}
    if thread is not None:
        for (g0, g1), label in zip(gaps, _gap_labels(gaps, cpu, thread)):
            idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "summary": summary,
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "range_ms": ranges,
        "device_ops": [[n[:120], ms / 1e3] for n, (_, ms) in top],
        "idle_gaps": [[k[:120], v] for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        "span_ms": span_times(events),
    }

"""Per-layer numbers of a run on the card, from one ``torch.profiler`` pass,
and the program's spans that mark its layers in such a pass.

:func:`profile_pass` profiles a few units of work (served images or train
steps) and returns device time and kernels per unit, the share of each
kind of kernel, the device time of each of the port's CUDA kernels, the
ten longest kernels, and the device busy share.  ``chip_smoke.py`` and
``bench_torch.py`` read the per-layer numbers of their paths from it.
The profiler slows the host about twofold, so the busy share divides the
profiled device time by a wall time the caller measured without it.

:func:`span` marks a layer of the program: a ``scda.<name>`` range that
exists only while a ``torch.profiler`` records, so that an unprofiled run
pays one check of the profiler's state (under 1 us) a span.  Under the
profiler each span is a host range in the same trace and on the same
clock as the kernels, which the runtime calls inside it link to by their
correlation ids.  Its ids (step, request, K4 call) are its keyword
inputs, shown where the profiler records shapes.  :func:`span_times` and
:func:`span_syncs` read a pass's events by span.

| Span | Where | Work under it |
|---|---|---|
| ``scda.train_step`` (``step``) | ``train.steps.make_train_step``'s step | the supervised step |
| ``scda.scda_step`` (``step``) | ``adapt.scda.make_scda_train_step``'s step | the SCDA step |
| ``scda.serve`` (``req``) | ``models.detector.forward_inference`` | one served batch |
| ``scda.backbone`` | ``features`` / ``features_pyramid`` of the source or served image; an FPN model's trunk (C2 .. C5) | K3, cuDNN, K4 |
| ``scda.fpn`` | an FPN model's pyramid (``models.fpn.FPN``) | laterals, top-down adds, output convs, P6 |
| ``scda.rpn`` > ``.level`` (``level``) | ``rpn_out`` and ``make_anchors``; an FPN model's shared head, one ``.level`` a pyramid level | the RPN head |
| ``scda.propose`` > ``.collect`` | ``models.rpn.propose`` (one a level for an FPN model); an FPN model's ``models.fpn.collect`` | K1, sort, top-k |
| ``scda.targets`` > ``.anchor``, ``.roi`` | ``anchor_targets``; ``proposal_targets`` | samplers, target encoding |
| ``scda.roi`` > ``.level`` (``level``, ``rois``) | ``pool_rois`` / ``_pool_ms`` of the sampled rois or proposals; ``models.fpn.pool_levels``, one ``.level`` a pyramid level with the rois it assigns there | K2 |
| ``scda.head`` | ``roi_head`` and the losses | fc6/fc7 or layer4, losses |
| ``scda.postprocess`` | ``models.detector.postprocess`` | decode, per-class K1, top-k |
| ``scda.adapt`` > ``.target``, ``.mine``, ``.patches``, ``.disc`` | ``adapt.scda``: the target tower, mining, region patches, discriminator and BCE | the SCDA layer's forward |
| ``scda.adapt.bwd`` (``step``) | from the adversarial loss's autograd node to the detection loss's | the SCDA layer's backward |
| ``scda.backward``; ``scda.optimizer`` | ``torch.autograd.grad``; ``apply_gradients`` | the backward; both optimizers (``ops.kernels.sgd_kernel``) |
| ``scda.k4`` (``call``, ``stage``); ``scda.k4.bwd`` (the same) | ``ops.kernels.bottleneck_kernel.bottleneck_chain``; its backward | K4; K4's backward |
| ``scda.data.wait``; ``scda.data.h2d`` | ``cli.trainval``'s loop | the loader's next batch; its copy |

A span carries the ids of the spans around it on its thread, so every
span of a step has its ``step``; the backward spans, which run on
autograd's thread on the card, carry the ids their forward saw.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
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
    ("optimizer sgd", ("sgd_norm_", "sgd_update_")),
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
    ("sgd_chain", ("sgd_norm_partial_kernel", "sgd_norm_finish_kernel",
                   "sgd_update_kernel")),
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


# ---- spans -----------------------------------------------------------------

SPAN_PREFIX = "scda."
# The host calls that block until the device has caught up: these four
# always, and a ``cudaMemcpyAsync`` whose copy runs device to host.
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")

_OFF = contextlib.nullcontext()
_local = threading.local()


class _Span:
    """An open ``scda.*`` host range whose keyword inputs are its ids,
    merged over those of the spans around it on the thread that enters
    it; they are that thread's ids until it exits.  The range is a plain
    record (torch 2.4 on), not a user annotation: a user annotation takes
    the kernels launched inside it from the annotations around it, the
    benchmark's ``bench.*`` ranges among them."""

    __slots__ = ("name", "ids", "outer", "rf")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = SPAN_PREFIX + name, ids

    def __enter__(self):
        self.outer = getattr(_local, "ids", {})
        merged = {**self.outer, **self.ids}
        self.rf = torch._C._profiler._RecordFunctionFast(self.name, (), merged)
        self.rf.__enter__()
        _local.ids = merged
        return self

    def __exit__(self, *exc):
        _local.ids = self.outer
        self.rf.__exit__(*exc)
        return False


def span(name: str, **ids):
    """``scda.<name>`` as a context manager while a ``torch.profiler``
    records; otherwise one shared ``contextlib.nullcontext``."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, ids)


def span_ids(**ids) -> Optional[dict]:
    """The ids a span opened here with ``ids`` would carry, for a span
    that opens later on another thread (a backward); None while no
    profiler records."""
    if not torch.autograd._profiler_enabled():
        return None
    return {**getattr(_local, "ids", {}), **ids}


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) == "CUDA"


def _interval(e) -> Tuple[float, float]:
    return float(e.time_range.start), float(e.time_range.end)


def span_times(events, prefix: str = SPAN_PREFIX) -> Dict[str, float]:
    """Device ms of the work launched inside each ``prefix`` span, summed
    by name over its instances: every kernel, copy or fill whose host
    call (the runtime call with its correlation id) starts while the span
    is open, on any thread, so that a step's span holds the kernels
    autograd's thread launches for it.  A kernel counts in every span
    around it."""
    launched = {e.id: _interval(e)[0] for e in events
                if not _is_device(e) and e.name.startswith("cu")}
    work = sorted((launched[e.id], (_interval(e)[1] - _interval(e)[0]) / 1e3)
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
        s0, s1 = _interval(e)
        ms = (total[bisect.bisect_right(starts, s1)]
              - total[bisect.bisect_left(starts, s0)])
        out[e.name] = out.get(e.name, 0.0) + ms
    return out


def blocking_calls(events) -> list:
    """The host-side CUDA runtime calls of ``events`` that block the host
    (:data:`BLOCKING`, and each ``cudaMemcpyAsync`` whose device copy,
    found by its correlation id, runs device to host)."""
    d2h = {e.id for e in events if _is_device(e) and "DtoH" in e.name}
    return [e for e in events if not _is_device(e)
            and (e.name in BLOCKING
                 or (e.name == "cudaMemcpyAsync" and e.id in d2h))]


def span_syncs(events, prefix: str = SPAN_PREFIX) -> Dict[str, int]:
    """By span name, the blocking calls (:func:`blocking_calls`) made on
    the span's thread while it was open (a call counts in every span
    around it)."""
    out: Dict[str, int] = {}
    by_thread: Dict[int, List[float]] = {}
    for c in blocking_calls(events):
        by_thread.setdefault(c.thread, []).append(_interval(c)[0])
    for calls in by_thread.values():
        calls.sort()
    for e in events:
        if _is_device(e) or not e.name.startswith(prefix):
            continue
        calls = by_thread.get(e.thread, [])
        s0, s1 = _interval(e)
        n = bisect.bisect_right(calls, s1) - bisect.bisect_left(calls, s0)
        out[e.name] = out.get(e.name, 0) + n
    return out

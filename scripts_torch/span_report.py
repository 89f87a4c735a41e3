#!/usr/bin/env python3
"""The program's spans in one cell of the benchmark, on the card.

    python scripts_torch/span_report.py --workload vgg16-scda-bs1 \\
        --seed 7 --window 5 --out spans.jsonl

Builds the cell's program objects as ``benchmark/run.py`` does (weights
and inputs from ``--seed``), warms it, times an untraced window of
``--window`` seconds, then runs the benchmark's traced pass
(``benchmark/harness/drive.py``'s ``traced``: its ``bench.*`` ranges
around the call sites, one ``torch.profiler`` pass) and reads it by
program span (``scda_tpu_torch/utils/profile.py``): each span's device ms
and blocking host calls a unit, the per-layer numbers the spans give
(the SCDA layer's share of the unit's device time, the optimizer's and
the targets' ms, blocking calls an image, the kernel library's load), the
idle gaps between kernels by the innermost span the host was in, an FPN
cell's RPN and RoI-Align spans by pyramid level, the K4 spans against
the harness's ``bench.chain`` ranges, which autograd
nodes ran inside ``scda.adapt.bwd``, and the device work each
``scda.optimizer`` span launched: its kernels a step, and the share of
steps that ran ``ops.kernels.sgd_kernel``'s update kernel (100 on the
card).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from scda_tpu_torch.ops.kernels import _build  # noqa: E402
from scda_tpu_torch.utils import profile  # noqa: E402

NODE = "autograd::engine::evaluate_function: "


def cell_unit(cell, seed: int, device):
    """(unit(i), images a unit) of the cell's program, built as
    ``benchmark/harness/kinds/`` builds them."""
    from benchmark.harness import drive, program

    cfg_port, _, weights, d_weights, pool, tgt = drive.prepare(cell, seed,
                                                               device)
    if cell.kind == "serve":
        forward, _ = program.serving(cfg_port, weights, device)
        host = [(b[0], b[1]) for b in pool]

        def unit(i):
            image, info = host[i % len(host)]
            dets = forward(torch.from_numpy(image).to(device),
                           torch.from_numpy(info).to(device))
            return type(dets)(*(t.cpu() for t in dets))
    else:
        state, step = program.training(cfg_port, weights, device, d_weights)

        def unit(i):
            src = drive.to_device(pool[i % len(pool)], device)
            if d_weights is not None:
                return step(state, *src,
                            *drive.to_device(tgt[i % len(tgt)], device))
            return step(state, *src)
    return unit, cell.traffic.batch


def _interval(e):
    return float(e.time_range.start), float(e.time_range.end)


def _stacks(gaps, host):
    """For each gap, the host events of one thread open at its start,
    outermost first."""
    host = sorted(host, key=lambda e: _interval(e)[0])
    out, stack, ptr = [], [], 0
    for g0, _ in gaps:
        while ptr < len(host) and _interval(host[ptr])[0] <= g0:
            e = host[ptr]
            while stack and _interval(stack[-1])[1] < _interval(e)[0]:
                stack.pop()
            stack.append(e)
            ptr += 1
        while stack and _interval(stack[-1])[1] < g0:
            stack.pop()
        out.append(list(stack))
    return out


def _label(stack) -> str:
    """``<bench range>/<innermost scda span>/<innermost operation>``, each
    part left out where it repeats the part before it or there is none."""
    parts = [next((e.name for e in reversed(stack) if e.name.startswith(p)),
                  None) for p in ("bench.", "scda.")]
    parts.append(stack[-1].name if stack else "outside any host operation")
    return "/".join(p for i, p in enumerate(parts)
                    if p is not None and p not in parts[:i])


def gaps_by_span(events, thread) -> dict:
    """Idle seconds between kernels by where the host thread ``thread``
    was at each gap's start (:func:`_label`); where it waited in
    ``scda.backward``, with where autograd's thread was after ``<-``."""
    kernels = sorted(_interval(e) for e in events if profile._is_device(e)
                     and not getattr(e, "is_user_annotation", False)
                     and not e.name.startswith("ProfilerStep"))
    gaps, end = [], None
    for s, t in kernels:
        if end is not None and s > end:
            gaps.append((end, s))
        end = t if end is None else max(end, t)
    host = [e for e in events if not profile._is_device(e)]
    bwd_thread = next((e.thread for e in host if e.name.startswith(NODE)
                       and e.thread != thread), None)
    main = _stacks(gaps, [e for e in host if e.thread == thread])
    bwd = _stacks(gaps, [e for e in host if e.thread == bwd_thread])
    out = {}
    for (g0, g1), m, b in zip(gaps, main, bwd):
        label = _label(m)
        if m and m[-1].name == "scda.backward":
            label += " <- " + _label(b)
        out[label] = out.get(label, 0.0) + (g1 - g0) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def adapt_bwd_nodes(events) -> list:
    """For each ``scda.adapt.bwd``, the autograd nodes run inside it and
    after it in the same backward, by sequence number: ``holds`` where
    every node inside was created after every node run after it (no
    detection-loss node inside, no node of the adversarial loss alone
    after it)."""
    out = []
    for a in (e for e in events if e.name == "scda.adapt.bwd"
              and not profile._is_device(e)):
        a0, a1 = _interval(a)
        end = max((_interval(b)[1] for b in events
                   if b.name == "scda.backward"
                   and _interval(b)[0] <= a0 <= _interval(b)[1]), default=a1)
        nodes = [e for e in events if e.name.startswith(NODE)
                 and e.thread == a.thread and e.sequence_nr >= 0]
        inside = [e.sequence_nr for e in nodes
                  if a0 <= _interval(e)[0] and _interval(e)[1] <= a1]
        after = [e.sequence_nr for e in nodes if a1 < _interval(e)[0] <= end]
        out.append({"inside": len(inside), "after": len(after),
                    "holds": bool(inside) and (not after
                                               or min(inside) > max(after))})
    return out


def layer_numbers(span_ms: dict, span_syncs: dict, device_ms: float,
                  units: int, images: int) -> dict:
    """The per-layer numbers the spans give, per unit (None where the
    spans are missing)."""
    def per_unit(name):
        return span_ms[name] / units if name in span_ms else None

    adapt = [span_ms.get(n) for n in ("scda.adapt", "scda.adapt.bwd")]
    steps = [n for n in ("scda.train_step", "scda.scda_step") if n in span_ms]
    bwd = ("scda.k4.bwd", "scda.adapt.bwd")
    return {
        "adapt_share_pct": (100.0 * sum(adapt) / units / device_ms
                            if None not in adapt and device_ms else None),
        "optimizer_ms": per_unit("scda.optimizer"),
        "targets_ms": per_unit("scda.targets"),
        "syncs_per_img.train": (
            sum(span_syncs.get(n, 0) for n in steps + list(bwd))
            / (units * images) if steps else None),
        "syncs_per_img.serve": (span_syncs.get("scda.serve", 0)
                                / (units * images)
                                if "scda.serve" in span_ms else None),
        "kernel_load_s": _build.first_use["load_s"],
        "kernel_built": _build.first_use["built"],
    }


def fpn_levels(events, units: int) -> dict:
    """The FPN path's per-level spans, ``scda.rpn.level`` and
    ``scda.roi.level``: the device ms of the work launched inside each a
    unit, by pyramid level (the span's ``level`` id where the trace keeps
    ids, else its place among the unit's spans of that name), with the
    rois pooled at each level a unit where the ``rois`` id is kept."""
    from scda_tpu_torch.models import fpn

    work = [e for e in events if not e.name.startswith(profile.SPAN_PREFIX)]
    out = {}
    for name, levels in (("scda.rpn.level", fpn.RPN_LEVELS),
                         ("scda.roi.level", fpn.ROI_LEVELS)):
        found = sorted((e for e in events if e.name == name
                        and not profile._is_device(e)), key=_interval)
        by = {}
        for i, e in enumerate(found):
            ids = getattr(e, "kwinputs", None) or {}
            row = by.setdefault(str(ids.get("level", levels[i % len(levels)])),
                                {"ms": 0.0})
            row["ms"] += profile.span_times(work + [e]).get(name, 0.0) / units
            if ids.get("rois") is not None:
                row["rois"] = row.get("rois", 0.0) + ids["rois"] / units
        if by:
            out[name] = by
    return out


FUSED_KERNEL = "sgd_update_kernel"


def optimizer_kernels(events) -> dict:
    """The ``scda.optimizer`` spans: how many, the device work each
    launched (every kernel, copy or fill whose runtime call starts inside
    it, found by correlation id, as :func:`profile.span_times` finds it)
    a step, and the share of steps that launched a kernel whose name
    holds :data:`FUSED_KERNEL` (the trace gives demangled signatures)."""
    calls = {e.id: _interval(e)[0] for e in events
             if not profile._is_device(e) and e.name.startswith("cu")}
    work = sorted((calls[e.id], e.name) for e in events
                  if profile._is_device(e) and e.id in calls
                  and not getattr(e, "is_user_annotation", False))
    steps = [[name for t, name in work
              if _interval(s)[0] <= t <= _interval(s)[1]]
             for s in events if s.name == "scda.optimizer"
             and not profile._is_device(s)]
    if not steps:
        return {"steps": 0}
    fused = sum(any(FUSED_KERNEL in n for n in names) for names in steps)
    return {"steps": len(steps), "fused_pct": 100.0 * fused / len(steps),
            "launches_per_step": sum(map(len, steps)) / len(steps)}


def report(workload: str, seed: int, window: float, device,
           root: str = ROOT, units: int = 0) -> dict:
    """Everything above for one cell of the benchmark at ``root``, as a
    dict; the traced pass runs ``units`` units (0: the cell's
    ``trace_units``)."""
    from benchmark.harness import drive, program
    from benchmark.harness.spec import Cell
    from benchmark.metrics import profile as bench_profile

    cell = Cell(workload, root)
    unit, images = cell_unit(cell, seed, device)
    for i in range(3):
        unit(i)
    drive.sync(device)
    n, t0 = 3, time.perf_counter()
    while time.perf_counter() - t0 < window:
        unit(n)
        n += 1
    drive.sync(device)
    wall_ms = 1e3 * (time.perf_counter() - t0) / (n - 3)
    units = units or int(cell.traffic.trace_units)
    events, window_s, _ = drive.traced(lambda k: unit(n + k), units, device,
                                       program.CallRecorder())
    t = bench_profile.read_trace(events, window_s, units, wall_ms)
    span_ms = profile.span_times(events)
    span_syncs = profile.span_syncs(events)
    device_ms = t["summary"].get("device_ms_per_unit", 0.0)
    unit_thread = next((e.thread for e in events if e.name == "bench.unit"),
                       None)
    ranges = t["range_ms"]
    return {
        "workload": workload, "seed": seed, "units": units,
        "card": (torch.cuda.get_device_name(device)
                 if torch.device(device).type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "wall_ms_per_unit_untraced": wall_ms,
        "traced_window_ms_per_unit": 1e3 * window_s / units,
        "device_ms_per_unit": device_ms,
        "busy_s": t["busy_s"],
        "layer": layer_numbers(span_ms, span_syncs, device_ms, units, images),
        "span_ms_per_unit": {k: v / units for k, v in sorted(span_ms.items())},
        "span_syncs_per_unit": {k: v / units
                                for k, v in sorted(span_syncs.items())},
        "blocking_calls_per_unit": {
            k: v / units for k, v in sorted(collections.Counter(
                e.name for e in profile.blocking_calls(events)).items())},
        "range_ms_per_unit": {k: v / units for k, v in sorted(ranges.items())},
        "k4_against_bench": {
            "k4": [span_ms.get("scda.k4"), ranges.get("bench.chain")],
            "k4.bwd": [span_ms.get("scda.k4.bwd"),
                       ranges.get("bench.chain_bwd")]},
        "adapt_bwd_nodes": adapt_bwd_nodes(events),
        "optimizer": optimizer_kernels(events),
        "fpn_levels": fpn_levels(events, units),
        "idle_gaps_bench": t["idle_gaps"],
        "idle_gaps_by_span": gaps_by_span(events, unit_thread),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--window", type=float, default=5.0,
                   help="seconds of the untraced window")
    p.add_argument("--units", type=int, default=0,
                   help="units in the traced pass (0: the cell's)")
    p.add_argument("--out", default=None, help="append the JSON line here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    line = json.dumps(report(args.workload, args.seed, args.window,
                             torch.device("cuda", 0), units=args.units))
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

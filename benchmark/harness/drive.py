"""One run of one cell: set-up, the measured window, the traced pass
(``--trace 1``), then the output check.

The traffic mix's ``kind`` names the driver that runs it:
``benchmark/harness/kinds/<kind>.py``, whose ``run(cell, seed, seconds,
trace, device, t_start, faults)`` returns the result's fields.  A kind
that needs code of its own is a new file there; an unknown kind is
refused.  This module holds what every driver shares.

Set-up makes the weights on the device and the inputs on the host from
the seed, builds the program's objects, and warms every shape the window
uses.  ``setup_s`` runs from the process's start to the first timed unit.
The traced pass (after the untraced window, which gives the wall time per
unit it divides by) runs a few units under ``torch.profiler`` with
``bench.*`` ranges around the program's call sites.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import program
from benchmark.harness import weights as W
from benchmark.metrics import profile as prof
from benchmark.traffic import scenes

SETUP_STEPS = 3


def seeds(seed: int):
    """Independent streams of the run's seed: weights, scenes."""
    w, d = np.random.SeedSequence([int(seed)]).generate_state(2)
    return int(w), int(d)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def to_device(arrays, device):
    return [torch.from_numpy(a).to(device) for a in arrays]


class Run(SimpleNamespace):
    """What the metric readers read: ``kind``, ``cfg`` (the benchmark
    configuration), ``traffic``, ``images_per_unit``, ``img_per_s`` and
    ``wall_ms_per_unit`` of the untraced window, ``units`` traced,
    ``trace`` (``metrics.profile.read_trace``), ``chain_calls``."""


def make_inputs(cell, seed: int):
    t = cell.traffic
    w_seed, d_seed = seeds(seed)
    src_seed, tgt_seed = np.random.SeedSequence(d_seed).spawn(2)
    kw = dict(scene_hw=tuple(t.scene_hw), max_objects=t.max_objects,
              num_classes=t.classes, max_gt=cell.cfg.data.max_gt_boxes)
    pool = scenes.batches(cell.cfg.data, src_seed, t.pool, t.batch, **kw)
    tgt = None
    if getattr(t, "target_pool", 0):
        tgt = [b[:2] for b in scenes.batches(cell.cfg.data, tgt_seed,
                                             t.target_pool, t.batch, fog=t.fog,
                                             **kw)]
    return w_seed, pool, tgt


def prepare(cell, seed: int, device):
    """A run's inputs from its seed: the program's configuration, the
    reference's, the weights (and, with a target pool, the
    discriminator's) on ``device``, the source pool and the target pool."""
    w_seed, pool, tgt = make_inputs(cell, seed)
    cfg_port = program.port_config(cell.config_dict, seed)
    cfg_ref = cell.cfg
    cfg_ref.train.seed = int(seed)
    gen = torch.Generator(device=device).manual_seed(w_seed)
    weights = W.make(program.model_layout(cfg_port), gen,
                     he_heads=cell.kind == "serve")
    d_weights = (W.make_discriminator(program.discriminator_layout(cfg_port), gen)
                 if tgt is not None else None)
    return cfg_port, cfg_ref, weights, d_weights, pool, tgt


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, *, faults=None) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``checks``, ``breakdown``).
    ``faults`` hands the driver deliberately broken pieces (the tests of
    the output check)."""
    from benchmark.harness.spec import kind_runner

    return kind_runner(cell.kind, cell.root)(cell, seed, seconds, trace,
                                             device, t_start, faults or {})


def peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def traced(unit, units: int, device, rec):
    """(events, window_s, chain calls of the recorded step), with the
    ``bench.*`` ranges open around the call sites."""
    chains = program.ChainRanges()

    def run():
        chains.calls.clear()
        for i in range(units):
            with torch.profiler.record_function("bench.unit"):
                unit(i)

    with chains.installed(), rec.installed():
        rec.trace = True
        events, window_s = prof.trace_units(run, lambda: sync(device))
        rec.trace = False
    return events, window_s, list(chains.calls)


def device_ms_per_img(unit, units: int, images_per_unit: int, device) -> float:
    """``device_ms_per_img``: the device's busy ms per image over ``units``
    units, a whole cycle of the pool, so that every run of a seed reads
    the same work (:func:`metrics.profile.device_busy_s`).  On a CPU
    device (the tests) the device is the CPU: the cycle's wall time."""
    def cycle():
        for k in range(units):
            unit(k)

    if torch.device(device).type == "cuda":
        busy = prof.device_busy_s(cycle, lambda: sync(device))
    else:
        t0 = time.perf_counter()
        cycle()
        busy = time.perf_counter() - t0
    return 1e3 * busy / (units * images_per_unit)


def trace_pass(cell, unit, units_done: int, window: float, img_per_s: float,
               cfg_ref, device, rec):
    """The traced pass after the window: (per-layer metrics, the
    ``device`` fields, ``breakdown``, the trace's range times)."""
    from benchmark.harness.spec import readers as load_readers

    units = int(cell.traffic.trace_units)
    events, window_s, chains = traced(unit, units, device, rec)
    wall = 1e3 * window / units_done
    t = prof.read_trace(events, window_s, units, wall)
    run = Run(kind=cell.kind, cfg=cfg_ref, traffic=cell.traffic,
              images_per_unit=cell.traffic.batch, img_per_s=img_per_s,
              wall_ms_per_unit=wall, units=units, trace=t, chain_calls=chains)
    layer = {}
    found = load_readers(cell)
    for m in cell.per_layer():
        v = found[m["name"]](run)
        if v is not None:
            layer[m["name"]] = {"value": v, "unit": m["unit"]}
    return (layer, {"busy_s": t["busy_s"], "window_s": t["window_s"]},
            {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]},
            t["range_ms"])


def result(cell, correct, attempted, metrics, device, peak_bytes, checks,
           trace_info=None, breakdown=None, notes=None):
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak_bytes}
    if trace_info is not None:
        dev.update(trace_info)
    out = {"correct": correct, "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if notes:
        out["notes"] = notes
    out["checks"] = checks
    return out


def per_second(ends, window: float):
    """Units that ended in each whole second of the window (host clock)."""
    counts = [0] * max(int(window), 1)
    for t in ends:
        counts[min(int(t), len(counts) - 1)] += 1
    return counts

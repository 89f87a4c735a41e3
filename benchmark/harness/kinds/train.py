"""The driver of training mixes (``kind`` ``train``; ``scda`` runs the same
driver with a target pool and the discriminator).

Set-up runs the first three steps through the window's own step and
feed; the output check follows them.  The window then runs for
``seconds``: each step takes its next host batch from the pool, copies it
to the device with ``.to(device)`` and runs the step; the window ends in
``torch.cuda.synchronize()``.  ``train_img_s`` is the source images of
every step over the window's length.  Where the cell reports
``device_ms_per_img``, an untraced run then takes two cycles of the pool
under a profiler that records the device alone, and the second gives
the device's busy ms per source image (``drive.device_ms_per_img``).
After the window (and the traced pass) the same step object takes one
more step, on the state the window left, which the output check judges
too.  With ``--trace 0`` the result holds the cell's end-to-end metrics
and no others.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import drive, judge, program


def momentum_factors(tc):
    """Each leaf's momentum factor as the optimizers apply it: the
    detector's in its momentum's dtype, the discriminator's (``D.``) as
    the configuration states it."""
    mdt = torch.bfloat16 if tc.momentum_dtype == "bfloat16" else torch.float32
    det = float(torch.tensor(tc.momentum, dtype=mdt))
    return lambda n: float(tc.momentum) if n.startswith("D.") else det


def _clone(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def run(cell, seed, seconds, trace, device, t_start, faults):
    cfg_port, cfg_ref, weights, d_weights, pool, tgt = drive.prepare(
        cell, seed, device)
    scda = d_weights is not None
    batch = cell.traffic.batch
    state, step = program.training(cfg_port, weights, device, d_weights)
    step = faults.get("step", lambda s: s)(step)

    def unit(i):
        src = drive.to_device(pool[i % len(pool)], device)
        if scda:
            return step(state, *src, *drive.to_device(tgt[i % len(tgt)], device))[1]
        return step(state, *src)[1]

    rec = program.CallRecorder()

    def recorded(i):
        """Step ``i`` with its proposal calls recorded: (metrics, calls)."""
        with rec.installed():
            rec.record, mark = True, len(rec.calls)
            m = unit(i)
            rec.record = False
        calls = [(a, o) for site, a, o in rec.calls[mark:] if site == "propose"]
        del rec.calls[mark:]
        return {k: float(v) for k, v in m.items()}, calls

    metrics, calls = [], []
    for i in range(drive.SETUP_STEPS):
        m, c = recorded(i)
        metrics.append(m)
        calls.append(c)
        if i == 0:
            mom1 = _clone(program.momentum_state(state))
    params3 = _clone(program.trainable_state(state))
    drive.sync(device)
    drive.reset_peak(device)
    setup_s = time.perf_counter() - t_start

    i = drive.SETUP_STEPS
    ends = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        unit(i)
        i += 1
        ends.append(time.perf_counter() - t0)
    drive.sync(device)
    window = time.perf_counter() - t0
    steps = i - drive.SETUP_STEPS
    img_per_s = steps * batch / window
    peak = drive.peak(device)

    wanted = {m["name"] for m in cell.end_to_end()}
    layer = trace_info = breakdown = range_ms = dev_ms = None
    if trace:
        layer, trace_info, breakdown, range_ms = drive.trace_pass(
            cell, lambda k: unit(i + k), steps, window, img_per_s, cfg_ref,
            device, rec)
        i += int(cell.traffic.trace_units)
    elif "device_ms_per_img" in wanted:
        dev_ms = drive.device_ms_per_img(lambda k: unit(i + k), len(pool),
                                         batch, device)
        i += len(pool)

    # The step after the window, judged: the state before it, then after.
    names = program.trainable_state(state)
    R = cell.reference
    doubled = set(R.doubled_biases(weights, R.trainable_names(weights, cfg_ref.model),
                                   cfg_ref.train))
    before = {"params": _clone(names),
              "momentum": _clone(program.momentum_state(state)),
              "step": program.step_count(state)}
    w_metrics, w_calls = recorded(i)
    after_p = program.trainable_state(state)
    after_m = program.momentum_state(state)
    mu = momentum_factors(cfg_ref.train)
    window_rec = {
        **before, "metrics": w_metrics, "calls": w_calls,
        "grad": {n: (after_m[n].float() - mu(n) * before["momentum"][n].float())
                 / (2.0 if n in doubled else 1.0) for n in after_m},
        "delta": {n: after_p[n].detach().float() - before["params"][n].float()
                  for n in after_p}}
    pool_i = i

    # The program's state goes before the reference runs.
    rec_out = {"metrics": metrics,
               "first_grad": R.first_gradient(mom1, doubled),
               "params": params3, "calls": calls, "window": window_rec}
    del state, step, names, after_p, after_m, mom1
    drive.free(device)
    window_rec["batch"] = (
        tuple(drive.to_device(pool[pool_i % len(pool)], device)),
        tuple(drive.to_device(tgt[pool_i % len(tgt)], device)) if scda else None)
    batches = [(tuple(drive.to_device(pool[k], device)),
                tuple(drive.to_device(tgt[k], device)) if scda else None)
               for k in range(drive.SETUP_STEPS)]
    numbers = judge.judge_train(rec_out, weights, d_weights, batches, cfg_ref,
                                seed, ref=R)
    correct, checks = judge.verdict(numbers, cell.limits, cell.not_compared)
    if trace:
        metrics_out = layer
    else:
        every = {"train_img_s": {"value": img_per_s, "unit": "images/s"},
                 "setup_s": {"value": setup_s, "unit": "s"},
                 "device_ms_per_img": {"value": dev_ms, "unit": "ms"}}
        metrics_out = {k: v for k, v in every.items() if k in wanted}
    notes = {"steps": steps, "window_s": window, "img_per_s": img_per_s,
             "setup_s": setup_s,
             "per_second": drive.per_second(ends, window),
             "losses": [m["loss"] for m in metrics],
             "ref_losses": numbers["_ref_losses"],
             "window_step": before["step"],
             "left_out_leaves": numbers["_left_out_leaves"]}
    if trace:
        notes.update(range_ms=range_ms)
    return drive.result(cell, correct, steps, metrics_out, device, peak, checks,
                        trace_info, breakdown, notes)

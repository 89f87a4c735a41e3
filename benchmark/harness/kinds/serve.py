"""The driver of serving mixes (``kind`` ``serve``): closed loop, one
client.

Each request hands the program a host canvas (a batch of ``batch``) and
ends when its detections are on the host.  ``serve_img_s`` is every image
served over the window's length, ``serve_p95_ms`` the 95th percentile of
every request's latency.  Nothing of the harness wraps the program inside
the window.  After it (and the traced pass) each pool entry is served
once more on the same model with the call sites recorded; the output
check judges that request, and every window request of the entry has to
equal it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import drive, judge, program


def run(cell, seed, seconds, trace, device, t_start, faults):
    cfg_port, cfg_ref, weights, _, pool, _ = drive.prepare(cell, seed, device)
    batch = cell.traffic.batch
    forward, model = program.serving(cfg_port, weights, device)
    forward = faults.get("forward", lambda f: f)(forward)
    host = [(b[0], b[1]) for b in pool]

    def request(i):
        image, info = host[i % len(host)]
        dets = forward(torch.from_numpy(image).to(device),
                       torch.from_numpy(info).to(device))
        return type(dets)(*(t.cpu() for t in dets))

    for i in range(min(int(cell.traffic.warm_requests), len(host))):
        request(i)
    drive.sync(device)
    drive.reset_peak(device)
    outputs = [[] for _ in host]
    lat, ends = [], []
    setup_s = time.perf_counter() - t_start
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        r0 = time.perf_counter()
        dets = request(n)
        lat.append(time.perf_counter() - r0)
        ends.append(r0 + lat[-1] - t0)
        outputs[n % len(host)].append(dets)
        n += 1
    window = time.perf_counter() - t0
    img_per_s = n * batch / window
    p95_ms = 1e3 * float(np.percentile(np.asarray(lat), 95))
    peak = drive.peak(device)

    rec = program.CallRecorder()
    layer = trace_info = breakdown = range_ms = None
    if trace:
        layer, trace_info, breakdown, range_ms = drive.trace_pass(
            cell, lambda k: request(n + k), n, window, img_per_s, cfg_ref,
            device, rec)

    judged = {}
    with rec.installed():
        for slot, outs in enumerate(outputs):
            if outs:
                rec.slot = slot
                rec.latest[slot] = []
                judged[slot] = request(slot)
        rec.slot = None

    del model, forward
    drive.free(device)
    entries = []
    for slot, dets in judged.items():
        differ = sum(0 if all(torch.equal(a, b) for a, b in zip(o, dets))
                     else 1 for o in outputs[slot])
        image, info = host[slot]
        entries.append({"image": torch.from_numpy(image).to(device),
                        "im_info": torch.from_numpy(info).to(device),
                        "calls": rec.latest[slot], "dets": dets,
                        "repeats_differing": differ})
    numbers = judge.judge_serve(entries, weights, cfg_ref, ref=cell.reference)
    correct, checks = judge.verdict(numbers, cell.limits, cell.not_compared)
    if trace:
        metrics_out = layer
    else:
        metrics_out = {"serve_img_s": {"value": img_per_s, "unit": "images/s"},
                       "serve_p95_ms": {"value": p95_ms, "unit": "ms"},
                       "setup_s": {"value": setup_s, "unit": "s"}}
    notes = {"requests": n, "window_s": window, "setup_s": setup_s,
             "per_second": drive.per_second(ends, window),
             "p50_ms": 1e3 * float(np.percentile(np.asarray(lat), 50))}
    if trace:
        notes.update(range_ms=range_ms)
    return drive.result(cell, correct, n, metrics_out, device, peak, checks,
                        trace_info, breakdown, notes)

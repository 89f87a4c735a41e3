"""The output check's controls: the reference itself (the module the
cell's configuration names, ``cell.reference``), computed in a lower
precision (``reference.precision``), put in the program's place on a
run's own weights and inputs, and judged by ``judge`` as the program is.

``fp8`` (fp8 products forward and backward, the step below the bf16 the
configurations state) is the control the limits are set against: it has
to come out not correct.  ``bf16`` (every product in bf16, forward and
backward) and ``fp8_bwd`` (a bf16 forward, an fp8 backward) are read for
the training cells, to show which numbers see the backward's precision
(``PERF.md``).

Training: the control runs the first three steps with its own proposals,
then one more step from its own state, judged as the step after the
window is.  Serving: it serves each pool entry once, as a run judges one
request of each.
"""

from __future__ import annotations

import torch

from benchmark.harness import drive, judge
from benchmark.reference.precision import BY_NAME, FP8


def control_numbers(cell, seed: int, device, prec=FP8) -> dict:
    if isinstance(prec, str):
        prec = BY_NAME[prec]
    R = cell.reference
    _, cfg, weights, d_weights, pool, tgt = drive.prepare(cell, seed, device)
    to = lambda arrays: tuple(torch.from_numpy(a).to(device) for a in arrays)
    if cell.kind == "serve":
        entries = []
        for image, info, *_ in pool:
            image, info = to((image, info))
            out = R.serve(weights, image, info, cfg, prec)
            (args, props), = out["calls"]
            calls = [("propose", args, props),
                     ("postprocess", (props, *out["head"], info, cfg.test),
                      out["dets"])]
            entries.append({"image": image, "im_info": info, "calls": calls,
                            "dets": tuple(t.cpu() for t in out["dets"]),
                            "repeats_differing": 0})
        return judge.judge_serve(entries, weights, cfg, ref=R)
    pair = lambda k: (to(pool[k % len(pool)]),
                      to(tgt[k % len(tgt)]) if tgt is not None else None)
    k = drive.SETUP_STEPS
    batches = [pair(i) for i in range(k)]
    rec = R.train_steps(weights, d_weights, batches, cfg, prec, seed, k)
    p_det, p_d = judge.split_discriminator(rec["params"])
    last = R.train_steps({**weights, **p_det}, p_d or None, [pair(k)], cfg,
                         prec, seed, 1, step0=k, momentum=rec["momentum"],
                         d_momentum=rec.get("d_momentum"))
    momentum = {**rec["momentum"],
                **{"D." + n: v for n, v in rec.get("d_momentum", {}).items()}}
    rec["window"] = {
        "params": rec["params"], "momentum": momentum, "step": k,
        "batch": pair(k), "metrics": last["metrics"][0],
        "calls": list(last["calls"][0]), "grad": last["last_grad"],
        "delta": {n: last["params"][n] - rec["params"][n] for n in last["params"]}}
    return judge.judge_train(rec, weights, d_weights, batches, cfg, seed,
                             ref=R)

"""The output check: what the timed path produced, against the plain
f32 reference (``benchmark/reference``: the module the cell's
configuration names, passed in as ``ref``), as numbers each held to a
limit of its own (``benchmark/limits/<workload>.json``).

Every number is a gap; a run is correct when each is at most its limit.
A number with no limit on file fails.

The proposal layer keeps boxes greedily among near-tied scores, so its
choice flips on rounding.  The reference therefore follows the program
through it: it takes the program's proposals (the program's outputs,
which it reads only to judge them), and checks the layer apart:

* ``rpn_gap``: the program's RPN outputs, the proposal layer's inputs,
  against the reference's own (the backbone and the RPN head): max |d|
  over the reference's largest magnitude, the worse of logits and deltas;
* ``propose_mismatch``: the reference's proposal layer run on the
  program's RPN outputs gives the program's proposals: slots that differ
  (exact, limit 0).

Training: the first three steps, which ran through the window's own step
and feed on three different batches; the reference follows them from the
same weights, inputs and random streams:

* ``loss_gap``: max over the steps of |loss - ref| / |ref|;
* ``grad_gap``: the first step's gradient as the optimizer took it in
  (clipped, with weight decay: its momentum after one step over the bias
  factor), leaf by leaf: max of
  | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
* ``update_gap``: the gap of norms of each leaf's change over the three
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (moved by round-off alone).

And the step after the window, on the window's own step object and the
state the window left (its parameters, momentum and step count, taken
before it; the reference replays that one step from them, since only the
program's own state after hundreds of steps leads there):
``window_loss_gap``, ``window_grad_gap`` (its gradient as the optimizer
took it in, from the momentum before and after) and
``window_update_gap`` (each leaf's change in that step), as above.  Its
proposal calls count in ``rpn_gap`` and ``propose_mismatch``.

Serving: after the window, one judged request of each pool entry on the
same model, with the proposal-layer and postprocess call sites recorded
(no wrapper runs inside the window).  The per-class NMS and the top
detections choose among near ties as the proposal layer does, so the
check follows the program through them too:

* ``head_gap``: the program's RoI-head outputs (class logits and box
  deltas, the postprocess's inputs) against the reference's own on the
  program's proposals (pooling, the head): max |d| over the reference's
  largest magnitude, the worse of the two;
* ``post_mismatch``: the reference's postprocess (softmax, per-class
  decode, NMS, top detections) on the program's head outputs gives the
  detections the request returned: slots that differ (exact, limit 0);
* ``repeat_mismatch``: window requests whose detections differ from
  their pool entry's judged request (exact, limit 0).

``entries_not_followed``: pool entries whose judged request did not
reach both call sites (a forward replayed from a captured graph calls no
Python function); with nothing to follow, such an entry is not judged
correct (limit 0).  Judged end to end instead, against the reference's
own proposals, the detections of sound runs differ about as much as the
fp8 control's do (``PERF.md``), so no end-to-end number can stand in.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List

import torch

from benchmark.reference import detect as D
from benchmark.reference.precision import F32


def _props(p) -> D.Proposals:
    return D.Proposals(p.boxes.float(), p.scores.float(), p.valid)


def _rel_gap(a, b) -> float:
    a, ref = a.detach(), b.detach().float()
    return float((a.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def propose_checks(prog_calls, ref_calls) -> Dict[str, float]:
    """``rpn_gap`` and ``propose_mismatch`` over matching lists of
    ((rpn_cls, rpn_bbox, anchors, im_info, pc), proposals) calls."""
    rpn, mism = 0.0, 0
    for (pa, po), (ra, _) in zip(prog_calls, ref_calls):
        rpn = max(rpn, _rel_gap(pa[0], ra[0]), _rel_gap(pa[1], ra[1]))
        again = D.propose(pa[0].float(), pa[1].float(), pa[2], pa[3], pa[4])
        po = _props(po)
        same = ((again.boxes == po.boxes).all(-1)
                & (again.valid == po.valid)
                & ((again.scores == po.scores) | ~po.valid))
        mism += int((~same).sum())
    return {"rpn_gap": rpn, "propose_mismatch": float(mism)}


def _median(xs):
    return statistics.median(xs) if xs else 0.0


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep=None) -> float:
    names = [n for n in ref if keep is None or keep(n)]
    rn = {n: float(ref[n].float().norm()) for n in names}
    pn = {n: float(prog[n].float().norm()) for n in names}
    med = _median(list(rn.values()))
    return max((abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names),
               default=0.0)


def split_discriminator(tensors: Dict[str, torch.Tensor]):
    """(the detector's, the discriminator's without its ``D.`` prefix)."""
    det = {k: v for k, v in tensors.items() if not k.startswith("D.")}
    d = {k[2:]: v for k, v in tensors.items() if k.startswith("D.")}
    return det, d


def judge_window_step(w: dict, weights, cfg, seed: int, *, ref) -> dict:
    """The step after the window: ``w`` holds ``params`` and ``momentum``
    (the trainable leaves and their momentum before it, the
    discriminator's as ``D.<name>``), ``step`` (its count), ``batch``,
    ``metrics``, ``grad`` (its gradient as the optimizer took it in),
    ``delta`` (each leaf's change) and ``calls`` (its proposal calls)."""
    p_det, p_d = split_discriminator(w["params"])
    m_det, m_d = split_discriminator(w["momentum"])
    props = tuple(_props(o) for _, o in w["calls"])
    r_out = ref.train_steps({**weights, **p_det}, p_d or None, [w["batch"]],
                            cfg, F32, seed, 1, proposals=[props],
                            step0=w["step"], momentum=m_det,
                            d_momentum=m_d or None)
    rg = r_out["last_grad"]
    g_norm = {n: float(rg[n].norm()) for n in rg}
    med = _median(list(g_norm.values()))
    moved = lambda n: g_norm[n] >= 1e-3 * med
    d_ref = {n: r_out["params"][n].float() - w["params"][n].float() for n in rg}
    r_loss = r_out["metrics"][0]["loss"]
    return {"window_loss_gap": abs(w["metrics"]["loss"] - r_loss)
            / max(abs(r_loss), 1e-30),
            "window_grad_gap": leaf_gap(w["grad"], rg),
            "window_update_gap": leaf_gap(w["delta"], d_ref, moved),
            "_calls": (list(w["calls"]), r_out["calls"][0])}


def judge_train(rec: dict, weights, d_weights, batches, cfg, seed: int, *,
                ref) -> dict:
    """``rec``: the program's (or a control's) first three steps:
    ``metrics`` (a dict a step), ``first_grad``, ``params`` (after the
    last step), ``calls`` (a list of propose calls a step); and where it
    has ``window``, the step after the window (:func:`judge_window_step`)."""
    steps = len(rec["metrics"])
    props = [tuple(_props(o) for _, o in calls) for calls in rec["calls"]]
    r_out = ref.train_steps(weights, d_weights, batches, cfg, F32, seed, steps,
                            proposals=props)
    ref_losses = [r["loss"] for r in r_out["metrics"]]
    loss = max(abs(m["loss"] - r["loss"]) / max(abs(r["loss"]), 1e-30)
               for m, r in zip(rec["metrics"], r_out["metrics"]))
    rg = r_out["first_grad"]
    g_norm = {n: float(rg[n].norm()) for n in rg}
    med = _median(list(g_norm.values()))
    moved = lambda n: g_norm[n] >= 1e-3 * med
    start = {**weights, **({"D." + k: v for k, v in d_weights.items()}
                           if d_weights is not None else {})}
    d_prog = {n: rec["params"][n].float() - start[n].float() for n in rg}
    d_ref = {n: r_out["params"][n].float() - start[n].float() for n in rg}
    out = {"loss_gap": loss,
           "grad_gap": leaf_gap(rec["first_grad"], rg),
           "update_gap": leaf_gap(d_prog, d_ref, moved)}
    prog_calls = [c for calls in rec["calls"] for c in calls]
    ref_calls = [c for calls in r_out["calls"] for c in calls]
    del r_out, d_prog, d_ref
    if "window" in rec:
        win = judge_window_step(rec["window"], weights, cfg, seed, ref=ref)
        p_calls, r_calls = win.pop("_calls")
        prog_calls += p_calls
        ref_calls += r_calls
        out.update(win)
    out.update(propose_checks(prog_calls, ref_calls))
    out["_ref_losses"] = ref_losses
    out["_left_out_leaves"] = sorted(n for n in rg if not moved(n))
    return out


def _iou(a, b) -> torch.Tensor:
    return D.overlaps(a[None].float(), b[None].float())[0]


def _same_detections(a, b) -> int:
    """Detection slots of two (boxes, scores, classes, valid) sets that
    differ, exactly (classes, boxes and scores compared where valid)."""
    ab, as_, ac, av = (t.cpu() for t in a)
    bb, bs, bc, bv = (t.cpu() for t in b)
    same = (av == bv) & (~av | ((ac == bc) & (as_ == bs) & (ab == bb).all(-1)))
    return int((~same).sum())


def judge_serve(entries: List[dict], weights, cfg, *, ref) -> dict:
    """``entries``: one a pool entry: ``image``, ``im_info`` (device),
    ``calls`` (the judged request's recorded (site, arguments, output)
    calls), ``dets`` (its detections, on the host), ``repeats_differing``
    (window requests of the entry whose detections differ from them)."""
    prog_calls, ref_calls = [], []
    head = 0.0
    post = 0
    repeat = 0
    followed = 0
    for e in entries:
        repeat += e["repeats_differing"]
        by_site = {site: (args, out) for site, args, out in e["calls"]}
        if "propose" not in by_site or "postprocess" not in by_site:
            continue
        followed += 1
        prop_args, prop_out = by_site["propose"]
        (props, cls, deltas, im_info, _), _ = by_site["postprocess"]
        r_out = ref.serve(weights, e["image"], e["im_info"], cfg, F32,
                          proposals=_props(prop_out))
        prog_calls.append((prop_args, prop_out))
        ref_calls.extend(r_out["calls"])
        head = max(head, _rel_gap(cls, r_out["head"][0]),
                   _rel_gap(deltas, r_out["head"][1]))
        props = _props(props)
        again = D.postprocess(props, *D.class_boxes(props, cls, deltas, im_info,
                                                    cfg), im_info, cfg)
        post += _same_detections(e["dets"], again)
    out = {"repeat_mismatch": float(repeat),
           "entries_not_followed": float(len(entries) - followed)}
    if followed:
        out.update({"head_gap": head, "post_mismatch": float(post)})
        out.update(propose_checks(prog_calls, ref_calls))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            not_compared=()):
    """(correct, {name: {"value", "limit"}}) for the numbers that count
    (names that start with ``_`` are notes, not numbers).  A number the
    limits file lists as not compared is reported with the limit None
    and fails nothing; any other number without a limit fails."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        if name.startswith("_"):
            continue
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if name in not_compared:
            checks[name]["compared"] = False
        elif limit is None or not value <= limit:
            ok = False
    return ok, checks


def print_checks(checks) -> None:
    for name, c in checks.items():
        limit = c["limit"] if c.get("compared", True) else "not compared"
        print(f"check {name} {c['value']!r} limit {limit}", file=sys.stderr,
              flush=True)

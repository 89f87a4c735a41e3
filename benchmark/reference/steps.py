"""The reference's entries: a served forward with its detections, and the
source-only and SCDA train steps with their optimizers.

Frozen arithmetic copied from ``scda_tpu_torch/models/detector.py``,
``train/steps.py``, ``train/state.py`` and ``adapt/scda.py`` at commit
8b959ad8dec4.  The step's random streams are worked out from (seed,
step) as the program's are: ``numpy.random.SeedSequence([seed,
step]).generate_state(n)`` seeds one ``torch.Generator`` a stream on the
device, and every draw has the program's shape and order, so both sides
draw the same uniforms.

``proposals=`` hands a step or a forward the proposals it is to use in
place of its own: the output check follows the program step by step
through the proposal layer, whose greedy choice among near-tied scores
flips on rounding (the layer itself is checked apart, on the program's
own RPN outputs).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference import detect as D
from benchmark.reference import nets as N
from benchmark.reference import scda as S
from benchmark.reference.precision import Precision


class StepGens(NamedTuple):
    anchor: torch.Generator
    roi: torch.Generator
    dropout: torch.Generator
    mine_src: Optional[torch.Generator] = None
    mine_tgt: Optional[torch.Generator] = None


def step_gens(seed: int, step: int, device, scda: bool) -> StepGens:
    seeds = np.random.SeedSequence([seed, step]).generate_state(5 if scda else 3)
    return StepGens(*(torch.Generator(device=device).manual_seed(int(s))
                      for s in seeds))


def _rand(gen: torch.Generator, shape, device):
    return torch.rand(tuple(shape), generator=gen, device=gen.device).to(device)


# ---- serving ---------------------------------------------------------------

@torch.no_grad()
def serve(P, image, im_info, cfg, prec: Precision,
          proposals: Optional[D.Proposals] = None) -> dict:
    """One served batch: the RPN's outputs, the proposals (its own or
    ``proposals``), every (proposal, class) probability and box, and the
    detections."""
    mc = cfg.model
    if mc.multiscale_roi:
        f8, f16 = N.features(P, image, mc, prec, pyramid=True)
    else:
        f8, f16 = None, N.features(P, image, mc, prec)
    rpn_cls, rpn_bbox = N.rpn_out(P, f16, prec, len(cfg.anchors.scales)
                                  * len(cfg.anchors.ratios))
    anchors = D.anchors_for(cfg, tuple(f16.shape[1:3]), image.device)
    props = proposals or D.propose(rpn_cls, rpn_bbox, anchors, im_info,
                                   cfg.test.proposal)
    calls = [((rpn_cls, rpn_bbox, anchors, im_info, cfg.test.proposal), props)]
    pooled = (N.pool_multiscale(f8, f16, props.boxes, mc) if mc.multiscale_roi
              else N.pool(f16, props.boxes, mc))
    cls, bbox = N.roi_head(P, pooled, mc, prec)
    probs, boxes = D.class_boxes(props, cls, bbox, im_info, cfg)
    return {"calls": calls, "props": props, "head": (cls, bbox),
            "probs": probs, "boxes": boxes,
            "dets": D.postprocess(props, probs, boxes, im_info, cfg)}


# ---- training --------------------------------------------------------------

class Forward(NamedTuple):
    loss: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    props: D.Proposals
    feat: torch.Tensor
    propose_calls: list


def train_forward(P, batch, cfg, prec: Precision, gens: StepGens,
                  proposals: Optional[D.Proposals] = None) -> Forward:
    image, im_info, gt, num = batch
    mc = cfg.model
    if mc.multiscale_roi:
        f8, feat = N.features(P, image, mc, prec, pyramid=True)
    else:
        f8, feat = None, N.features(P, image, mc, prec)
    rpn_cls, rpn_bbox = N.rpn_out(P, feat, prec, len(cfg.anchors.scales)
                                  * len(cfg.anchors.ratios))
    anchors = D.anchors_for(cfg, tuple(feat.shape[1:3]), feat.device)
    props = proposals or D.propose(rpn_cls.detach(), rpn_bbox.detach(),
                                   anchors, im_info, cfg.train.proposal)
    b, k = gt.shape[0], anchors.shape[0]
    labels, targets, in_w, out_w = D.anchor_targets(
        anchors, gt, num, im_info, cfg.train.rpn_target,
        _rand(gens.anchor, (b, 2, k), gt.device))
    rpn_cls_l, rpn_box_l = D.rpn_losses(rpn_cls, rpn_bbox, labels, targets,
                                        in_w, out_w)
    n = props.boxes.shape[1] + gt.shape[1]
    samples = D.proposal_targets(props.boxes, props.valid, gt, num,
                                 cfg.train.roi_target,
                                 _rand(gens.roi, (b, 2, n), gt.device))
    pooled = (N.pool_multiscale(f8, feat, samples.rois, mc) if mc.multiscale_roi
              else N.pool(feat, samples.rois, mc))
    cls, deltas = N.roi_head(P, pooled, mc, prec, train=True,
                             generator=gens.dropout)
    rcnn_cls_l, rcnn_box_l = D.rcnn_losses(cls, deltas, samples, mc.num_classes,
                                           mc.class_agnostic)
    total = rpn_cls_l + rpn_box_l + rcnn_cls_l + rcnn_box_l
    metrics = {"loss": total, "rpn_cls": rpn_cls_l, "rpn_box": rpn_box_l,
               "rcnn_cls": rcnn_cls_l, "rcnn_box": rcnn_box_l}
    return Forward(total, metrics, props, feat,
                   [((rpn_cls.detach(), rpn_bbox.detach(), anchors, im_info,
                      cfg.train.proposal), props)])


def scda_forward(P, Dw, src, tgt, cfg, prec: Precision, gens: StepGens,
                 proposals=None) -> Forward:
    """The SCDA objective (``adapt.d_update`` joint or alternating) over
    one source and one target batch; ``proposals`` = (source, target)."""
    ac = cfg.adapt
    mc = cfg.model
    det = train_forward(P, src, cfg, prec, gens,
                        None if proposals is None else proposals[0])
    tgt_image, tgt_info = tgt
    feat_t = N.features(P, tgt_image, mc, prec)
    with torch.no_grad():
        rpn_t = N.rpn_out(P, feat_t, prec, len(cfg.anchors.scales)
                          * len(cfg.anchors.ratios))
    anchors = D.anchors_for(cfg, tuple(feat_t.shape[1:3]), feat_t.device)
    pc = cfg.train.proposal
    tgt_pc = type(pc)(**{**vars(pc), "post_nms_top_n": min(
        pc.post_nms_top_n, max(int(ac.mining_top_n), 1))})
    props_t = (proposals[1] if proposals is not None
               else D.propose(*rpn_t, anchors, tgt_info, tgt_pc))
    ms = S.mine(det.props.boxes, det.props.valid, ac, gens.mine_src)
    mt = S.mine(props_t.boxes, props_t.valid, ac, gens.mine_tgt)

    def patches(feat, mined):
        boxes, w, v = mined
        return (N.pool(feat, boxes, mc, output_size=ac.region_pool_size).float(),
                w.reshape(-1), v.reshape(-1))

    (p_s, w_s, v_s), (p_t, w_t, v_t) = patches(det.feat, ms), patches(feat_t, mt)
    metrics = dict(det.metrics)
    if ac.d_update == "joint":
        ls = S.weighted_bce(S.discriminator(
            Dw, S.GradReverse.apply(p_s, float(ac.grl_weight)), prec), w_s, v_s, 1)
        lt = S.weighted_bce(S.discriminator(
            Dw, S.GradReverse.apply(p_t, float(ac.grl_weight)), prec), w_t, v_t, 0)
        adv = 0.5 * (ls + lt)
        total = det.loss + ac.adv_weight * adv
        metrics.update(adv=adv, loss=total)
    else:
        d_loss = 0.5 * (S.weighted_bce(S.discriminator(Dw, p_s.detach(), prec),
                                       w_s, v_s, 1)
                        + S.weighted_bce(S.discriminator(Dw, p_t.detach(), prec),
                                         w_t, v_t, 0))
        frozen = {k: v.detach() for k, v in Dw.items()}
        adv = 0.5 * (S.weighted_bce(S.discriminator(frozen, p_s, prec), w_s, v_s, 0)
                     + S.weighted_bce(S.discriminator(frozen, p_t, prec),
                                      w_t, v_t, 1))
        total = det.loss + ac.adv_weight * adv + d_loss
        metrics.update(adv=adv, d_loss=d_loss, loss=det.loss + ac.adv_weight * adv)
    calls = det.propose_calls + [((rpn_t[0], rpn_t[1], anchors, tgt_info,
                                   tgt_pc), props_t)]
    return Forward(total, metrics, det.props, det.feat, calls)


def is_buffer(P, key: str) -> bool:
    """Frozen batch norms hold buffers, not parameters."""
    return key.rsplit(".", 1)[0] + ".running_mean" in P


def trainable_names(P, mc) -> List[str]:
    frozen = N.frozen_prefixes(mc)
    return [k for k in P if not is_buffer(P, k)
            and not any(k == p or k.startswith(p + ".") for p in frozen)]


def lr_at(tc, count: int, steps_per_epoch: int = 1000) -> float:
    boundaries = []
    e = tc.lr_decay_step
    while e <= tc.max_epochs:
        boundaries.append(e * steps_per_epoch)
        e += tc.lr_decay_step
    v, gamma = np.float32(tc.learning_rate), np.float32(tc.gamma)
    for t in boundaries:
        if count >= t:
            v = np.float32(gamma * v)
    return float(v)


def _is_bias(P, n: str) -> bool:
    return n.endswith(".bias") and P[n].dim() == 1


def doubled_biases(P, names, tc) -> List[str]:
    """The leaves whose gradient the chain doubles."""
    return [n for n in names if _is_bias(P, n)] if tc.double_bias else []


class Sgd:
    """The detector's optimizer chain: global-norm clip, weight decay,
    doubled bias gradients, momentum, the step's learning rate."""

    def __init__(self, P, names, tc, momentum=None):
        self.tc = tc
        self.names = names
        self.decay = [n for n in names if tc.bias_decay or not _is_bias(P, n)]
        self.bias = doubled_biases(P, names, tc)
        dt = torch.bfloat16 if tc.momentum_dtype == "bfloat16" else torch.float32
        self.mdt = dt
        self.momentum = {n: (torch.zeros_like(P[n], dtype=dt) if momentum is None
                             else momentum[n].detach().to(dt).clone())
                         for n in names}

    @torch.no_grad()
    def processed(self, P, grads):
        """The gradients as the momentum takes them in."""
        tc = self.tc
        g = {n: grads[n].float() for n in self.names}
        if tc.clip_gradients > 0:
            norm = torch.sqrt(torch.stack([t.square().sum() for t in g.values()]).sum())
            keep = norm < tc.clip_gradients
            one = torch.ones_like(norm)
            div = torch.where(keep, one, norm)
            mul = torch.where(keep, one, torch.full_like(norm, tc.clip_gradients))
            g = {n: (t / div) * mul for n, t in g.items()}
        for n in self.decay:
            g[n] = g[n] + P[n] * tc.weight_decay
        for n in self.bias:
            g[n] = 2.0 * g[n]
        return g

    @torch.no_grad()
    def step(self, P, grads, count: int) -> Dict[str, torch.Tensor]:
        """One update; returns the gradients as the momentum took them in,
        each doubled leaf's halved again."""
        g = self.processed(P, grads)
        m = float(torch.tensor(self.tc.momentum, dtype=self.mdt))
        lr = lr_at(self.tc, count)
        for n in self.names:
            trace = g[n] + m * self.momentum[n]
            self.momentum[n].copy_(trace)
            P[n].add_(trace * -lr)
        return {n: g[n] / (2.0 if n in self.bias else 1.0) for n in self.names}


def first_gradient(momentum, doubled) -> Dict[str, torch.Tensor]:
    """The first step's gradient as the optimizer took it in (clipped,
    with weight decay), worked out from the momentum after one step: the
    momentum over the bias factor (``doubled`` leaves' gradients were
    doubled).  A step that leaves the state unchanged gives zeros."""
    return {n: m.float().clone() / (2.0 if n in doubled else 1.0)
            for n, m in momentum.items()}


def train_steps(P0, D0, batches, cfg, prec: Precision, seed: int, steps: int,
                proposals=None, step0: int = 0, momentum=None,
                d_momentum=None) -> dict:
    """``steps`` steps from the weights ``P0`` (and the discriminator's
    ``D0`` for SCDA) on ``batches`` (one (source, target-or-None) pair a
    step), the first being step ``step0`` of the run (its random streams
    and learning rate) with the optimizers' ``momentum`` and
    ``d_momentum`` (zero where None).  Returns each step's metrics, the
    first and the last step's gradient of each trainable leaf as the
    optimizer took it, the parameters after the last step, and each
    step's proposal calls."""
    dev = batches[0][0][0].device
    scda = D0 is not None
    P = {k: v.detach().clone().float() for k, v in P0.items()}
    names = trainable_names(P, cfg.model)
    for n in names:
        P[n].requires_grad_(True)
    Dw = None
    d_mom = None
    if scda:
        Dw = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in D0.items()}
        d_mom = {k: (torch.zeros_like(v) if d_momentum is None
                     else d_momentum[k].detach().float().clone())
                 for k, v in Dw.items()}
    sgd = Sgd(P, names, cfg.train, momentum)
    out = {"metrics": [], "calls": []}
    for i in range(steps):
        gens = step_gens(seed, step0 + i, dev, scda)
        props = None if proposals is None else proposals[i]
        if scda:
            src, tgt = batches[i]
            fwd = scda_forward(P, Dw, src, tgt, cfg, prec, gens, props)
        else:
            fwd = train_forward(P, batches[i][0], cfg, prec, gens,
                                None if props is None else props[0])
        leaves = [P[n] for n in names] + (list(Dw.values()) if scda else [])
        grads = torch.autograd.grad(fwd.loss, leaves, materialize_grads=True)
        out["metrics"].append({k: float(v.detach()) for k, v in fwd.metrics.items()})
        out["calls"].append(fwd.propose_calls)
        taken = sgd.step(P, dict(zip(names, grads[:len(names)])), step0 + i)
        if scda:
            with torch.no_grad():
                for (k, p), g in zip(Dw.items(), grads[len(names):]):
                    trace = g + cfg.train.momentum * d_mom[k]
                    d_mom[k].copy_(trace)
                    p.add_(trace * -cfg.adapt.d_lr)
                    taken["D." + k] = g
        if i == 0 and momentum is None:
            mom = dict(sgd.momentum)
            if scda:
                mom.update({"D." + k: v for k, v in d_mom.items()})
            out["first_grad"] = first_gradient(mom, sgd.bias)
        if i == steps - 1:
            out["last_grad"] = {n: t.detach() for n, t in taken.items()}
        del fwd, grads, taken
    out["params"] = {n: P[n].detach() for n in names}
    out["momentum"] = dict(sgd.momentum)
    if scda:
        out["params"].update({"D." + k: v.detach() for k, v in Dw.items()})
        out["d_momentum"] = d_mom
    return out

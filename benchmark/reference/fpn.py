"""Plain f32 reference of ResNet-FPN Faster R-CNN (Lin et al., CVPR 2017,
arXiv:1612.03144), as Detectron's ``e2e_faster_rcnn_R-101-FPN_1x.yaml``
trains it: the reference of the configurations whose file names
``"reference": "fpn"`` (backbone ``resnet50_fpn``, ``resnet101_fpn`` or
``resnet152_fpn``).  It imports nothing of the program or of JAX.

The network, over the flat dict of weights the harness makes:

* trunk: conv1 .. layer4 (``RCNN_base.0`` .. ``.7``), every bottleneck one
  by one with its frozen batch norms unfolded; C2 .. C5 are layer1 ..
  layer4's maps;
* pyramid (``RCNN_fpn``): a 1x1 lateral conv with bias to 256 channels on
  each of C2 .. C5 (``inner_blocks.0`` .. ``.3``), the top-down path
  (nearest 2x upsampling of the coarser sum, added to the lateral), a
  3x3 conv with bias on each sum (``layer_blocks.0`` .. ``.3``) giving
  P2 .. P5, and P6 as P5 at every second row and column;
* RPN: one head (``RCNN_rpn``: a 3x3 conv and ReLU, 1x1 convs to two
  logits and four deltas an anchor) on each of P2 .. P6; 3 anchors a
  location, of base size and stride 2**level, so sizes 32 .. 512;
* proposals: the shared proposal layer (``detect.propose``) on each level
  at the step's counts, then the top ``post_nms_top_n`` of all levels by
  score, per image (invalid slots last; ties to the lower level, then the
  lower slot);
* RoI-Align (7x7, sampling ratio 2) of each roi from level
  clamp(floor(4 + log2(sqrt(area) / 224 + 1e-6)), 2, 5), the area with
  the +1 widths, in f32; each level pools only its own rois;
* head: fc6 (256 x 7 x 7 -> 1024) and fc7 (1024 -> 1024) with ReLUs
  (``RCNN_top.fc6``, ``.fc7``) over the pooled rois flattened (C, P, P),
  then the class scores and the class-specific box deltas.

Training: the RPN's targets over every level's anchors together (256 an
image, half foreground at most, anchors wholly inside the image), 512
rois an image at a quarter foreground, the losses and the optimizer of
``steps.py`` (``Sgd``: clip, decay, doubled biases, momentum).

Departures from Detectron, each the program's too:

* the RPN scores each anchor with two logits under a softmax (the proposal
  layer's and the losses' form) in place of one logit under a sigmoid;
* the collect keeps the top ``post_nms_top_n`` per image, as Detectron2
  and torchvision do, in place of per batch;
* the global-norm clip at 10 (Detectron clips nothing) and no warm-up;
* bf16 compute in the program (this reference is f32), f32 parameters
  and momentum;
* the canvas: Cityscapes' full 1024x2048 frame (scale 1024, max size
  2048) in place of COCO's 800x1333, and 9 classes.

``proposals=`` (a sequence of one ``detect.Proposals`` a level, in level
order) hands a step or a forward the program's per-level proposals in
place of its own, as ``steps.py``'s entries take one; the collect is
then this module's own.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import detect as D
from benchmark.reference import nets as N
from benchmark.reference.precision import Precision
from benchmark.reference.steps import (  # noqa: F401  (the interface)
    Sgd, doubled_biases, first_gradient, step_gens, trainable_names,
)

RPN_LEVELS = (2, 3, 4, 5, 6)
ROI_LEVELS = (2, 3, 4, 5)


def depth_of(mc) -> int:
    name = mc.backbone
    if not (name.startswith("resnet") and name.endswith("_fpn")):
        raise ValueError(f"the fpn reference runs resnet<depth>_fpn, not {name!r}")
    return int(name[len("resnet"):-len("_fpn")])


def _rand(gen: torch.Generator, shape, device):
    return torch.rand(tuple(shape), generator=gen, device=gen.device).to(device)


# ---- the network -----------------------------------------------------------

def trunk(P, x, depth: int, prec: Precision) -> List[torch.Tensor]:
    """(B, 3, H, W) -> C2 .. C5, NCHW."""
    x = N.conv(prec, x, P["RCNN_base.0.weight"], stride=2, padding=3)
    x = F.max_pool2d(F.relu(N.frozen_bn(P, "RCNN_base.1", x)), 3, 2, padding=1)
    out = []
    for mod, n, stride in zip((4, 5, 6, 7), N.RESNET_DEPTHS[depth], (1, 2, 2, 2)):
        for b in range(n):
            x = N.bottleneck(P, f"RCNN_base.{mod}.{b}", x,
                             stride if b == 0 else 1, b == 0, prec)
        out.append(x)
    return out


def pyramid(P, cs: Sequence[torch.Tensor], prec: Precision) -> List[torch.Tensor]:
    """C2 .. C5 (NCHW) -> P2 .. P6, NHWC."""
    def conv(kind, i, x, **kw):
        pre = f"RCNN_fpn.{kind}.{i}"
        return N.conv(prec, x, P[pre + ".weight"], P[pre + ".bias"], **kw)

    inner = conv("inner_blocks", 3, cs[3])
    outs = [conv("layer_blocks", 3, inner, padding=1)]
    for i in (2, 1, 0):
        lateral = conv("inner_blocks", i, cs[i])
        b, c, h, w = inner.shape
        up = inner[:, :, :, None, :, None].expand(b, c, h, 2, w, 2)
        up = up.reshape(b, c, 2 * h, 2 * w)[:, :, :lateral.shape[2], :lateral.shape[3]]
        inner = lateral + up
        outs.insert(0, conv("layer_blocks", i, inner, padding=1))
    outs.append(outs[-1][:, :, ::2, ::2])
    return [o.permute(0, 2, 3, 1) for o in outs]


def features(P, image_nhwc, mc, prec: Precision) -> List[torch.Tensor]:
    x = image_nhwc.permute(0, 3, 1, 2).float().contiguous()
    return pyramid(P, trunk(P, x, depth_of(mc), prec), prec)


def level_anchors(cfg, level: int, feat_hw, device) -> torch.Tensor:
    """All (h * w * A, 4) anchors of a level, cell-major."""
    stride = 2 ** level
    base = D.base_anchors(stride, cfg.anchors.ratios, cfg.anchors.scales)
    sx, sy = np.meshgrid(np.arange(feat_hw[1], dtype=np.float32) * stride,
                         np.arange(feat_hw[0], dtype=np.float32) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    out = (base[None] + shifts[:, None]).reshape(-1, 4).astype(np.float32)
    return torch.from_numpy(out).to(device)


class Rpn(NamedTuple):
    outs: list           # (cls (B, h, w, A, 2), deltas (B, h, w, A, 4)) a level
    anchors: list        # (h * w * A, 4) a level


def rpn(P, pyr, cfg, prec: Precision) -> Rpn:
    a = len(cfg.anchors.scales) * len(cfg.anchors.ratios)
    outs = [N.rpn_out(P, f, prec, a) for f in pyr]
    anchors = [level_anchors(cfg, k, tuple(f.shape[1:3]), f.device)
               for k, f in zip(RPN_LEVELS, pyr)]
    return Rpn(outs, anchors)


def collect(level_props: Sequence[D.Proposals], top_n: int) -> D.Proposals:
    """The top ``top_n`` of every level's proposals by score, per image."""
    valid = torch.cat([p.valid for p in level_props], dim=1)
    scores = torch.cat([p.scores.float() for p in level_props], dim=1)
    boxes = torch.cat([p.boxes.float() for p in level_props], dim=1)
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -1.0)),
                       dim=-1, descending=True, stable=True).indices
    order = order[:, :min(top_n, order.shape[1])]
    v = torch.gather(valid, 1, order)
    s = torch.where(v, torch.gather(scores, 1, order), torch.zeros((), device=v.device))
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return D.Proposals(torch.where(v[..., None], b, torch.zeros((), device=v.device)),
                       s, v)


def proposals_of(r: Rpn, im_info, pc, given=None):
    """(each level's proposals, theirs collected, the proposal calls)."""
    if isinstance(given, D.Proposals):
        raise TypeError("the fpn reference takes one Proposals a level")
    per_level = list(given) if given is not None else [
        D.propose(c.detach(), d.detach(), an, im_info, pc)
        for (c, d), an in zip(r.outs, r.anchors)]
    calls = [((c.detach(), d.detach(), an, im_info, pc), p)
             for (c, d), an, p in zip(r.outs, r.anchors, per_level)]
    return per_level, collect(per_level, pc.post_nms_top_n), calls


def roi_levels(rois) -> torch.Tensor:
    w = torch.clamp(rois[..., 2] - rois[..., 0] + D.PLUS_ONE, min=0.0)
    h = torch.clamp(rois[..., 3] - rois[..., 1] + D.PLUS_ONE, min=0.0)
    lvl = torch.floor(4.0 + torch.log2(torch.sqrt(w * h) / 224.0 + 1e-6))
    return torch.clamp(lvl, ROI_LEVELS[0], ROI_LEVELS[-1]).long()


def pool(pyr, rois, mc) -> torch.Tensor:
    """Grouped rois (B, R, 4), each pooled from its own level only:
    flat (B * R, P, P, C)."""
    b, r = rois.shape[:2]
    lvl = roi_levels(rois.detach().float())
    parts, where = [], []
    for i in range(b):
        for feat, k in zip(pyr, ROI_LEVELS):
            sel = torch.nonzero(lvl[i] == k)[:, 0]
            if sel.numel() == 0:
                continue
            parts.append(N.roi_align(feat[i:i + 1], rois[i:i + 1, sel],
                                     output_size=mc.pooling_size,
                                     spatial_scale=1.0 / 2 ** k,
                                     sampling_ratio=mc.sampling_ratio)[0])
            where.append(i * r + sel)
    return torch.cat(parts)[torch.argsort(torch.cat(where))]


def head(P, pooled_nhwc, prec: Precision):
    """Pooled (R, P, P, C) -> (cls logits (R, classes), deltas)."""
    x = pooled_nhwc.permute(0, 3, 1, 2).reshape(pooled_nhwc.shape[0], -1)
    for fc in ("fc6", "fc7"):
        x = F.relu(N.linear(prec, x, P[f"RCNN_top.{fc}.weight"],
                            P[f"RCNN_top.{fc}.bias"]))
    return (N.linear(prec, x, P["RCNN_cls_score.weight"], P["RCNN_cls_score.bias"]),
            N.linear(prec, x, P["RCNN_bbox_pred.weight"], P["RCNN_bbox_pred.bias"]))


# ---- serving ---------------------------------------------------------------

@torch.no_grad()
def serve(P, image, im_info, cfg, prec: Precision, proposals=None) -> dict:
    """One served batch: each level's RPN outputs and proposal call, the
    collected proposals, every (proposal, class) probability and box, and
    the detections."""
    pyr = features(P, image, cfg.model, prec)
    _, props, calls = proposals_of(rpn(P, pyr, cfg, prec), im_info,
                                   cfg.test.proposal, proposals)
    cls, bbox = head(P, pool(pyr[:4], props.boxes, cfg.model), prec)
    probs, boxes = D.class_boxes(props, cls, bbox, im_info, cfg)
    return {"calls": calls, "props": props, "head": (cls, bbox),
            "probs": probs, "boxes": boxes,
            "dets": D.postprocess(props, probs, boxes, im_info, cfg)}


# ---- training --------------------------------------------------------------

class Forward(NamedTuple):
    loss: torch.Tensor
    metrics: dict
    props: D.Proposals
    propose_calls: list


def train_forward(P, batch, cfg, prec: Precision, gens,
                  proposals: Optional[Sequence[D.Proposals]] = None) -> Forward:
    image, im_info, gt, num = batch
    mc = cfg.model
    pyr = features(P, image, mc, prec)
    r = rpn(P, pyr, cfg, prec)
    _, props, calls = proposals_of(r, im_info, cfg.train.proposal, proposals)
    b = gt.shape[0]
    cls_all = torch.cat([c.reshape(b, -1, 2) for c, _ in r.outs], dim=1)
    bbox_all = torch.cat([d.reshape(b, -1, 4) for _, d in r.outs], dim=1)
    anchors = torch.cat(r.anchors)
    labels, targets, in_w, out_w = D.anchor_targets(
        anchors, gt, num, im_info, cfg.train.rpn_target,
        _rand(gens.anchor, (b, 2, anchors.shape[0]), gt.device))
    rpn_cls_l, rpn_box_l = D.rpn_losses(cls_all, bbox_all, labels, targets,
                                        in_w, out_w)
    n = props.boxes.shape[1] + gt.shape[1]
    samples = D.proposal_targets(props.boxes, props.valid, gt, num,
                                 cfg.train.roi_target,
                                 _rand(gens.roi, (b, 2, n), gt.device))
    cls, deltas = head(P, pool(pyr[:4], samples.rois, mc), prec)
    rcnn_cls_l, rcnn_box_l = D.rcnn_losses(cls, deltas, samples, mc.num_classes,
                                           mc.class_agnostic)
    total = rpn_cls_l + rpn_box_l + rcnn_cls_l + rcnn_box_l
    metrics = {"loss": total, "rpn_cls": rpn_cls_l, "rpn_box": rpn_box_l,
               "rcnn_cls": rcnn_cls_l, "rcnn_box": rcnn_box_l}
    return Forward(total, metrics, props, calls)


def train_steps(P0, D0, batches, cfg, prec: Precision, seed: int, steps: int,
                proposals=None, step0: int = 0, momentum=None,
                d_momentum=None) -> dict:
    """``steps.py``'s ``train_steps`` for the source-only step (``D0`` and
    ``d_momentum`` must be None); ``proposals`` holds one sequence of
    per-level proposals a step."""
    if D0 is not None or d_momentum is not None:
        raise ValueError("the fpn reference has no SCDA step")
    dev = batches[0][0][0].device
    P = {k: v.detach().clone().float() for k, v in P0.items()}
    names = trainable_names(P, cfg.model)
    for n in names:
        P[n].requires_grad_(True)
    sgd = Sgd(P, names, cfg.train, momentum)
    out = {"metrics": [], "calls": []}
    for i in range(steps):
        gens = step_gens(seed, step0 + i, dev, False)
        fwd = train_forward(P, batches[i][0], cfg, prec, gens,
                            None if proposals is None else proposals[i])
        grads = torch.autograd.grad(fwd.loss, [P[n] for n in names],
                                    materialize_grads=True)
        out["metrics"].append({k: float(v.detach()) for k, v in fwd.metrics.items()})
        out["calls"].append(fwd.propose_calls)
        taken = sgd.step(P, dict(zip(names, grads)), step0 + i)
        if i == 0 and momentum is None:
            out["first_grad"] = first_gradient(dict(sgd.momentum), sgd.bias)
        if i == steps - 1:
            out["last_grad"] = {n: t.detach() for n, t in taken.items()}
        del fwd, grads, taken
    out["params"] = {n: P[n].detach() for n in names}
    out["momentum"] = dict(sgd.momentum)
    return out

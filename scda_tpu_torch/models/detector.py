"""Detection pipeline (port of ``scda_tpu/models/detector.py``): the
training forward with its four losses, and inference with its
postprocess, plus ``make_anchors`` and the multiscale pooling dispatch
``_pool_ms``.  An FPN model (:mod:`scda_tpu_torch.models.fpn`) takes the
same entries: its RPN runs on every pyramid level, each level's
proposals are one call of this module's ``propose`` (so that a caller
who wraps the name sees every call, in level order), and the collect
keeps the best of them.

Every size is fixed by the config and invalid slots are masked, as in
the JAX package, so the whole forward stays on the device with no host
synchronisation.  Under data parallelism (``world``, see
:mod:`scda_tpu_torch.parallel.mesh`) each loss divides this rank's
numerator by the global batch's denominator, so the ranks' losses sum to
the loss of the global batch.  The JAX losses pick labels with one-hot contractions,
an XLA lowering choice; here they are gathers, which give the same
values and gradients.
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from scda_tpu_torch.config import Config, ProposalConfig
from scda_tpu_torch.core import boxes as box_ops
from scda_tpu_torch.models import fpn
from scda_tpu_torch.models.faster_rcnn import (
    FasterRCNN, pool_rois, pool_rois_multiscale,
)
from scda_tpu_torch.models.rpn import Proposals, propose
from scda_tpu_torch.models.targets import (
    AnchorTargets, RoiSamples, anchor_targets, proposal_targets,
)
from scda_tpu_torch.ops.nms import batched_nms
from scda_tpu_torch.utils.profile import span

# The ``req`` id of the ``scda.serve`` spans: this process's served batches.
_requests = itertools.count()


def _pool_ms(model: FasterRCNN, feat_fine: torch.Tensor,
             feat: torch.Tensor, rois: torch.Tensor, mc) -> torch.Tensor:
    """Multiscale pooling: with ``ms_proj_after_pool`` the lateral
    projection follows pooling (a step with parameters, so the model's);
    otherwise ``feat_fine`` arrives projected."""
    if mc.ms_proj_after_pool:
        return model.pool_multiscale(feat_fine, feat, rois)
    return pool_rois_multiscale(feat_fine, feat, rois, mc)


def make_anchors(cfg: Config, feat_hw: Tuple[int, int],
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """All (h*w*A, 4) anchors of a feature map, built in numpy."""
    base = box_ops.generate_base_anchors(
        cfg.anchors.base_size, cfg.anchors.ratios, cfg.anchors.scales)
    anchors = box_ops.shift_anchors(base, feat_hw[0], feat_hw[1],
                                    cfg.model.feat_stride)
    return torch.from_numpy(anchors).to(device)


def global_sum(t: torch.Tensor, world) -> torch.Tensor:
    """``t`` summed over the data-parallel ranks (detached), or ``t``
    itself without a ``world``."""
    return t if world is None else world.sum(t)


def world_size(world) -> int:
    return 1 if world is None else world.size


def _fpn_pyramid(model: FasterRCNN, image: torch.Tensor):
    """An FPN model's P2 .. P6 (NHWC) of an image batch (B, H, W, 3)."""
    with span("backbone"):
        trunk = model.RCNN_base.levels(image.permute(0, 3, 1, 2))
    with span("fpn"):
        return model.RCNN_fpn(trunk)


def _fpn_rpn(model: FasterRCNN, pyramid, im_info: torch.Tensor, cfg: Config,
             pc: ProposalConfig):
    """The shared RPN head on P2 .. P6, one ``propose`` call a level (at
    ``pc``'s counts), then the collect of ``pc.post_nms_top_n`` an image:
    (each level's (logits, deltas, anchors), the collected proposals)."""
    outs = []
    with span("rpn"):
        for level, feat in zip(fpn.RPN_LEVELS, pyramid):
            with span("rpn.level", level=level):
                cls, bbox = model.rpn_out(feat)
                outs.append((cls, bbox, fpn.level_anchors(
                    cfg, level, (feat.shape[1], feat.shape[2]), feat.device)))
    level_props = [propose(cls, bbox, anchors, im_info, pc)
                   for cls, bbox, anchors in outs]
    with span("propose"), span("propose.collect"):
        props = fpn.collect(level_props, pc.post_nms_top_n)
    return outs, props


class _Proposed(NamedTuple):
    """What both entries take from the backbone and the RPN."""

    maps: tuple                 # what :func:`_pool` reads
    feat: torch.Tensor          # TrainForward.base_feat (an FPN's P2)
    rpn_cls: torch.Tensor       # the RPN's logits over every anchor
    rpn_bbox: torch.Tensor      # and its deltas
    anchors: torch.Tensor       # (A, 4), every level laid end to end
    props: Proposals


def _proposed(model: FasterRCNN, image: torch.Tensor, im_info: torch.Tensor,
              cfg: Config, pc: ProposalConfig) -> _Proposed:
    """Backbone, RPN and proposals at ``pc``'s counts.  An FPN model runs
    the RPN on every level and collects (:func:`_fpn_rpn`); the targets
    and losses see its levels' anchors laid end to end."""
    mc = cfg.model
    if fpn.fpn_depth(mc.backbone) is not None:
        pyramid = _fpn_pyramid(model, image)
        outs, props = _fpn_rpn(model, pyramid, im_info, cfg, pc)
        b = image.shape[0]
        return _Proposed(
            tuple(pyramid), pyramid[0],
            torch.cat([c.reshape(b, -1, 2) for c, _, _ in outs], 1),
            torch.cat([d.reshape(b, -1, 4) for _, d, _ in outs], 1),
            torch.cat([a for _, _, a in outs]), props)
    with span("backbone"):
        if mc.multiscale_roi:
            feat_fine, feat = model.features_pyramid(image)
        else:
            feat_fine, feat = None, model.features(image)
    with span("rpn"):
        rpn_cls, rpn_bbox = model.rpn_out(feat)
        anchors = make_anchors(cfg, (feat.shape[1], feat.shape[2]),
                               feat.device)
    props = propose(rpn_cls, rpn_bbox, anchors, im_info, pc)
    return _Proposed((feat_fine, feat), feat, rpn_cls, rpn_bbox, anchors,
                     props)


def _pool(model: FasterRCNN, maps: tuple, rois: torch.Tensor,
          mc) -> torch.Tensor:
    """RoI pooling from :func:`_proposed`'s ``maps``: an FPN's levels,
    both multiscale levels, or the one stride-16 map."""
    if fpn.fpn_depth(mc.backbone) is not None:
        return fpn.pool_levels(maps, rois, mc)
    feat_fine, feat = maps
    if mc.multiscale_roi:
        return _pool_ms(model, feat_fine, feat, rois, mc)
    return pool_rois(feat, rois, None, mc)


class StepGenerators(NamedTuple):
    """The train step's randomness, split three ways as JAX splits its
    key: anchor sampling, roi sampling, dropout."""

    anchor: torch.Generator
    roi: torch.Generator
    dropout: torch.Generator


class TrainForward(NamedTuple):
    loss: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    proposals: Proposals
    base_feat: torch.Tensor


def _rpn_losses(cls_logits: torch.Tensor, bbox_pred: torch.Tensor,
                tgts: AnchorTargets, world=None):
    """RPN losses: cross-entropy over the sampled anchors, smooth-L1
    (sigma 3) with the targets' outside weights, over the batch."""
    b = cls_logits.shape[0]
    logp = torch.log_softmax(cls_logits.reshape(b, -1, 2), dim=-1)
    labels = tgts.labels
    picked = torch.gather(logp, 2, torch.clamp(labels, min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    cls_loss = -torch.sum(picked * mask) / torch.clamp(
        global_sum(torch.sum(mask), world), min=1.0)
    box_loss = box_ops.smooth_l1_loss(
        bbox_pred.reshape(b, -1, 4), tgts.bbox_targets, tgts.bbox_inside_w,
        tgts.bbox_outside_w, sigma=3.0) / (b * world_size(world))
    return cls_loss, box_loss


def _rcnn_losses(cls_logits: torch.Tensor, bbox_deltas: torch.Tensor,
                 samples: RoiSamples, num_classes: int,
                 class_agnostic: bool, world=None):
    """RoI head losses: cross-entropy over every sampled roi, smooth-L1
    (sigma 1) on the gt class's deltas, mean over rois."""
    bs, s = samples.labels.shape
    n_rois = bs * s * world_size(world)
    logp = torch.log_softmax(cls_logits.reshape(bs, s, -1), dim=-1)
    labels = samples.labels[..., None]
    cls_loss = -torch.sum(torch.gather(logp, 2, labels)[..., 0]) / n_rois
    if class_agnostic:
        deltas = bbox_deltas.reshape(bs, s, 4)
    else:
        deltas = bbox_deltas.reshape(bs, s, num_classes, 4)
        deltas = torch.gather(deltas, 2, labels[..., None].expand(
            bs, s, 1, 4))[:, :, 0]
    outside_w = (samples.bbox_inside_w > 0).float()
    box_loss = box_ops.smooth_l1_loss(
        deltas, samples.bbox_targets, samples.bbox_inside_w, outside_w,
        sigma=1.0) / n_rois
    return cls_loss, box_loss


def forward_train(
    model: FasterRCNN,
    image: torch.Tensor,      # (B, H, W, 3)
    im_info: torch.Tensor,    # (B, 3)
    gt_boxes: torch.Tensor,   # (B, G, 5)
    num_boxes: torch.Tensor,  # (B,)
    cfg: Config,
    rngs: StepGenerators,
    *,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    world=None,
) -> TrainForward:
    """The supervised training forward: backbone, RPN and its targets,
    proposals (``cfg.train.proposal``, no gradient), roi sampling,
    pooling (both pyramid levels with ``multiscale_roi``), the head with
    dropout, and the four losses.  ``draws`` may hold the ``"anchor"``
    and ``"roi"`` uniforms of the target functions (tests inject JAX's).
    With a ``world`` the losses take the global batch's denominators and
    ``rngs`` are expected to be this rank's row shards."""
    mc = cfg.model
    draws = draws or {}
    p = _proposed(model, image, im_info, cfg, cfg.train.proposal)
    rpn_cls, rpn_bbox, anchors, props = (p.rpn_cls, p.rpn_bbox, p.anchors,
                                         p.props)

    with span("targets"), span("targets.anchor"):
        a_tgts = anchor_targets(anchors, gt_boxes, num_boxes, im_info,
                                cfg.train.rpn_target, rngs.anchor,
                                draws=draws.get("anchor"))
    with span("head"):
        rpn_cls_loss, rpn_box_loss = _rpn_losses(rpn_cls, rpn_bbox, a_tgts,
                                                 world)

    with span("targets"), span("targets.roi"):
        samples = proposal_targets(props.boxes, props.valid, gt_boxes,
                                   num_boxes, cfg.train.roi_target, rngs.roi,
                                   draws=draws.get("roi"))
    bs, s = samples.labels.shape
    with span("roi"):
        pooled = _pool(model, p.maps, samples.rois, mc)
    with span("head"):
        cls_logits, bbox_deltas = model.roi_head(pooled, train=True,
                                                 generator=rngs.dropout)
        rcnn_cls_loss, rcnn_box_loss = _rcnn_losses(
            cls_logits, bbox_deltas, samples, mc.num_classes,
            mc.class_agnostic, world)

        total = rpn_cls_loss + rpn_box_loss + rcnn_cls_loss + rcnn_box_loss
    fg_cnt = samples.fg_mask.sum()
    metrics = {
        "loss": total, "rpn_cls": rpn_cls_loss, "rpn_box": rpn_box_loss,
        "rcnn_cls": rcnn_cls_loss, "rcnn_box": rcnn_box_loss,
        "fg_cnt": fg_cnt, "bg_cnt": bs * s - fg_cnt,
    }
    return TrainForward(total, metrics, props, p.feat)


class Detections(NamedTuple):
    """Fixed-size per-image detections (class ids are 1-based fg ids)."""

    boxes: torch.Tensor    # (B, D, 4) in original image coords
    scores: torch.Tensor   # (B, D)
    classes: torch.Tensor  # (B, D) int64
    valid: torch.Tensor    # (B, D) bool


def postprocess(props: Proposals, cls_logits: torch.Tensor,
                bbox_deltas: torch.Tensor, im_info: torch.Tensor,
                cfg: Config) -> Detections:
    """Head outputs -> detections: per-class decode, score threshold,
    per-class NMS (``test.nms_thresh``), then the global top
    ``max_per_image`` across classes, unscaled to original image coords."""
    with span("postprocess"):
        mc, tc = cfg.model, cfg.test
        b, n, _ = props.boxes.shape
        num_classes = mc.num_classes
        probs = torch.softmax(cls_logits.reshape(b, n, num_classes), dim=-1)

        if tc.bbox_reg:
            if mc.class_agnostic:
                deltas = bbox_deltas.reshape(b, n, 1, 4).expand(
                    b, n, num_classes, 4)
            else:
                deltas = bbox_deltas.reshape(b, n, num_classes, 4)
            stds = torch.tensor(cfg.train.roi_target.bbox_normalize_stds,
                                dtype=torch.float32, device=deltas.device)
            means = torch.tensor(cfg.train.roi_target.bbox_normalize_means,
                                 dtype=torch.float32, device=deltas.device)
            deltas = deltas * stds + means
            boxes = box_ops.bbox_transform_inv(props.boxes[:, :, None, :],
                                               deltas)
            boxes = box_ops.clip_boxes(boxes, im_info[:, 0, None, None],
                                       im_info[:, 1, None, None])
        else:
            boxes = props.boxes[:, :, None, :].expand(b, n, num_classes, 4)

        # Per-class NMS over the foreground classes as one (B*C) batch.
        fg = num_classes - 1
        d_cls = tc.max_dets_per_class
        cls_boxes = boxes[:, :, 1:, :].permute(0, 2, 1, 3).reshape(
            b * fg, n, 4)
        cls_scores = probs[:, :, 1:].permute(0, 2, 1).reshape(b * fg, n)
        cand_valid = (props.valid[:, None, :].expand(b, fg, n)
                      .reshape(b * fg, n) & (cls_scores > tc.score_thresh))
        res = batched_nms(cls_boxes, cls_scores, iou_threshold=tc.nms_thresh,
                          max_output=d_cls, valid=cand_valid)
        kept_boxes = torch.gather(cls_boxes, 1,
                                  res.indices[..., None].expand(-1, -1, 4))
        kept_scores = torch.gather(cls_scores, 1, res.indices)
        kept_scores = torch.where(res.valid, kept_scores,
                                  torch.full_like(kept_scores, -1.0))

        # Global cap across classes; the stable sort breaks ties toward the
        # lower index, as lax.top_k does.
        d = fg * d_cls
        flat_boxes = kept_boxes.reshape(b, d, 4)
        flat_scores = kept_scores.reshape(b, d)
        flat_classes = torch.arange(1, num_classes, device=flat_scores.device)
        flat_classes = flat_classes.repeat_interleave(d_cls).expand(b, d)
        k = min(tc.max_per_image, d)
        top_scores, top_idx = torch.sort(flat_scores, dim=-1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        db = torch.gather(flat_boxes, 1, top_idx[..., None].expand(b, k, 4))
        dc = torch.gather(flat_classes, 1, top_idx)
        db = db / im_info[:, 2][:, None, None]
        return Detections(boxes=db, scores=top_scores, classes=dc,
                          valid=top_scores > 0)


@torch.no_grad()
def forward_inference(model: FasterRCNN, image: torch.Tensor,
                      im_info: torch.Tensor, cfg: Config) -> Detections:
    """Test-time forward + postprocess.

    image (B, H, W, 3) float NHWC canvas and im_info (B, 3), on the
    model's device.  Proposals (``cfg.test.proposal``) -> RoI-Align (on
    both pyramid levels with ``model.multiscale_roi``) -> head ->
    :func:`postprocess`.
    """
    mc = cfg.model
    with span("serve", req=next(_requests)):
        p = _proposed(model, image, im_info, cfg, cfg.test.proposal)
        with span("roi"):
            pooled = _pool(model, p.maps, p.props.boxes, mc)
        with span("head"):
            cls_logits, bbox_deltas = model.roi_head(pooled, train=False)
        return postprocess(p.props, cls_logits, bbox_deltas, im_info, cfg)

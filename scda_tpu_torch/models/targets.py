"""Training targets: anchor targets for the RPN and sampled rois for the
RoI head (port of ``scda_tpu/models/targets.py``).

Shapes are fixed by the config and invalid entries masked, as in the
JAX package, so nothing here synchronises with the host.  The
reference's random subset sampling (``torch.randperm`` on dynamic index
lists) is masked random ranking: one uniform per candidate, candidates
of a class ranked by it, ranks below the quota kept.

Randomness: every function takes an explicit ``torch.Generator``, and
draws ``(B, 2, n)`` uniforms from it on the generator's device (one row
for foregrounds, one for backgrounds, per image).  ``draws=`` hands in
those uniforms instead, so a test can give the port the values JAX drew:
the two packages' random streams differ.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scda_tpu_torch.config import ROITargetConfig, RPNTargetConfig
from scda_tpu_torch.core import boxes as box_ops
from scda_tpu_torch.core.draws import Source, uniform


def uniforms(generator: Source, shape, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) drawn on the generator's device, moved to
    ``device`` (``generator`` may be one rank's :class:`RowShard`)."""
    return uniform(generator, shape).to(device)


def _masked_rank(u: torch.Tensor, mask: torch.Tensor):
    """Random rank among masked elements, along the last axis.

    ``u`` uniforms and ``mask`` of one shape.  Returns (rank, order):
    ``rank < count`` exactly where ``mask``, a uniformly random
    permutation of the masked elements; ``order`` lists the masked
    indices first, in rank order (for gathers with replacement).  The
    stable sort breaks ties by index, as ``jnp.argsort`` does.
    """
    score = torch.where(mask, u, torch.full_like(u, 2.0))
    order = torch.argsort(score, dim=-1, stable=True)
    n = mask.shape[-1]
    rank = torch.empty_like(order)
    rank.scatter_(-1, order,
                  torch.arange(n, device=mask.device).expand_as(order))
    return rank, order


class AnchorTargets(NamedTuple):
    labels: torch.Tensor          # (B, K) int64 in {-1, 0, 1}
    bbox_targets: torch.Tensor    # (B, K, 4)
    bbox_inside_w: torch.Tensor   # (B, K, 4)
    bbox_outside_w: torch.Tensor  # (B, K, 4)


@torch.no_grad()
def anchor_targets(
    anchors: torch.Tensor,     # (K, 4)
    gt_boxes: torch.Tensor,    # (B, G, 5)
    num_boxes: torch.Tensor,   # (B,)
    im_info: torch.Tensor,     # (B, 3)
    cfg: RPNTargetConfig,
    generator: torch.Generator,
    *,
    draws: torch.Tensor | None = None,   # (B, 2, K) uniforms
) -> AnchorTargets:
    """Label anchors for RPN training.

    Anchors fully inside the image's valid extent take part; positives
    are the best anchor(s) of each gt (ties included) and anchors with
    IoU >= ``positive_overlap``; negatives have IoU < ``negative_overlap``.
    Positives are subsampled to ``batch_size * fg_fraction``, negatives
    fill the rest of ``batch_size``, everything else is ignored (-1).
    """
    b, g = gt_boxes.shape[:2]
    k = anchors.shape[0]
    dev = gt_boxes.device
    if draws is None:
        draws = uniforms(generator, (b, 2, k), dev)
    gt_valid = torch.arange(g, device=dev)[None] < num_boxes[:, None]

    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] < im_info[:, 1:2])
              & (anchors[None, :, 3] < im_info[:, 0:1]))           # (B, K)
    overlaps = box_ops.bbox_overlaps_batch(anchors.expand(b, k, 4),
                                           gt_boxes[..., :4])        # (B, K, G)
    overlaps = torch.where(gt_valid[:, None, :], overlaps,
                           torch.full_like(overlaps, -1.0))
    max_overlap = overlaps.max(dim=2).values
    argmax_gt = torch.argmax(overlaps, dim=2)
    gt_max = torch.where(inside[:, :, None], overlaps,
                         torch.full_like(overlaps, -2.0)).max(dim=1).values
    is_best_for_gt = torch.any(
        (overlaps >= gt_max[:, None, :] - 1e-5) & gt_valid[:, None, :]
        & (gt_max[:, None, :] > 0), dim=2)

    labels = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    neg = max_overlap < cfg.negative_overlap
    pos = is_best_for_gt | (max_overlap >= cfg.positive_overlap)
    order = ((neg, 0), (pos, 1))
    for mask, value in (order[::-1] if cfg.clobber_positives else order):
        labels = torch.where(inside & mask, value, labels)

    num_fg_quota = int(cfg.fg_fraction * cfg.batch_size)
    fg_mask = labels == 1
    fg_rank, _ = _masked_rank(draws[:, 0], fg_mask)
    labels = torch.where(fg_mask & (fg_rank >= num_fg_quota), -1, labels)
    num_fg = (labels == 1).sum(dim=1)
    num_bg_quota = cfg.batch_size - num_fg
    bg_mask = labels == 0
    bg_rank, _ = _masked_rank(draws[:, 1], bg_mask)
    labels = torch.where(bg_mask & (bg_rank >= num_bg_quota[:, None]), -1,
                         labels)

    matched_gt = torch.gather(gt_boxes[..., :4], 1,
                              argmax_gt[..., None].expand(b, k, 4))
    targets = box_ops.bbox_transform(anchors[None], matched_gt)

    ones = torch.ones((1, 1, 4), dtype=torch.float32, device=dev)
    inside_w = (labels == 1).float()[..., None] * ones
    # Tensor numerators: ``scalar / tensor`` is a reciprocal and a
    # multiply in PyTorch, an ulp away from JAX's division.
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.positive_weight < 0:
        num_examples = torch.clamp((labels >= 0).float().sum(dim=1), min=1.0)
        pos_w = neg_w = (zero + 1.0) / num_examples
    else:
        pw = cfg.positive_weight
        pos_w = (zero + pw) / torch.clamp((labels == 1).float().sum(dim=1),
                                          min=1.0)
        neg_w = (zero + (1.0 - pw)) / torch.clamp(
            (labels == 0).float().sum(dim=1), min=1.0)
    outside_w = (torch.where(labels == 1, pos_w[:, None], zero)
                 + torch.where(labels == 0, neg_w[:, None], zero))[..., None] * ones
    return AnchorTargets(labels, targets, inside_w, outside_w)


class RoiSamples(NamedTuple):
    rois: torch.Tensor           # (B, S, 4)
    labels: torch.Tensor         # (B, S) int64, 0 = background
    bbox_targets: torch.Tensor   # (B, S, 4) normalised encodings
    bbox_inside_w: torch.Tensor  # (B, S, 4)
    fg_mask: torch.Tensor        # (B, S) bool


@torch.no_grad()
def proposal_targets(
    proposals: torch.Tensor,    # (B, N, 4)
    prop_valid: torch.Tensor,   # (B, N) bool
    gt_boxes: torch.Tensor,     # (B, G, 5)
    num_boxes: torch.Tensor,    # (B,)
    cfg: ROITargetConfig,
    generator: torch.Generator,
    *,
    draws: torch.Tensor | None = None,   # (B, 2, N + G) uniforms
) -> RoiSamples:
    """Sample ``cfg.batch_size`` rois per image for the RoI head.

    The gt boxes join the candidates (as the reference appends them); a
    quota of foregrounds (IoU >= ``fg_thresh``) is drawn, backgrounds
    (IoU in [``bg_thresh_lo``, ``bg_thresh_hi``)) fill the rest, both with
    replacement when they run short.
    """
    b, n, _ = proposals.shape
    g = gt_boxes.shape[1]
    s = cfg.batch_size
    dev = proposals.device
    fg_quota = int(round(cfg.fg_fraction * s))
    if draws is None:
        draws = uniforms(generator, (b, 2, n + g), dev)
    means = torch.tensor(cfg.bbox_normalize_means, dtype=torch.float32,
                         device=dev)
    stds = torch.tensor(cfg.bbox_normalize_stds, dtype=torch.float32,
                        device=dev)
    gt_valid = torch.arange(g, device=dev)[None] < num_boxes[:, None]

    cand = torch.cat([proposals, gt_boxes[..., :4]], dim=1)       # (B, N+G, 4)
    cvalid = torch.cat([prop_valid, gt_valid], dim=1)
    overlaps = box_ops.bbox_overlaps_batch(cand, gt_boxes[..., :4])
    overlaps = torch.where(gt_valid[:, None, :], overlaps,
                           torch.full_like(overlaps, -1.0))
    max_ov = overlaps.max(dim=2).values
    arg_gt = torch.argmax(overlaps, dim=2)

    fg = cvalid & (max_ov >= cfg.fg_thresh)
    bg = cvalid & (max_ov < cfg.bg_thresh_hi) & (max_ov >= cfg.bg_thresh_lo)
    fg_count = fg.sum(dim=1)
    bg_count = bg.sum(dim=1)
    _, fg_order = _masked_rank(draws[:, 0], fg)
    _, bg_order = _masked_rank(draws[:, 1], bg)

    # Quotas per the reference's three cases (fg and bg / fg only / bg only).
    n_fg = torch.where(bg_count > 0, torch.clamp(fg_count, max=fg_quota),
                       torch.full_like(fg_count, s))
    n_fg = torch.where(fg_count > 0, n_fg, torch.zeros_like(n_fg))
    slots = torch.arange(s, device=dev)[None]
    take_fg = slots < n_fg[:, None]
    fg_pick = torch.gather(fg_order, 1,
                           slots % torch.clamp(fg_count, min=1)[:, None])
    bg_pick = torch.gather(bg_order, 1, (slots - n_fg[:, None])
                           % torch.clamp(bg_count, min=1)[:, None])
    pick = torch.where(take_fg, fg_pick, bg_pick)
    # No fg and no bg at all: dead slots at candidate 0, labelled bg.
    any_cand = (fg_count + bg_count) > 0

    rois = torch.gather(cand, 1, pick[..., None].expand(b, s, 4))
    matched_gt = torch.gather(
        gt_boxes, 1, torch.gather(arg_gt, 1, pick)[..., None].expand(b, s, 5))
    labels = torch.where(take_fg, matched_gt[..., 4].long(), 0)
    labels = torch.where(any_cand[:, None], labels, 0)

    targets = box_ops.bbox_transform(rois, matched_gt[..., :4])
    targets = (targets - means) / stds
    inside_w = torch.where(
        take_fg[..., None],
        torch.tensor(cfg.bbox_inside_weights, dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.float32, device=dev))
    return RoiSamples(rois, labels, targets, inside_w, take_fg)

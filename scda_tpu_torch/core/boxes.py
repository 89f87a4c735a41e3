"""Box and anchor math (port of ``scda_tpu/core/boxes.py``).

Boxes are ``(x1, y1, x2, y2)`` in pixels with the reference lineage's
"+1" size convention: a box is ``x2 - x1 + 1`` wide (``LEGACY_PLUS_ONE``).
Anchors are built once per feature size in numpy, as in the reference;
everything else works on tensors of any leading shape, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

LEGACY_PLUS_ONE = 1.0


def generate_base_anchors(
    base_size: int = 16,
    ratios=(0.5, 1.0, 2.0),
    scales=(8.0, 16.0, 32.0),
) -> np.ndarray:
    """The A = len(ratios) * len(scales) anchors of the (0, 0) cell,
    float32 (A, 4): area-preserving ratio enumeration with rounding, then
    scaling (ref ``generate_anchors``)."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)

    base = np.array([0, 0, base_size - 1, base_size - 1], dtype=np.float64)
    w = base[2] - base[0] + LEGACY_PLUS_ONE
    h = base[3] - base[1] + LEGACY_PLUS_ONE
    x_ctr = base[0] + 0.5 * (w - LEGACY_PLUS_ONE)
    y_ctr = base[1] + 0.5 * (h - LEGACY_PLUS_ONE)

    size = w * h
    ws = np.round(np.sqrt(size / ratios))
    hs = np.round(ws * ratios)
    ws = (ws[:, None] * scales[None, :]).reshape(-1)
    hs = (hs[:, None] * scales[None, :]).reshape(-1)

    anchors = np.stack(
        [
            x_ctr - 0.5 * (ws - LEGACY_PLUS_ONE),
            y_ctr - 0.5 * (hs - LEGACY_PLUS_ONE),
            x_ctr + 0.5 * (ws - LEGACY_PLUS_ONE),
            y_ctr + 0.5 * (hs - LEGACY_PLUS_ONE),
        ],
        axis=1,
    )
    return anchors.astype(np.float32)


def shift_anchors(
    base_anchors: np.ndarray, feat_height: int, feat_width: int, stride: int
) -> np.ndarray:
    """Tile the base anchors over every feature cell: float32 (H*W*A, 4),
    cell-major then anchor — the order of the RPN head's outputs."""
    shift_x = np.arange(feat_width, dtype=np.float32) * stride
    shift_y = np.arange(feat_height, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = (base_anchors[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
    return all_anchors.astype(np.float32)


def box_wh_ctr(boxes: torch.Tensor):
    """Widths, heights and centres of boxes (..., 4)."""
    w = boxes[..., 2] - boxes[..., 0] + LEGACY_PLUS_ONE
    h = boxes[..., 3] - boxes[..., 1] + LEGACY_PLUS_ONE
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return w, h, cx, cy


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor,
                       clip_exp: float = 4.135) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to boxes; shapes broadcast.

    dw and dh are clipped to ``clip_exp`` (log(1000/16)) before the exp.
    """
    w, h, cx, cy = box_wh_ctr(boxes)
    dx, dy = deltas[..., 0], deltas[..., 1]
    dw = torch.clamp(deltas[..., 2], -clip_exp, clip_exp)
    dh = torch.clamp(deltas[..., 3], -clip_exp, clip_exp)

    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack(
        [
            pcx - 0.5 * pw,
            pcy - 0.5 * ph,
            pcx + 0.5 * pw - LEGACY_PLUS_ONE,
            pcy + 0.5 * ph - LEGACY_PLUS_ONE,
        ],
        dim=-1,
    )


def clip_boxes(boxes: torch.Tensor, im_height, im_width) -> torch.Tensor:
    """Clip boxes to ``[0, size - 1]``.  ``im_height``/``im_width`` are
    numbers or tensors that broadcast against the leading box dims."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    hi_x = torch.as_tensor(im_width, dtype=boxes.dtype,
                           device=boxes.device) - LEGACY_PLUS_ONE
    hi_y = torch.as_tensor(im_height, dtype=boxes.dtype,
                           device=boxes.device) - LEGACY_PLUS_ONE
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), hi_x)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), hi_y)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), hi_x)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), hi_y)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0] + LEGACY_PLUS_ONE
    h = boxes[..., 3] - boxes[..., 1] + LEGACY_PLUS_ONE
    return torch.clamp(w, min=0.0) * torch.clamp(h, min=0.0)


def bbox_overlaps(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, (N, 4) x (M, 4) -> (N, M)."""
    ix1 = torch.maximum(boxes[:, None, 0], query[None, :, 0])
    iy1 = torch.maximum(boxes[:, None, 1], query[None, :, 1])
    ix2 = torch.minimum(boxes[:, None, 2], query[None, :, 2])
    iy2 = torch.minimum(boxes[:, None, 3], query[None, :, 3])

    iw = torch.clamp(ix2 - ix1 + LEGACY_PLUS_ONE, min=0.0)
    ih = torch.clamp(iy2 - iy1 + LEGACY_PLUS_ONE, min=0.0)
    inter = iw * ih

    union = box_area(boxes)[:, None] + box_area(query)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Encode gt boxes against example boxes as (dx, dy, dw, dh); shapes
    broadcast, (..., 4) -> (..., 4)."""
    ew, eh, ecx, ecy = box_wh_ctr(ex_rois)
    gw, gh, gcx, gcy = box_wh_ctr(gt_rois)
    ew = torch.clamp(ew, min=1e-6)
    eh = torch.clamp(eh, min=1e-6)
    dx = (gcx - ecx) / ew
    dy = (gcy - ecy) / eh
    dw = torch.log(torch.clamp(gw, min=1e-6) / ew)
    dh = torch.log(torch.clamp(gh, min=1e-6) / eh)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def bbox_overlaps_batch(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Batched pairwise IoU, (B, N, 4) x (B, M, 4) -> (B, N, M)."""
    return torch.vmap(bbox_overlaps)(boxes, query)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   inside_weights: torch.Tensor, outside_weights: torch.Tensor,
                   sigma: float = 1.0) -> torch.Tensor:
    """Weighted smooth-L1 of both box losses: Huber with its transition at
    1/sigma^2; inside weights pick the targets that count, outside
    weights normalise.  Returns the scalar sum."""
    sigma2 = sigma * sigma
    diff = inside_weights * (pred - target)
    abs_diff = torch.abs(diff)
    flag = (abs_diff < (1.0 / sigma2)).to(pred.dtype)
    per_elt = (flag * 0.5 * sigma2 * diff * diff
               + (1.0 - flag) * (abs_diff - 0.5 / sigma2))
    return torch.sum(outside_weights * per_elt)

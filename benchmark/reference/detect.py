"""Box arithmetic, anchors, proposals, training targets, losses and the
detection postprocess, in plain PyTorch and NumPy.

Frozen arithmetic copied from ``scda_tpu_torch/core/boxes.py``,
``models/rpn.py``, ``models/targets.py``, ``models/detector.py`` and
``ops/nms.py`` at commit 8b959ad8dec4.  Greedy NMS is written out as a
walk over the score-sorted boxes in NumPy float32, with the IoU in the
operation order the program's NMS keeps (``IoU > threshold`` suppresses),
so that on the same boxes it keeps the same ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PLUS_ONE = 1.0


# ---- boxes -----------------------------------------------------------------

def base_anchors(base_size=16, ratios=(0.5, 1.0, 2.0), scales=(8.0, 16.0, 32.0)):
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([0, 0, base_size - 1, base_size - 1], dtype=np.float64)
    w = base[2] - base[0] + PLUS_ONE
    h = base[3] - base[1] + PLUS_ONE
    x_ctr = base[0] + 0.5 * (w - PLUS_ONE)
    y_ctr = base[1] + 0.5 * (h - PLUS_ONE)
    size = w * h
    ws = np.round(np.sqrt(size / ratios))
    hs = np.round(ws * ratios)
    ws = (ws[:, None] * scales[None, :]).reshape(-1)
    hs = (hs[:, None] * scales[None, :]).reshape(-1)
    return np.stack([x_ctr - 0.5 * (ws - PLUS_ONE), y_ctr - 0.5 * (hs - PLUS_ONE),
                     x_ctr + 0.5 * (ws - PLUS_ONE), y_ctr + 0.5 * (hs - PLUS_ONE)],
                    axis=1).astype(np.float32)


def anchors_for(cfg, feat_hw, device) -> torch.Tensor:
    """All (h * w * A, 4) anchors of a feature map, cell-major."""
    ac = cfg.anchors
    base = base_anchors(ac.base_size, ac.ratios, ac.scales)
    stride = cfg.model.feat_stride
    sx, sy = np.meshgrid(np.arange(feat_hw[1], dtype=np.float32) * stride,
                         np.arange(feat_hw[0], dtype=np.float32) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    out = (base[None] + shifts[:, None]).reshape(-1, 4).astype(np.float32)
    return torch.from_numpy(out).to(device)


def wh_ctr(boxes):
    w = boxes[..., 2] - boxes[..., 0] + PLUS_ONE
    h = boxes[..., 3] - boxes[..., 1] + PLUS_ONE
    return w, h, boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h


def decode(boxes, deltas, clip_exp: float = 4.135):
    w, h, cx, cy = wh_ctr(boxes)
    dw = torch.clamp(deltas[..., 2], -clip_exp, clip_exp)
    dh = torch.clamp(deltas[..., 3], -clip_exp, clip_exp)
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw - PLUS_ONE, pcy + 0.5 * ph - PLUS_ONE],
                       dim=-1)


def clip(boxes, im_h, im_w):
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    hx = torch.as_tensor(im_w, dtype=boxes.dtype, device=boxes.device) - PLUS_ONE
    hy = torch.as_tensor(im_h, dtype=boxes.dtype, device=boxes.device) - PLUS_ONE
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), hx)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), hy)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), hx)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), hy)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def area(boxes):
    w = boxes[..., 2] - boxes[..., 0] + PLUS_ONE
    h = boxes[..., 3] - boxes[..., 1] + PLUS_ONE
    return torch.clamp(w, min=0.0) * torch.clamp(h, min=0.0)


def overlaps(boxes, query):
    """Batched pairwise IoU, (B, N, 4) x (B, M, 4) -> (B, N, M)."""
    ix1 = torch.maximum(boxes[..., :, None, 0], query[..., None, :, 0])
    iy1 = torch.maximum(boxes[..., :, None, 1], query[..., None, :, 1])
    ix2 = torch.minimum(boxes[..., :, None, 2], query[..., None, :, 2])
    iy2 = torch.minimum(boxes[..., :, None, 3], query[..., None, :, 3])
    inter = (torch.clamp(ix2 - ix1 + PLUS_ONE, min=0.0)
             * torch.clamp(iy2 - iy1 + PLUS_ONE, min=0.0))
    union = area(boxes)[..., :, None] + area(query)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def encode(ex, gt):
    ew, eh, ecx, ecy = wh_ctr(ex)
    gw, gh, gcx, gcy = wh_ctr(gt)
    ew, eh = torch.clamp(ew, min=1e-6), torch.clamp(eh, min=1e-6)
    return torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                        torch.log(torch.clamp(gw, min=1e-6) / ew),
                        torch.log(torch.clamp(gh, min=1e-6) / eh)], dim=-1)


def smooth_l1(pred, target, inside_w, outside_w, sigma: float):
    s2 = sigma * sigma
    diff = inside_w * (pred - target)
    a = torch.abs(diff)
    flag = (a < (1.0 / s2)).to(pred.dtype)
    per = flag * 0.5 * s2 * diff * diff + (1.0 - flag) * (a - 0.5 / s2)
    return torch.sum(outside_w * per)


# ---- greedy NMS ------------------------------------------------------------

def nms_keep(sboxes: np.ndarray, svalid: np.ndarray, thr: float,
             max_output: int) -> np.ndarray:
    """Greedy NMS of one row of score-sorted boxes (N, 4) float32: the
    keep mask, at most ``max_output`` kept, in row order."""
    b = sboxes.astype(np.float32)
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    one = np.float32(1.0)
    area_b = (x2 - x1 + one) * (y2 - y1 + one)
    alive = svalid.astype(bool).copy()
    keep = np.zeros_like(alive)
    kept = 0
    for i in range(len(b)):
        if not alive[i]:
            continue
        keep[i] = True
        kept += 1
        if kept >= max_output:
            break
        j = slice(i + 1, None)
        iw = np.maximum(np.minimum(x2[i], x2[j]) - np.maximum(x1[i], x1[j])
                        + one, np.float32(0.0))
        ih = np.maximum(np.minimum(y2[i], y2[j]) - np.maximum(y1[i], y1[j])
                        + one, np.float32(0.0))
        inter = iw * ih
        union = np.maximum(area_b[i] + area_b[j] - inter, np.float32(1e-9))
        alive[j] &= ~(inter / union > np.float32(thr))
    return keep


class NmsResult(NamedTuple):
    indices: torch.Tensor
    valid: torch.Tensor


def batched_nms(boxes, scores, valid, *, thr: float, max_output: int,
                pre_sorted: bool = False) -> NmsResult:
    """(B, N) rows -> (B, max_output) indices into each row, in score
    order (stable, the lower index first among equal scores)."""
    b, n = scores.shape
    dev = scores.device
    if pre_sorted:
        order = torch.arange(n, device=dev).expand(b, n)
        sboxes, svalid = boxes.float(), valid
    else:
        masked = torch.where(valid, scores.float(),
                             torch.full_like(scores, -1e30, dtype=torch.float32))
        ss, order = torch.sort(masked, dim=-1, descending=True, stable=True)
        sboxes = torch.gather(boxes.float(), 1, order[..., None].expand(b, n, 4))
        svalid = ss > -0.5e30
    sb, sv, od = (t.detach().cpu().numpy() for t in (sboxes, svalid, order))
    idx = np.zeros((b, max_output), np.int64)
    ok = np.zeros((b, max_output), bool)
    for r in range(b):
        pos = np.nonzero(nms_keep(sb[r], sv[r], thr, max_output))[0]
        idx[r, :len(pos)] = od[r, pos]
        ok[r, :len(pos)] = True
    return NmsResult(torch.from_numpy(idx).to(dev), torch.from_numpy(ok).to(dev))


# ---- proposals -------------------------------------------------------------

class Proposals(NamedTuple):
    boxes: torch.Tensor   # (B, N, 4)
    scores: torch.Tensor  # (B, N)
    valid: torch.Tensor   # (B, N) bool


@torch.no_grad()
def propose(cls_logits, bbox_pred, anchors, im_info, pc) -> Proposals:
    """Softmax fg score, decode, clip, size filter, top ``pre_nms_top_n``,
    NMS, ``post_nms_top_n`` slots with a validity mask."""
    b = cls_logits.shape[0]
    k = anchors.shape[0]
    scores = torch.softmax(cls_logits.float(), dim=-1)[..., 1].reshape(b, k)
    deltas = bbox_pred.float().reshape(b, k, 4)
    boxes = clip(decode(anchors[None], deltas), im_info[:, 0:1], im_info[:, 1:2])
    ws = boxes[..., 2] - boxes[..., 0] + PLUS_ONE
    hs = boxes[..., 3] - boxes[..., 1] + PLUS_ONE
    min_size = pc.min_size * im_info[:, 2:3]
    scores = torch.where((ws >= min_size) & (hs >= min_size), scores,
                         torch.full_like(scores, -1e30))
    pre = min(pc.pre_nms_top_n, k)
    ts, ti = torch.sort(scores, dim=-1, descending=True, stable=True)
    ts, ti = ts[:, :pre], ti[:, :pre]
    tb = torch.gather(boxes, 1, ti[..., None].expand(b, pre, 4))
    res = batched_nms(tb, ts, ts > -1e29, thr=pc.nms_thresh,
                      max_output=pc.post_nms_top_n, pre_sorted=True)
    ob = torch.gather(tb, 1, res.indices[..., None].expand(-1, -1, 4))
    os_ = torch.gather(ts, 1, res.indices)
    ob = torch.where(res.valid[..., None], ob, torch.zeros_like(ob))
    os_ = torch.where(res.valid, os_, torch.zeros_like(os_))
    return Proposals(ob, os_, res.valid)


# ---- training targets ------------------------------------------------------

def masked_rank(u, mask):
    score = torch.where(mask, u, torch.full_like(u, 2.0))
    order = torch.argsort(score, dim=-1, stable=True)
    return torch.argsort(order, dim=-1), order


@torch.no_grad()
def anchor_targets(anchors, gt_boxes, num_boxes, im_info, tc, u):
    """RPN labels and box targets; ``u`` (B, 2, K) uniforms."""
    b, g = gt_boxes.shape[:2]
    k = anchors.shape[0]
    dev = gt_boxes.device
    gt_valid = torch.arange(g, device=dev)[None] < num_boxes[:, None]
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] < im_info[:, 1:2])
              & (anchors[None, :, 3] < im_info[:, 0:1]))
    ov = overlaps(anchors.expand(b, k, 4), gt_boxes[..., :4])
    ov = torch.where(gt_valid[:, None, :], ov, torch.full_like(ov, -1.0))
    max_ov = ov.max(dim=2).values
    arg_gt = torch.argmax(ov, dim=2)
    gt_max = torch.where(inside[:, :, None], ov,
                         torch.full_like(ov, -2.0)).max(dim=1).values
    best = torch.any((ov >= gt_max[:, None, :] - 1e-5) & gt_valid[:, None, :]
                     & (gt_max[:, None, :] > 0), dim=2)
    labels = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    neg = max_ov < tc.negative_overlap
    pos = best | (max_ov >= tc.positive_overlap)
    order = ((neg, 0), (pos, 1))
    for mask, value in (order[::-1] if tc.clobber_positives else order):
        labels = torch.where(inside & mask, value, labels)
    fg_quota = int(tc.fg_fraction * tc.batch_size)
    fg = labels == 1
    fg_rank, _ = masked_rank(u[:, 0], fg)
    labels = torch.where(fg & (fg_rank >= fg_quota), -1, labels)
    bg_quota = tc.batch_size - (labels == 1).sum(dim=1)
    bg = labels == 0
    bg_rank, _ = masked_rank(u[:, 1], bg)
    labels = torch.where(bg & (bg_rank >= bg_quota[:, None]), -1, labels)
    matched = torch.gather(gt_boxes[..., :4], 1, arg_gt[..., None].expand(b, k, 4))
    targets = encode(anchors[None], matched)
    ones = torch.ones((1, 1, 4), dtype=torch.float32, device=dev)
    inside_w = (labels == 1).float()[..., None] * ones
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if tc.positive_weight < 0:
        n = torch.clamp((labels >= 0).float().sum(dim=1), min=1.0)
        pos_w = neg_w = (zero + 1.0) / n
    else:
        pw = tc.positive_weight
        pos_w = (zero + pw) / torch.clamp((labels == 1).float().sum(dim=1), min=1.0)
        neg_w = (zero + (1.0 - pw)) / torch.clamp(
            (labels == 0).float().sum(dim=1), min=1.0)
    outside_w = (torch.where(labels == 1, pos_w[:, None], zero)
                 + torch.where(labels == 0, neg_w[:, None], zero))[..., None] * ones
    return labels, targets, inside_w, outside_w


class RoiSamples(NamedTuple):
    rois: torch.Tensor
    labels: torch.Tensor
    targets: torch.Tensor
    inside_w: torch.Tensor
    fg: torch.Tensor


@torch.no_grad()
def proposal_targets(props, prop_valid, gt_boxes, num_boxes, tc, u) -> RoiSamples:
    """``tc.batch_size`` rois an image, the gt boxes among the candidates;
    ``u`` (B, 2, N + G) uniforms."""
    b, n, _ = props.shape
    g = gt_boxes.shape[1]
    s = tc.batch_size
    dev = props.device
    fg_quota = int(round(tc.fg_fraction * s))
    means = torch.tensor(tc.bbox_normalize_means, dtype=torch.float32, device=dev)
    stds = torch.tensor(tc.bbox_normalize_stds, dtype=torch.float32, device=dev)
    gt_valid = torch.arange(g, device=dev)[None] < num_boxes[:, None]
    cand = torch.cat([props, gt_boxes[..., :4]], dim=1)
    cvalid = torch.cat([prop_valid, gt_valid], dim=1)
    ov = overlaps(cand, gt_boxes[..., :4])
    ov = torch.where(gt_valid[:, None, :], ov, torch.full_like(ov, -1.0))
    max_ov = ov.max(dim=2).values
    arg_gt = torch.argmax(ov, dim=2)
    fg = cvalid & (max_ov >= tc.fg_thresh)
    bg = cvalid & (max_ov < tc.bg_thresh_hi) & (max_ov >= tc.bg_thresh_lo)
    fg_count, bg_count = fg.sum(dim=1), bg.sum(dim=1)
    _, fg_order = masked_rank(u[:, 0], fg)
    _, bg_order = masked_rank(u[:, 1], bg)
    n_fg = torch.where(bg_count > 0, torch.clamp(fg_count, max=fg_quota),
                       torch.full_like(fg_count, s))
    n_fg = torch.where(fg_count > 0, n_fg, torch.zeros_like(n_fg))
    slots = torch.arange(s, device=dev)[None]
    take_fg = slots < n_fg[:, None]
    fg_pick = torch.gather(fg_order, 1, slots % torch.clamp(fg_count, min=1)[:, None])
    bg_pick = torch.gather(bg_order, 1, (slots - n_fg[:, None])
                           % torch.clamp(bg_count, min=1)[:, None])
    pick = torch.where(take_fg, fg_pick, bg_pick)
    any_cand = (fg_count + bg_count) > 0
    rois = torch.gather(cand, 1, pick[..., None].expand(b, s, 4))
    matched = torch.gather(gt_boxes, 1, torch.gather(arg_gt, 1, pick)[..., None]
                           .expand(b, s, 5))
    labels = torch.where(take_fg, matched[..., 4].long(), 0)
    labels = torch.where(any_cand[:, None], labels, 0)
    targets = (encode(rois, matched[..., :4]) - means) / stds
    inside_w = torch.where(take_fg[..., None],
                           torch.tensor(tc.bbox_inside_weights, dtype=torch.float32,
                                        device=dev),
                           torch.zeros((), dtype=torch.float32, device=dev))
    return RoiSamples(rois, labels, targets, inside_w, take_fg)


# ---- losses ----------------------------------------------------------------

def rpn_losses(cls_logits, bbox_pred, labels, targets, inside_w, outside_w):
    b = cls_logits.shape[0]
    logp = torch.log_softmax(cls_logits.reshape(b, -1, 2), dim=-1)
    picked = torch.gather(logp, 2, torch.clamp(labels, min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    cls = -torch.sum(picked * mask) / torch.clamp(torch.sum(mask), min=1.0)
    box = smooth_l1(bbox_pred.reshape(b, -1, 4), targets, inside_w, outside_w,
                    sigma=3.0) / b
    return cls, box


def rcnn_losses(cls_logits, deltas, samples: RoiSamples, num_classes: int,
                class_agnostic: bool):
    bs, s = samples.labels.shape
    n = bs * s
    logp = torch.log_softmax(cls_logits.reshape(bs, s, -1), dim=-1)
    labels = samples.labels[..., None]
    cls = -torch.sum(torch.gather(logp, 2, labels)[..., 0]) / n
    if class_agnostic:
        d = deltas.reshape(bs, s, 4)
    else:
        d = deltas.reshape(bs, s, num_classes, 4)
        d = torch.gather(d, 2, labels[..., None].expand(bs, s, 1, 4))[:, :, 0]
    outside = (samples.inside_w > 0).float()
    box = smooth_l1(d, samples.targets, samples.inside_w, outside, sigma=1.0) / n
    return cls, box


# ---- postprocess -----------------------------------------------------------

class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, D, 4) original image coords
    scores: torch.Tensor   # (B, D)
    classes: torch.Tensor  # (B, D) 1-based
    valid: torch.Tensor    # (B, D)


def class_boxes(props, cls_logits, deltas, im_info, cfg):
    """Per-class probabilities (B, N, C) and decoded, clipped boxes
    (B, N, C, 4) in canvas coords."""
    mc = cfg.model
    b, n, _ = props.boxes.shape
    c = mc.num_classes
    probs = torch.softmax(cls_logits.float().reshape(b, n, c), dim=-1)
    if mc.class_agnostic:
        d = deltas.float().reshape(b, n, 1, 4).expand(b, n, c, 4)
    else:
        d = deltas.float().reshape(b, n, c, 4)
    rt = cfg.train.roi_target
    stds = torch.tensor(rt.bbox_normalize_stds, dtype=torch.float32, device=d.device)
    means = torch.tensor(rt.bbox_normalize_means, dtype=torch.float32, device=d.device)
    boxes = decode(props.boxes[:, :, None, :], d * stds + means)
    boxes = clip(boxes, im_info[:, 0, None, None], im_info[:, 1, None, None])
    return probs, boxes


def postprocess(props, probs, boxes, im_info, cfg) -> Detections:
    """Per-class score threshold and NMS, then the top ``max_per_image``
    across classes, unscaled to original image coords."""
    tc = cfg.test
    b, n, c = probs.shape
    fg = c - 1
    d_cls = tc.max_dets_per_class
    cb = boxes[:, :, 1:, :].permute(0, 2, 1, 3).reshape(b * fg, n, 4)
    cs = probs[:, :, 1:].permute(0, 2, 1).reshape(b * fg, n)
    cv = (props.valid[:, None, :].expand(b, fg, n).reshape(b * fg, n)
          & (cs > tc.score_thresh))
    res = batched_nms(cb, cs, cv, thr=tc.nms_thresh, max_output=d_cls)
    kb = torch.gather(cb, 1, res.indices[..., None].expand(-1, -1, 4))
    ks = torch.gather(cs, 1, res.indices)
    ks = torch.where(res.valid, ks, torch.full_like(ks, -1.0))
    d = fg * d_cls
    fb, fs = kb.reshape(b, d, 4), ks.reshape(b, d)
    fc = torch.arange(1, c, device=fs.device).repeat_interleave(d_cls).expand(b, d)
    k = min(tc.max_per_image, d)
    ts, ti = torch.sort(fs, dim=-1, descending=True, stable=True)
    ts, ti = ts[:, :k], ti[:, :k]
    db = torch.gather(fb, 1, ti[..., None].expand(b, k, 4)) / im_info[:, 2][:, None, None]
    return Detections(db, ts, torch.gather(fc, 1, ti), ts > 0)

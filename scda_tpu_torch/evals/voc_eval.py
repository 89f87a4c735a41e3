"""VOC-style average precision evaluation.

Rebuild of ref lib/datasets/voc_eval.py (~200 LoC) with the same
protocol semantics: per-class greedy matching of score-sorted detections
to ground truth at IoU >= ``ovthresh``, difficult boxes neither count as
positives nor as false positives, and AP is either the VOC-07 11-point
interpolation or the continuous AUC ("use_07_metric" switch).  Host-side
numpy — evaluation is offline bookkeeping, not a TPU hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from recall/precision points (ref voc_eval.py:~30)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    if boxes.size == 0:
        return np.zeros((0,))
    ixmin = np.maximum(boxes[:, 0], box[0])
    iymin = np.maximum(boxes[:, 1], box[1])
    ixmax = np.minimum(boxes[:, 2], box[2])
    iymax = np.minimum(boxes[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inters = iw * ih
    uni = (
        (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
        + (boxes[:, 2] - boxes[:, 0] + 1.0)
        * (boxes[:, 3] - boxes[:, 1] + 1.0)
        - inters
    )
    return inters / np.maximum(uni, 1e-9)


@dataclass
class ClassEval:
    ap: float
    recall: np.ndarray
    precision: np.ndarray
    num_gt: int
    num_det: int


def eval_class(
    gt_by_image: Dict[str, Tuple[np.ndarray, np.ndarray]],
    det_images: Sequence[str],
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
) -> ClassEval:
    """Evaluate one class (ref voc_eval.py:~90-190).

    gt_by_image: image_id -> (boxes (G, 4), difficult (G,) bool).
    det_*: flat arrays over all detections of this class.
    """
    npos = sum(int((~diff).sum()) for _, diff in gt_by_image.values())
    matched = {
        img: np.zeros(len(boxes), bool)
        for img, (boxes, _) in gt_by_image.items()
    }

    order = np.argsort(-det_scores, kind="stable")
    nd = len(order)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for rank, d in enumerate(order):
        img = det_images[d]
        if img not in gt_by_image:
            fp[rank] = 1.0
            continue
        gboxes, gdiff = gt_by_image[img]
        ious = _iou_one_to_many(det_boxes[d], gboxes)
        # Strict > matches the canonical protocol (ref voc_eval.py:~160
        # ``if ovmax > ovthresh``): a detection at exactly IoU==ovthresh
        # is a false positive, not a match.
        if ious.size and ious.max() > ovthresh:
            j = int(ious.argmax())
            if gdiff[j]:
                pass  # difficult: ignore entirely
            elif not matched[img][j]:
                tp[rank] = 1.0
                matched[img][j] = True
            else:
                fp[rank] = 1.0
        else:
            fp[rank] = 1.0

    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    rec = ctp / max(npos, 1)
    prec = ctp / np.maximum(ctp + cfp, np.finfo(np.float64).eps)
    return ClassEval(
        ap=voc_ap(rec, prec, use_07_metric),
        recall=rec,
        precision=prec,
        num_gt=npos,
        num_det=nd,
    )


def evaluate_detections(
    dataset,
    all_dets: Dict[str, List[Tuple[str, np.ndarray, float]]],
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
) -> Dict[str, float]:
    """Full-dataset evaluation (ref imdb.evaluate_detections +
    pascal_voc._do_python_eval).

    all_dets: class_name -> list of (image_id, box (4,), score).
    Returns {class: AP, ..., 'mAP': mean}.
    """
    results: Dict[str, float] = {}
    aps = []
    for ci, cls in enumerate(dataset.classes):
        gt_by_image = {}
        for rec in dataset.records:
            sel = rec.labels == (ci + 1)
            gt_by_image[rec.image_id] = (rec.boxes[sel], rec.difficult[sel])
        dets = all_dets.get(cls, [])
        if dets:
            imgs = [d[0] for d in dets]
            boxes = np.asarray([d[1] for d in dets], np.float64)
            scores = np.asarray([d[2] for d in dets], np.float64)
        else:
            imgs, boxes, scores = [], np.zeros((0, 4)), np.zeros((0,))
        ce = eval_class(gt_by_image, imgs, boxes, scores, ovthresh,
                        use_07_metric)
        results[cls] = ce.ap
        aps.append(ce.ap)
    results["mAP"] = float(np.mean(aps)) if aps else 0.0
    return results


def evaluate_detections_iou_sweep(
    dataset,
    all_dets: Dict[str, List[Tuple[str, np.ndarray, float]]],
    thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
) -> Dict[str, float]:
    """COCO-style averaged mAP over an IoU sweep (default .5:.95:.05).

    Beyond the reference (which only evaluates VOC AP@0.5); useful for
    stricter localization comparisons.  Returns {'mAP@[.5:.95]': ...,
    'mAP@0.50': ..., 'mAP@0.75': ...}.
    """
    maps = {}
    for t in thresholds:
        r = evaluate_detections(dataset, all_dets, ovthresh=float(t))
        maps[round(float(t), 2)] = r["mAP"]
    out = {
        "mAP@[.5:.95]": float(np.mean(list(maps.values()))),
        "mAP@0.50": maps.get(0.5, 0.0),
        "mAP@0.75": maps.get(0.75, 0.0),
    }
    return out

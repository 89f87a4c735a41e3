"""Dataset evaluation (port of ``scda_tpu/evals/detect.py``): run
inference over a dataset through the ``DataLoader``, collect the
fixed-size detections, score them with the VOC evaluator."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from scda_tpu_torch.config import Config
from scda_tpu_torch.data.pipeline import DataLoader
from scda_tpu_torch.data.voc import Dataset
from scda_tpu_torch.evals.voc_eval import evaluate_detections
from scda_tpu_torch.models.detector import forward_inference
from scda_tpu_torch.models.faster_rcnn import FasterRCNN


def bf16_inference_params(model: FasterRCNN) -> FasterRCNN:
    """Cast the model's >= 2-D float32 parameters (kernels) to bfloat16 in
    place, for serving: half the weight bytes per forward.  Biases stay
    float32; each forward casts them to the compute dtype."""
    for p in model.parameters():
        if p.dtype == torch.float32 and p.dim() >= 2:
            p.data = p.data.to(torch.bfloat16)
    return model


def run_inference(model: FasterRCNN, dataset: Dataset, cfg: Config, *,
                  device: torch.device | str, batch_size: int = 1,
                  progress: bool = False):
    """Returns (all_dets for evaluate_detections, images/sec).

    The images/sec leave out every first batch of a canvas shape (the
    first forward builds the CUDA kernels and warms the allocator and
    cuDNN); when every batch is such a first, they include it.
    """
    if cfg.test.bf16_weights:
        model = bf16_inference_params(model)
    loader = DataLoader(dataset, cfg.data, batch_size, shuffle=False,
                        augment_flip=False, pad_final=True)
    # Wrap-padded slots repeat earlier records; ``seen`` skips them.
    ids = [r.image_id for r in dataset.records]
    all_dets = defaultdict(list)
    seen = set()
    t0 = time.perf_counter()
    warmup_time = 0.0
    warm_shapes: set = set()
    excluded_images = 0
    for bi, batch in enumerate(loader):
        tb = time.perf_counter()
        image = torch.from_numpy(batch.image).to(device)
        im_info = torch.from_numpy(batch.im_info).to(device)
        dets = forward_inference(model, image, im_info, cfg)
        dets = [t.cpu().numpy() for t in dets]   # waits for the device
        boxes, scores, classes, valid = dets
        first_of_shape = batch.image.shape not in warm_shapes
        if first_of_shape:
            warm_shapes.add(batch.image.shape)
            warmup_time += time.perf_counter() - tb
        for k in range(batch.image.shape[0]):
            rec_idx = int(batch.indices[k])
            if rec_idx in seen:
                continue
            if first_of_shape:
                excluded_images += 1
            seen.add(rec_idx)
            for j in np.nonzero(valid[k])[0]:
                cls_name = dataset.classes[int(classes[k, j]) - 1]
                all_dets[cls_name].append(
                    (ids[rec_idx], boxes[k, j].astype(np.float64),
                     float(scores[k, j])))
        if progress and bi % 20 == 0:
            print(f"  eval {len(seen)}/{len(ids)}", flush=True)
    total = time.perf_counter() - t0
    measured = len(seen) - min(excluded_images, len(seen))
    if measured > 0:
        ips = measured / max(total - warmup_time, 1e-9)
    else:
        ips = len(seen) / max(total, 1e-9)
    return dict(all_dets), ips


def _same_box(box, box2, iou_min: float) -> bool:
    """IoU (legacy +1 areas) >= ``iou_min``, or every coordinate within
    0.01 px: a degenerate box (x2 < x1 - 1, which random weights can
    decode) has no area, so only its coordinates can agree."""
    if np.abs(box - box2).max() <= 1e-2:
        return True
    iw = max(0.0, min(box[2], box2[2]) - max(box[0], box2[0]) + 1.0)
    ih = max(0.0, min(box[3], box2[3]) - max(box[1], box2[1]) + 1.0)
    inter = iw * ih
    area = ((box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
            + (box2[2] - box2[0] + 1.0) * (box2[3] - box2[1] + 1.0))
    return inter / max(area - inter, 1e-9) >= iou_min


def detection_match_rate(dets_a, dets_b, *, iou_min: float = 0.99,
                         score_tol: float = 1e-3):
    """Agreement of two detection sets of the same images.

    ``dets_a``/``dets_b``: (boxes (B, D, 4), scores (B, D), classes
    (B, D), valid (B, D)) as numpy arrays or tensors, e.g. a
    ``Detections`` of either package.  Two valid detections may match
    when image and class agree, the boxes agree (:func:`_same_box`) and
    the scores differ by at most ``score_tol``; the count is a maximum
    one-to-one matching (augmenting paths), so near-duplicate detections
    cannot steal each other's partners.  Returns (matched / the larger
    count, count in a, count in b); near-tied scores may legitimately
    reorder, so this is a rate and not an equality.
    """
    def grouped(dets):
        boxes, scores, classes, valid = (
            t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in dets)
        groups = defaultdict(list)
        for i in range(valid.shape[0]):
            for j in np.nonzero(valid[i])[0]:
                groups[(i, int(classes[i, j]))].append(
                    (boxes[i, j].astype(np.float64), float(scores[i, j])))
        return groups, int(valid.sum())

    ga, n_a = grouped(dets_a)
    gb, n_b = grouped(dets_b)
    matched = 0
    for key, a in ga.items():
        b = gb.get(key, [])
        adj = [[k for k, (box2, s2) in enumerate(b)
                if abs(s - s2) <= score_tol and _same_box(box, box2, iou_min)]
               for box, s in a]
        partner = {}   # index in b -> index in a

        def augment(i, seen):
            for k in adj[i]:
                if k not in seen:
                    seen.add(k)
                    if k not in partner or augment(partner[k], seen):
                        partner[k] = i
                        return True
            return False

        matched += sum(augment(i, set()) for i in range(len(a)))
    return matched / max(n_a, n_b, 1), n_a, n_b


def evaluate_model(model: FasterRCNN, dataset: Dataset, cfg: Config, *,
                   device: torch.device | str, batch_size: int = 1,
                   use_07_metric: bool = False,
                   progress: bool = False) -> Dict[str, float]:
    """Inference + VOC AP@0.5 per class and mAP, plus images/sec."""
    all_dets, ips = run_inference(model, dataset, cfg, device=device,
                                  batch_size=batch_size, progress=progress)
    results = evaluate_detections(dataset, all_dets,
                                  use_07_metric=use_07_metric)
    results["images_per_sec"] = ips
    return results

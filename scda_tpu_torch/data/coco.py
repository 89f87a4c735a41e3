"""COCO-JSON dataset loading (upstream-inherited family).

Rebuild of the reference's auxiliary dataset adapters
(ref lib/datasets/coco.py ~390 LoC, imagenet.py, vg.py — upstream
lineage, unused by the SCDA experiments but part of the framework's
dataset surface).  pycocotools is not in this image, so the annotation
JSON is parsed directly (it is plain JSON); boxes convert from COCO
``[x, y, w, h]`` to the framework's ``(x1, y1, x2, y2)``.

Evaluation runs through the framework's VOC-protocol evaluator at
IoU 0.5 (``evals.voc_eval``); COCO's averaged-IoU mAP metric is out of
scope (the reference itself only reports VOC-style numbers for SCDA).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from scda_tpu_torch.data.voc import Dataset, ImageRecord, register_dataset


def load_coco_dataset(
    annotation_json: str,
    image_root: str,
    name: str = "coco",
    classes: Optional[Sequence[str]] = None,
    keep_empty: bool = False,
    max_images: int = 0,
) -> Dataset:
    """Load a COCO-format annotation file into a :class:`Dataset`.

    Args:
      annotation_json: path to instances_*.json.
      image_root: directory containing the images (``file_name`` field).
      classes: restrict to these category names (order = label ids);
        default uses every category in the file, id-sorted.
      keep_empty: keep images without annotations.
      max_images: optional cap (0 = all).
    """
    with open(annotation_json) as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    if classes is None:
        classes = tuple(c["name"] for c in cats)
    name_to_label = {c: i + 1 for i, c in enumerate(classes)}
    catid_to_label = {
        c["id"]: name_to_label[c["name"]]
        for c in cats
        if c["name"] in name_to_label
    }

    anns_by_image: Dict[int, List[dict]] = {}
    for ann in coco.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    records: List[ImageRecord] = []
    for img in coco.get("images", []):
        anns = anns_by_image.get(img["id"], [])
        boxes, labels, crowd = [], [], []
        for a in anns:
            label = catid_to_label.get(a["category_id"])
            if label is None:
                continue
            x, y, w, h = a["bbox"]
            # COCO xywh -> inclusive corner coords (the framework's
            # convention, matching the reference's VOC parsing).
            x2 = x + max(w - 1.0, 0.0)
            y2 = y + max(h - 1.0, 0.0)
            boxes.append([x, y, x2, y2])
            labels.append(label)
            crowd.append(bool(a.get("iscrowd", 0)))
        # Crowd regions stay as ignore gts (difficult=True): the
        # training pipeline drops difficult boxes (mirroring the
        # reference's roidb filtering), while the COCO-protocol
        # evaluator scores detections overlapping them with crowd-IoU
        # instead of as false positives (pycocotools semantics).
        crowd_arr = np.asarray(crowd, bool)
        # An image whose only annotations are crowds counts as empty for
        # the load-time filter (same images dropped as before, when
        # crowds were stripped entirely).
        if not keep_empty and (not boxes or crowd_arr.all()):
            continue
        records.append(
            ImageRecord(
                image_id=str(img["id"]),
                image_path=os.path.join(image_root, img["file_name"]),
                width=int(img["width"]),
                height=int(img["height"]),
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int32),
                difficult=crowd_arr.copy(),
                iscrowd=crowd_arr,
            )
        )
        if max_images and len(records) >= max_images:
            break
    return Dataset(name=name, classes=tuple(classes), records=records)


def register_coco(data_root: Optional[str] = None) -> None:
    """Register coco_{train,val}2017-style names if the files exist
    (ref lib/datasets/factory.py's coco loop)."""
    root = data_root or os.environ.get("SCDA_DATA_ROOT", "data")
    for split in ("train2017", "val2017", "train2014", "val2014"):
        ann = os.path.join(root, "coco", "annotations",
                           f"instances_{split}.json")
        img = os.path.join(root, "coco", "images", split)

        def factory(ann=ann, img=img, split=split):
            return load_coco_dataset(ann, img, name=f"coco_{split}")

        register_dataset(f"coco_{split}", factory)


register_coco()

"""RAW Cityscapes / Foggy-Cityscapes / KITTI dataset adapters.

The reference's SCDA experiments consume VOC-XML *conversions* of these
datasets (ref lib/datasets/cityscape.py loads a pre-converted
``CityscapesVOC`` tree — SURVEY.md §2b); the conversion itself lives
outside the reference repo.  These adapters close that gap: they read
the ORIGINAL distributions directly, so the fidelity runbooks work
whether the user supplies converted trees or raw downloads — and
``scripts/convert_to_voc.py`` uses the same parsers to materialise the
VOC trees the reference-style registry names expect.

Raw layouts handled:

  Cityscapes (cityscapes.com packages):
    leftImg8bit/{split}/{city}/{stem}_leftImg8bit.png
    gtFine/{split}/{city}/{stem}_gtFine_polygons.json
  Instance boxes = axis-aligned hulls of the labelled polygons for the
  8 SCDA classes (paper Table 1); ``group`` labels (e.g. ``cargroup``,
  ridergroup) are kept as DIFFICULT boxes — they are crowd-like regions
  a detector should neither be required to find nor punished for
  finding (mirrors VOC difficult semantics in evals/voc_eval.py).

  Foggy-Cityscapes (Sakaridis et al.):
    leftImg8bit_foggy/{split}/{city}/{stem}_leftImg8bit_foggy_beta_{b}.png
  Same gtFine annotations as clear Cityscapes; ``beta`` selects the fog
  density (the paper evaluates 0.02, the densest published level).

  KITTI object detection (training split):
    {training|testing}/image_2/{id}.png
    {training}/label_2/{id}.txt  — one object per line:
      type trunc occl alpha x1 y1 x2 y2 ...
  ``DontCare`` regions and (optionally) heavily-occluded instances map
  to difficult.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from scda_tpu_torch.data.voc import (
    CAR_ONLY_CLASSES, CITYSCAPES_CLASSES, Dataset, ImageRecord,
    register_dataset,
)


def polygons_to_record(
    payload: dict,
    image_id: str,
    image_path: str,
    classes: Sequence[str],
) -> ImageRecord:
    """One gtFine ``*_polygons.json`` -> ImageRecord.

    ``<cls>group`` labels become difficult boxes; polygon boxes are
    clipped to the image.
    """
    width = int(payload["imgWidth"])
    height = int(payload["imgHeight"])
    cls_to_label = {c: i + 1 for i, c in enumerate(classes)}
    boxes: List[List[float]] = []
    labels: List[int] = []
    difficult: List[bool] = []
    for obj in payload.get("objects", []):
        name = obj.get("label", "")
        is_group = False
        if name.endswith("group"):
            name = name[: -len("group")]
            is_group = True
        if name not in cls_to_label:
            continue
        poly = np.asarray(obj.get("polygon", []), np.float32)
        if poly.ndim != 2 or len(poly) < 3:
            continue
        x1 = float(np.clip(poly[:, 0].min(), 0, width - 1))
        y1 = float(np.clip(poly[:, 1].min(), 0, height - 1))
        x2 = float(np.clip(poly[:, 0].max(), 0, width - 1))
        y2 = float(np.clip(poly[:, 1].max(), 0, height - 1))
        if x2 <= x1 or y2 <= y1:
            continue
        boxes.append([x1, y1, x2, y2])
        labels.append(cls_to_label[name])
        difficult.append(is_group)
    return ImageRecord(
        image_id=image_id, image_path=image_path, width=width,
        height=height,
        boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
        labels=np.asarray(labels, np.int32),
        difficult=np.asarray(difficult, bool),
    )


def load_cityscapes_dataset(
    root: str,
    split: str = "train",
    classes: Sequence[str] = CITYSCAPES_CLASSES,
    foggy_beta: Optional[float] = None,
    keep_empty: bool = False,
    name: Optional[str] = None,
    max_images: int = 0,
) -> Dataset:
    """Load raw Cityscapes (or Foggy with ``foggy_beta``) directly.

    ``root`` contains ``leftImg8bit[_foggy]/`` and ``gtFine/``.
    """
    if foggy_beta is not None:
        img_dirname = "leftImg8bit_foggy"
        suffix = f"_leftImg8bit_foggy_beta_{foggy_beta:g}.png"
    else:
        img_dirname = "leftImg8bit"
        suffix = "_leftImg8bit.png"
    img_root = os.path.join(root, img_dirname, split)
    ann_root = os.path.join(root, "gtFine", split)
    if not os.path.isdir(img_root):
        raise FileNotFoundError(f"no {img_dirname}/{split} under {root}")

    records: List[ImageRecord] = []
    for city in sorted(os.listdir(img_root)):
        city_dir = os.path.join(img_root, city)
        if not os.path.isdir(city_dir):
            continue
        for fname in sorted(os.listdir(city_dir)):
            if not fname.endswith(suffix):
                continue
            stem = fname[: -len(suffix)]
            ann = os.path.join(ann_root, city,
                               f"{stem}_gtFine_polygons.json")
            img_path = os.path.join(city_dir, fname)
            if os.path.exists(ann):
                with open(ann) as f:
                    payload = json.load(f)
                rec = polygons_to_record(payload, stem, img_path, classes)
            else:
                # Unlabeled target-domain image.
                from PIL import Image

                with Image.open(img_path) as im:
                    w, h = im.size
                rec = ImageRecord(
                    image_id=stem, image_path=img_path, width=w, height=h,
                    boxes=np.zeros((0, 4), np.float32),
                    labels=np.zeros((0,), np.int32),
                    difficult=np.zeros((0,), bool),
                )
            if not keep_empty and not np.any(~rec.difficult):
                continue
            records.append(rec)
            if max_images and len(records) >= max_images:
                break
        if max_images and len(records) >= max_images:
            break
    ds_name = name or (
        f"cityscapes_raw_{split}" if foggy_beta is None
        else f"foggy_cityscapes_raw_{split}")
    return Dataset(name=ds_name, classes=tuple(classes), records=records)


# KITTI class name -> SCDA car-only label (the paper's Table 3 uses
# cars; Van is commonly folded into car in KITTI->Cityscapes protocols).
KITTI_CAR_TYPES = ("Car", "Van")


def parse_kitti_label(
    text: str, width: int, height: int,
    car_types: Sequence[str] = KITTI_CAR_TYPES,
    max_occlusion: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One KITTI label_2 file -> (boxes, labels, difficult).

    DontCare regions and instances occluded beyond ``max_occlusion``
    become difficult (ignored by the VOC evaluator, never FPs).
    """
    boxes, labels, difficult = [], [], []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 8:
            continue
        typ = parts[0]
        occl = int(float(parts[2])) if parts[2] != "-1" else 0
        x1, y1, x2, y2 = (float(parts[4]), float(parts[5]),
                          float(parts[6]), float(parts[7]))
        x1 = max(x1, 0.0)
        y1 = max(y1, 0.0)
        x2 = min(x2, width - 1.0)
        y2 = min(y2, height - 1.0)
        if x2 <= x1 or y2 <= y1:
            continue
        if typ in car_types:
            boxes.append([x1, y1, x2, y2])
            labels.append(1)
            difficult.append(occl > max_occlusion)
        elif typ == "DontCare":
            boxes.append([x1, y1, x2, y2])
            labels.append(1)
            difficult.append(True)
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32), np.asarray(difficult, bool))


def load_kitti_dataset(
    root: str,
    split: str = "training",
    keep_empty: bool = False,
    name: str = "kitti_raw",
    max_images: int = 0,
) -> Dataset:
    """Load raw KITTI object detection (car-only label map)."""
    from PIL import Image

    img_dir = os.path.join(root, split, "image_2")
    lbl_dir = os.path.join(root, split, "label_2")
    if not os.path.isdir(img_dir):
        raise FileNotFoundError(f"no {split}/image_2 under {root}")
    records: List[ImageRecord] = []
    for fname in sorted(os.listdir(img_dir)):
        if not fname.endswith((".png", ".jpg")):
            continue
        stem = os.path.splitext(fname)[0]
        img_path = os.path.join(img_dir, fname)
        with Image.open(img_path) as im:
            w, h = im.size
        lbl = os.path.join(lbl_dir, stem + ".txt")
        if os.path.exists(lbl):
            with open(lbl) as f:
                boxes, labels, difficult = parse_kitti_label(f.read(), w, h)
        else:
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
            difficult = np.zeros((0,), bool)
        # Difficult-only records (all DontCare / occluded) carry no
        # trainable gt — prepare_gt_boxes drops difficult boxes — so
        # they are filtered like empty ones (ref filter_roidb).
        if not keep_empty and not np.any(~difficult):
            continue
        records.append(ImageRecord(
            image_id=stem, image_path=img_path, width=w, height=h,
            boxes=boxes, labels=labels, difficult=difficult,
        ))
        if max_images and len(records) >= max_images:
            break
    return Dataset(name=name, classes=CAR_ONLY_CLASSES, records=records)


def register_raw_datasets(data_root: Optional[str] = None) -> None:
    """Register ``*_raw_*`` names beside the VOC-converted registry
    (data/voc.py): raw downloads work without any conversion step."""
    root = data_root or os.environ.get("SCDA_DATA_ROOT", "data")
    city = os.path.join(root, "Cityscapes")
    for split in ("train", "val"):
        # Eval splits keep empty/difficult-only images (dropping them
        # would hide false positives and inflate AP); only train mirrors
        # the reference's filter_roidb drop — same policy as the
        # VOC-converted registry (voc.py register loop).
        keep = split != "train"
        register_dataset(
            f"cityscapes_raw_{split}",
            lambda split=split, keep=keep: load_cityscapes_dataset(
                city, split, keep_empty=keep))
        register_dataset(
            f"cityscapes_raw_car_{split}",
            lambda split=split, keep=keep: load_cityscapes_dataset(
                city, split, classes=CAR_ONLY_CLASSES, keep_empty=keep,
                name=f"cityscapes_raw_car_{split}"))
        register_dataset(
            f"foggy_cityscapes_raw_{split}",
            lambda split=split: load_cityscapes_dataset(
                city, split, foggy_beta=0.02, keep_empty=True))
    register_dataset(
        "kitti_raw_train",
        lambda: load_kitti_dataset(os.path.join(root, "KITTI")))
    # Stock SIM10k ships VOC-layout already, with the trainval10k split
    # file — only the directory/split names differ from the converted
    # SIM10kVOC convention.
    from scda_tpu_torch.data.voc import load_voc_dataset

    register_dataset(
        "sim10k_raw_train",
        lambda: load_voc_dataset(
            os.path.join(root, "Sim10k"), "trainval10k",
            CAR_ONLY_CLASSES, name="sim10k_raw_train"))


register_raw_datasets()

"""VOC-XML dataset abstraction.

Rebuild of the reference data layer (L4):
  - ``imdb`` base + registry      (ref lib/datasets/imdb.py:~20-280,
                                   lib/datasets/factory.py:~10-60)
  - ``pascal_voc`` XML parsing    (ref lib/datasets/pascal_voc.py:~120-220)
  - SCDA's Cityscapes/Foggy/SIM10k imdbs, which are VOC-format conversions
    (SURVEY.md §2b "VOC-format datasets").

The reference caches parsed roidbs as pickles and mutates them in-place
(flipping, ratio ranking).  Here a dataset is an immutable list of
:class:`ImageRecord`; augmentation happens in the pipeline, not by
doubling the roidb.  Image decoding uses PIL/tf on the host; everything
downstream of :mod:`scda_tpu_torch.data.pipeline` is fixed-shape arrays.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Class lists ---------------------------------------------------------------

# Cityscapes 8 detection classes used by SCDA experiments (paper Table 1).
CITYSCAPES_CLASSES = (
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
)

# SIM10k -> Cityscapes is car-only (paper Table 2).
CAR_ONLY_CLASSES = ("car",)

PASCAL_VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


@dataclass
class ImageRecord:
    """One image + its ground truth. Boxes are (x1, y1, x2, y2) float32
    pixel coords, 0-based; ``labels`` are 1-based class ids (0 = background
    is never stored)."""

    image_id: str
    image_path: str
    width: int
    height: int
    boxes: np.ndarray        # (G, 4) float32
    labels: np.ndarray       # (G,) int32
    difficult: np.ndarray    # (G,) bool
    # COCO crowd regions (always also difficult=True): excluded from
    # training and from npos like difficult boxes, but the COCO-protocol
    # evaluator scores overlapping detections with crowd-IoU
    # (intersection / det-area, rematch allowed) instead of FP.
    # None means "no crowd annotations" (VOC-family datasets).
    iscrowd: Optional[np.ndarray] = None  # (G,) bool or None


@dataclass
class Dataset:
    """Immutable dataset: the reference ``imdb`` minus mutation hooks."""

    name: str
    classes: Tuple[str, ...]   # without background
    records: List[ImageRecord]

    @property
    def num_classes(self) -> int:
        """Including background, to mirror the reference's convention."""
        return len(self.classes) + 1

    def __len__(self) -> int:
        return len(self.records)


# VOC parsing ---------------------------------------------------------------


def parse_voc_xml(
    xml_path: str, class_to_id: Dict[str, int], use_difficult: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Parse one VOC annotation file.

    Mirrors ref ``pascal_voc._load_pascal_annotation``
    (lib/datasets/pascal_voc.py:~180): pixel indexes are stored 1-based in
    VOC XML, so 1 is subtracted; classes not in ``class_to_id`` are
    skipped (this is how the Cityscapes 8-class and car-only subsets are
    realised from full annotation files).
    """
    tree = ET.parse(xml_path)
    size = tree.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)

    boxes, labels, difficult = [], [], []
    for obj in tree.findall("object"):
        name = obj.find("name").text.lower().strip()
        if name not in class_to_id:
            continue
        diff_node = obj.find("difficult")
        is_diff = bool(int(diff_node.text)) if diff_node is not None else False
        # Difficult boxes stay on the record (the evaluator needs them
        # for ignore semantics); training drops them in
        # pipeline.prepare_gt_boxes, mirroring ref use_diff=False.
        if is_diff and use_difficult:
            is_diff = False  # explicit opt-in: train on difficult gt too
        bb = obj.find("bndbox")
        x1 = float(bb.find("xmin").text) - 1
        y1 = float(bb.find("ymin").text) - 1
        x2 = float(bb.find("xmax").text) - 1
        y2 = float(bb.find("ymax").text) - 1
        x1, y1 = max(x1, 0.0), max(y1, 0.0)
        x2 = min(max(x2, x1), width - 1)
        y2 = min(max(y2, y1), height - 1)
        boxes.append([x1, y1, x2, y2])
        labels.append(class_to_id[name])
        difficult.append(is_diff)

    if boxes:
        return (
            np.asarray(boxes, np.float32),
            np.asarray(labels, np.int32),
            np.asarray(difficult, bool),
            (height, width),
        )
    return (
        np.zeros((0, 4), np.float32),
        np.zeros((0,), np.int32),
        np.zeros((0,), bool),
        (height, width),
    )


def load_voc_dataset(
    root: str,
    split: str,
    classes: Sequence[str],
    name: str = "voc",
    keep_empty: bool = False,
) -> Dataset:
    """Load a VOC-layout dataset directory.

    Layout (the conversion SCDA uses for Cityscapes/Foggy/SIM10k):
      root/ImageSets/Main/{split}.txt — image ids
      root/Annotations/{id}.xml
      root/JPEGImages/{id}.jpg|.png

    ``keep_empty=False`` mirrors ref ``filter_roidb`` (trainval_net.py:~60)
    which drops images without usable gt.
    """
    class_to_id = {c: i + 1 for i, c in enumerate(classes)}
    ids_file = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
    with open(ids_file) as f:
        ids = [line.strip().split()[0] for line in f if line.strip()]

    records = []
    for image_id in ids:
        xml_path = os.path.join(root, "Annotations", f"{image_id}.xml")
        img_path = None
        for ext in (".jpg", ".png", ".jpeg"):
            cand = os.path.join(root, "JPEGImages", image_id + ext)
            if os.path.exists(cand):
                img_path = cand
                break
        if img_path is None:
            continue
        if os.path.exists(xml_path):
            boxes, labels, difficult, (h, w) = parse_voc_xml(
                xml_path, class_to_id
            )
        else:
            # Target-domain imdbs may be image-only (SURVEY.md §2b).
            from PIL import Image

            with Image.open(img_path) as im:
                w, h = im.size
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
            difficult = np.zeros((0,), bool)
        if not keep_empty and not np.any(~difficult):
            # Ref filter_roidb (trainval_net.py:~60): no *usable* gt —
            # difficult boxes don't train (pipeline.prepare_gt_boxes).
            continue
        records.append(
            ImageRecord(image_id, img_path, w, h, boxes, labels, difficult)
        )
    return Dataset(name=name, classes=tuple(classes), records=records)


# Registry (ref lib/datasets/factory.py) ------------------------------------

_REGISTRY: Dict[str, Callable[[], Dataset]] = {}


def register_dataset(name: str, factory: Callable[[], Dataset]) -> None:
    _REGISTRY[name] = factory


def get_dataset(name: str) -> Dataset:
    """Ref ``get_imdb`` (factory.py:~50)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown dataset {name!r}; registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]()


def list_datasets() -> List[str]:
    return sorted(_REGISTRY)


def _register_standard(data_root: str = None) -> None:
    """Register the SCDA experiment datasets if their roots exist.

    Directory names follow the common VOC-conversion layout used with the
    reference (``CityscapesVOC``, ``FoggyCityscapesVOC``, ``SIM10kVOC``,
    ``KITTIVOC``) under $SCDA_DATA_ROOT (default ./data).
    """
    root = data_root or os.environ.get("SCDA_DATA_ROOT", "data")
    specs = {
        # name -> (subdir, split, classes)
        "cityscapes_train": ("CityscapesVOC", "train", CITYSCAPES_CLASSES),
        "cityscapes_val": ("CityscapesVOC", "val", CITYSCAPES_CLASSES),
        "foggy_cityscapes_train": (
            "FoggyCityscapesVOC", "train", CITYSCAPES_CLASSES),
        "foggy_cityscapes_val": (
            "FoggyCityscapesVOC", "val", CITYSCAPES_CLASSES),
        "sim10k_train": ("SIM10kVOC", "train", CAR_ONLY_CLASSES),
        "cityscapes_car_train": ("CityscapesVOC", "train", CAR_ONLY_CLASSES),
        "cityscapes_car_val": ("CityscapesVOC", "val", CAR_ONLY_CLASSES),
        "kitti_train": ("KITTIVOC", "train", CAR_ONLY_CLASSES),
    }
    # Upstream PASCAL-VOC names (ref factory.py: voc_<year>_<split>);
    # layout $SCDA_DATA_ROOT/VOCdevkit/VOC<year>/.
    for year in ("2007", "2012"):
        for split in ("train", "val", "trainval", "test"):
            specs[f"voc_{year}_{split}"] = (
                os.path.join("VOCdevkit", f"VOC{year}"), split,
                PASCAL_VOC_CLASSES,
            )

    for name, (subdir, split, classes) in specs.items():
        path = os.path.join(root, subdir)

        def factory(path=path, split=split, classes=classes, name=name):
            return load_voc_dataset(path, split, classes, name=name,
                                    keep_empty=split != "train")

        register_dataset(name, factory)


_register_standard()


def load_image_dir_dataset(
    root: str,
    classes: Sequence[str] = CITYSCAPES_CLASSES,
    name: str = "image_dir",
) -> Dataset:
    """Images-only dataset from a flat directory (no annotations).

    The SCDA target domain needs no labels (SURVEY.md §3.2) — this is the
    minimal imdb for it: every image gets an empty gt set.  Mirrors the
    reference's image-only target imdbs (§2b).
    """
    from PIL import Image

    exts = (".jpg", ".jpeg", ".png", ".bmp")
    records = []
    for fname in sorted(os.listdir(root)):
        if not fname.lower().endswith(exts):
            continue
        path = os.path.join(root, fname)
        with Image.open(path) as im:
            w, h = im.size
        records.append(
            ImageRecord(
                image_id=os.path.splitext(fname)[0],
                image_path=path,
                width=w,
                height=h,
                boxes=np.zeros((0, 4), np.float32),
                labels=np.zeros((0,), np.int32),
                difficult=np.zeros((0,), bool),
            )
        )
    return Dataset(name=name, classes=tuple(classes), records=records)

"""Visual Genome dataset adapter.

Rebuild of the reference's upstream ``vg`` imdb (ref lib/datasets/vg.py
~500 LoC, bottom-up-attention lineage): per-image VOC-style XMLs (the
standard scene-graph->XML conversion) plus a vocabulary file where each
line is one class given as comma-separated synonyms
(``objects_vocab.txt``, e.g. the 1600-class split).  Object ``<name>``
fields are free-form region phrases resolved through the synonym map;
names outside the vocabulary are dropped (this is how the 1600/400/20
class splits are realised, ref vg.py ``_load_vg_annotation``).

Differences from the reference, by design: no attribute/relation heads
(the detection framework consumes boxes + object labels only), and no
pickled roidb cache.

Layout:
  root/{split}.txt              image ids
  root/xml/{id}.xml             annotations
  root/images/{id}.jpg          images (``.jpg``/``.png``)
  root/objects_vocab.txt        one class per line, comma synonyms
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from scda_tpu_torch.data.voc import Dataset, ImageRecord, register_dataset


def load_vg_vocab(vocab_file: str) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """Parse an objects_vocab-style file.

    Line i defines class i+1 (labels are 1-based; 0 = background).  A
    line may list comma-separated synonyms; the first is the canonical
    class name, all aliases map to the same label (ref vg.py:~80).
    """
    classes: List[str] = []
    alias_to_label: Dict[str, int] = {}
    with open(vocab_file) as f:
        for line in f:
            names = [n.strip().lower() for n in line.strip().split(",")
                     if n.strip()]
            if not names:
                continue
            label = len(classes) + 1
            classes.append(names[0])
            for n in names:
                alias_to_label.setdefault(n, label)
    return tuple(classes), alias_to_label


def _parse_vg_xml(
    xml_path: str, alias_to_label: Dict[str, int]
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    tree = ET.parse(xml_path)
    size = tree.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)
    boxes, labels = [], []
    for obj in tree.findall("object"):
        raw = (obj.find("name").text or "").lower().strip()
        if raw not in alias_to_label:
            continue
        bb = obj.find("bndbox")
        # VG XMLs store 1-based coords like VOC (ref vg.py subtracts 1
        # and clips; degenerate boxes in the raw scene graphs are real,
        # so the clip-then-validate order matters).
        x1 = max(float(bb.find("xmin").text) - 1, 0.0)
        y1 = max(float(bb.find("ymin").text) - 1, 0.0)
        x2 = min(float(bb.find("xmax").text) - 1, width - 1)
        y2 = min(float(bb.find("ymax").text) - 1, height - 1)
        if x2 <= x1 or y2 <= y1:
            continue
        boxes.append([x1, y1, x2, y2])
        labels.append(alias_to_label[raw])
    if boxes:
        return (np.asarray(boxes, np.float32),
                np.asarray(labels, np.int32), (height, width))
    return (np.zeros((0, 4), np.float32),
            np.zeros((0,), np.int32), (height, width))


def load_vg_dataset(
    root: str,
    split: str = "train",
    vocab_file: str = "objects_vocab.txt",
    name: str = "vg",
    keep_empty: bool = False,
    max_images: int = 0,
) -> Dataset:
    """Load a Visual Genome XML tree into a :class:`Dataset`."""
    classes, alias_to_label = load_vg_vocab(os.path.join(root, vocab_file))

    ids_file = os.path.join(root, f"{split}.txt")
    with open(ids_file) as f:
        ids = [line.strip().split()[0] for line in f if line.strip()]
    if max_images:
        ids = ids[:max_images]

    records = []
    for image_id in ids:
        img_path = None
        for ext in (".jpg", ".png", ".jpeg"):
            cand = os.path.join(root, "images", image_id + ext)
            if os.path.exists(cand):
                img_path = cand
                break
        if img_path is None:
            continue
        xml_path = os.path.join(root, "xml", image_id + ".xml")
        if os.path.exists(xml_path):
            boxes, labels, (h, w) = _parse_vg_xml(xml_path, alias_to_label)
        else:
            from PIL import Image

            with Image.open(img_path) as im:
                w, h = im.size
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
        if len(boxes) == 0 and not keep_empty:
            continue
        records.append(ImageRecord(
            image_id=image_id, image_path=img_path, width=w, height=h,
            boxes=boxes, labels=labels,
            difficult=np.zeros((len(labels),), bool),
        ))
    return Dataset(name=name, classes=classes, records=records)


def register_vg(data_root: Optional[str] = None) -> None:
    root = os.path.join(data_root or os.environ.get("SCDA_DATA_ROOT", "data"),
                        "genome")
    for split in ("train", "val", "test"):
        def factory(root=root, split=split):
            return load_vg_dataset(root, split, name=f"vg_{split}")
        register_dataset(f"vg_{split}", factory)


register_vg()

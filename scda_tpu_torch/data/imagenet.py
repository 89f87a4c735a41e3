"""ImageNet DET (ILSVRC) dataset adapter.

Rebuild of the reference's upstream ``imagenet`` imdb
(ref lib/datasets/imagenet.py ~250 LoC): VOC-style per-image XML
annotations whose ``<name>`` fields are WordNet synset ids (wnids,
e.g. ``n02084071``) rather than words.  Differences from the reference,
by design:

  * The reference resolves wnids through ``meta_det.mat`` via
    scipy.io.loadmat; this image has no devkit .mat files, so the synset
    map is read from a plain-text ``meta_det.txt`` (``wnid name`` per
    line, the standard text export) or supplied directly.
  * ILSVRC DET boxes are 0-based (unlike VOC's 1-based XML), so no
    -1 shift is applied (ref imagenet.py loads them unshifted too).
  * No pickled roidb cache — records are cheap immutable dataclasses.

Layout (the standard ILSVRC devkit tree):
  root/ImageSets/DET/{split}.txt          image ids (first column)
  root/Annotations/DET/{split}/{id}.xml   (id may contain subdirs)
  root/Data/DET/{split}/{id}.JPEG
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from scda_tpu_torch.data.voc import Dataset, ImageRecord, register_dataset


def load_synset_map(meta_file: str) -> Dict[str, str]:
    """Parse a ``wnid name`` text file (one synset per line; the name may
    contain spaces — everything after the first field).

    The returned dict preserves FILE LINE ORDER (insertion-ordered): the
    reference resolves class order from the devkit ``meta_det`` ordering
    (ref lib/datasets/imagenet.py:~40), so label indices must follow the
    file, not a sort, to stay compatible with reference checkpoints.
    """
    mapping: Dict[str, str] = {}
    with open(meta_file) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                mapping[parts[0]] = parts[1]
    return mapping


def _parse_ilsvrc_xml(
    xml_path: str, wnid_to_label: Dict[str, int]
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    tree = ET.parse(xml_path)
    size = tree.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)
    boxes, labels = [], []
    for obj in tree.findall("object"):
        wnid = obj.find("name").text.strip()
        if wnid not in wnid_to_label:
            continue
        bb = obj.find("bndbox")
        x1 = max(float(bb.find("xmin").text), 0.0)
        y1 = max(float(bb.find("ymin").text), 0.0)
        x2 = min(float(bb.find("xmax").text), width - 1)
        y2 = min(float(bb.find("ymax").text), height - 1)
        if x2 <= x1 or y2 <= y1:
            continue
        boxes.append([x1, y1, x2, y2])
        labels.append(wnid_to_label[wnid])
    if boxes:
        return (np.asarray(boxes, np.float32),
                np.asarray(labels, np.int32), (height, width))
    return (np.zeros((0, 4), np.float32),
            np.zeros((0,), np.int32), (height, width))


def load_imagenet_det_dataset(
    root: str,
    split: str = "train",
    wnids: Optional[Sequence[str]] = None,
    synset_map: Optional[Dict[str, str]] = None,
    name: str = "imagenet_det",
    keep_empty: bool = False,
    max_images: int = 0,
) -> Dataset:
    """Load an ILSVRC DET devkit tree into a :class:`Dataset`.

    Args:
      root: devkit root (contains ImageSets/, Annotations/, Data/).
      split: e.g. "train", "val".
      wnids: synset ids to keep, in label order (default: every wnid in
        ``synset_map`` / ``root/meta_det.txt`` in FILE ORDER — the
        reference's devkit meta_det ordering, which fixes label ids).
      synset_map: wnid -> human-readable class name (default: read from
        ``root/meta_det.txt`` if present; else names = wnids).

    Compatibility note (r3): the default ordering changed from
    ``sorted(wnids)`` to meta_det FILE order to match the reference's
    devkit label ids.  Checkpoints or cached artifacts produced under
    the old sorted ordering have silently permuted label ids — pass
    ``wnids=sorted(...)`` explicitly to reproduce them.
    """
    if synset_map is None:
        meta = os.path.join(root, "meta_det.txt")
        synset_map = load_synset_map(meta) if os.path.exists(meta) else {}
    if wnids is None:
        # Preserve meta_det line order (reference-compatible label ids);
        # dicts are insertion-ordered, and load_synset_map inserts in
        # file order.
        wnids = list(synset_map) if synset_map else None
        if wnids is None:
            raise ValueError(
                "need wnids or a synset map (root/meta_det.txt) to fix the "
                "class order")
    wnid_to_label = {w: i + 1 for i, w in enumerate(wnids)}
    classes = tuple(synset_map.get(w, w) for w in wnids)

    ids_file = os.path.join(root, "ImageSets", "DET", f"{split}.txt")
    with open(ids_file) as f:
        ids = [line.strip().split()[0] for line in f if line.strip()]
    if max_images:
        ids = ids[:max_images]

    records = []
    for image_id in ids:
        xml_path = os.path.join(root, "Annotations", "DET", split,
                                image_id + ".xml")
        img_path = os.path.join(root, "Data", "DET", split,
                                image_id + ".JPEG")
        if not os.path.exists(img_path):
            continue
        if os.path.exists(xml_path):
            boxes, labels, (h, w) = _parse_ilsvrc_xml(xml_path,
                                                      wnid_to_label)
        else:
            from PIL import Image

            with Image.open(img_path) as im:
                w, h = im.size
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
        if len(boxes) == 0 and not keep_empty:
            continue
        records.append(ImageRecord(
            image_id=image_id.replace("/", "_"), image_path=img_path,
            width=w, height=h, boxes=boxes, labels=labels,
            difficult=np.zeros((len(labels),), bool),
        ))
    return Dataset(name=name, classes=classes, records=records)


def register_imagenet(data_root: Optional[str] = None) -> None:
    """Register ``imagenet_det_{split}`` names if the devkit tree exists
    (ref factory.py registers imagenet splits unconditionally; here the
    factory itself raises a clear error when the tree is absent)."""
    root = os.path.join(data_root or os.environ.get("SCDA_DATA_ROOT", "data"),
                        "ILSVRC")
    for split in ("train", "val"):
        def factory(root=root, split=split):
            return load_imagenet_det_dataset(root, split,
                                             name=f"imagenet_det_{split}")
        register_dataset(f"imagenet_det_{split}", factory)


register_imagenet()

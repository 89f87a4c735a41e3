"""Synthetic VOC-style dataset generation.

The reference has no test fixtures at all (SURVEY.md §4); this module is
the rebuild's answer: deterministic scenes of colored rectangles on
textured backgrounds, written either in-memory (fast unit tests) or as a
real VOC directory tree on disk (exercises the XML parsing + pipeline
end-to-end, and gives the eval pipeline a rigged scene with known AP).

Classes are colors; a detector can genuinely learn them, so 2-step train
smoke tests see decreasing loss and overfit tests can reach high AP.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from scda_tpu_torch.data.voc import Dataset, ImageRecord

SYNTH_CLASSES = ("redbox", "greenbox", "bluebox", "yellowbox")
_COLORS = {
    "redbox": (220, 40, 30),
    "greenbox": (40, 200, 60),
    "bluebox": (40, 70, 220),
    "yellowbox": (230, 210, 40),
}


def _draw_scene(
    rng: np.random.RandomState,
    height: int,
    width: int,
    max_objects: int,
    classes: Tuple[str, ...],
    fog: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (rgb uint8 image, boxes (G,4) f32, labels (G,) i32)."""
    img = rng.randint(60, 120, (height, width, 3)).astype(np.float32)
    # Low-frequency texture so the background isn't trivially separable.
    yy = np.linspace(0, 4 * np.pi, height)[:, None]
    xx = np.linspace(0, 4 * np.pi, width)[None, :]
    img += 25 * np.sin(yy + rng.rand() * 6)[..., None]
    img += 25 * np.cos(xx + rng.rand() * 6)[..., None]

    n = rng.randint(1, max_objects + 1)
    boxes, labels = [], []
    for _ in range(n):
        w = rng.randint(max(12, width // 16), width // 3)
        h = rng.randint(max(12, height // 16), height // 3)
        x1 = rng.randint(0, width - w)
        y1 = rng.randint(0, height - h)
        cls = rng.randint(len(classes))
        # Unknown class names get a deterministic per-index color so the
        # generator works with arbitrary class lists (e.g. VOC names).
        fallback = [(220, 40, 30), (40, 200, 60), (40, 70, 220),
                    (230, 210, 40), (200, 80, 220), (50, 210, 210)]
        color = np.asarray(
            _COLORS.get(classes[cls], fallback[cls % len(fallback)]),
            np.float32,
        )
        jitter = rng.randn(3) * 10
        img[y1 : y1 + h, x1 : x1 + w] = color + jitter
        # Border to give edges.
        img[y1 : y1 + 2, x1 : x1 + w] = 10
        img[y1 + h - 2 : y1 + h, x1 : x1 + w] = 10
        boxes.append([x1, y1, x1 + w - 1, y1 + h - 1])
        labels.append(cls + 1)

    if fog > 0:
        img = (1 - fog) * img + fog * 200.0

    img = np.clip(img, 0, 255).astype(np.uint8)
    return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


def make_synthetic_dataset(
    root: str,
    num_images: int = 8,
    image_size: Tuple[int, int] = (256, 384),
    max_objects: int = 4,
    classes: Tuple[str, ...] = SYNTH_CLASSES,
    seed: int = 0,
    split: str = "train",
    fog: float = 0.0,
    name: str = "synthetic",
) -> Dataset:
    """Write a VOC-layout synthetic dataset to ``root`` and load it back
    through the real parsing path."""
    from PIL import Image

    from scda_tpu_torch.data.voc import load_voc_dataset

    rng = np.random.RandomState(seed)
    h, w = image_size
    os.makedirs(os.path.join(root, "ImageSets", "Main"), exist_ok=True)
    os.makedirs(os.path.join(root, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "JPEGImages"), exist_ok=True)

    ids = []
    for i in range(num_images):
        image_id = f"{split}_{i:06d}"
        ids.append(image_id)
        img, boxes, labels = _draw_scene(rng, h, w, max_objects, classes, fog)
        Image.fromarray(img).save(
            os.path.join(root, "JPEGImages", image_id + ".png")
        )
        write_voc_xml(
            os.path.join(root, "Annotations", image_id + ".xml"),
            image_id + ".png", w, h, boxes, labels, classes,
        )
    with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")

    return load_voc_dataset(root, split, classes, name=name)


def write_voc_xml(path, filename, width, height, boxes, labels, classes,
                  difficult=None):
    """The repo's single VOC-XML writer (fixture generator AND the
    raw->VOC converter in scripts/convert_to_voc.py use it)."""
    lines = [
        "<annotation>",
        f"  <filename>{filename}</filename>",
        "  <size>",
        f"    <width>{width}</width>",
        f"    <height>{height}</height>",
        "    <depth>3</depth>",
        "  </size>",
    ]
    if difficult is None:
        difficult = np.zeros((len(labels),), bool)
    for box, label, diff in zip(boxes, labels, difficult):
        x1, y1, x2, y2 = box
        lines += [
            "  <object>",
            f"    <name>{classes[int(label) - 1]}</name>",
            f"    <difficult>{int(bool(diff))}</difficult>",
            "    <bndbox>",
            # VOC stores 1-based pixel coords (the parser subtracts 1).
            f"      <xmin>{int(round(float(x1))) + 1}</xmin>",
            f"      <ymin>{int(round(float(y1))) + 1}</ymin>",
            f"      <xmax>{int(round(float(x2))) + 1}</xmax>",
            f"      <ymax>{int(round(float(y2))) + 1}</ymax>",
            "    </bndbox>",
            "  </object>",
        ]
    lines.append("</annotation>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def make_memory_dataset(
    num_images: int = 4,
    image_size: Tuple[int, int] = (256, 384),
    max_objects: int = 4,
    classes: Tuple[str, ...] = SYNTH_CLASSES,
    seed: int = 0,
    fog: float = 0.0,
    tmpdir: Optional[str] = None,
    name: str = "synthetic_mem",
) -> Dataset:
    """In-memory-ish variant: images still need a path for the loader, so
    they are written to ``tmpdir`` (or a tempdir) as PNGs without the VOC
    XML machinery."""
    import tempfile

    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = image_size
    root = tmpdir or tempfile.mkdtemp(prefix="scda_synth_")
    os.makedirs(root, exist_ok=True)

    records: List[ImageRecord] = []
    for i in range(num_images):
        img, boxes, labels = _draw_scene(rng, h, w, max_objects, classes, fog)
        path = os.path.join(root, f"img_{seed}_{i:04d}.png")
        Image.fromarray(img).save(path)
        records.append(
            ImageRecord(
                image_id=f"im{i}",
                image_path=path,
                width=w,
                height=h,
                boxes=boxes,
                labels=labels,
                difficult=np.zeros((len(labels),), bool),
            )
        )
    return Dataset(name=name, classes=tuple(classes), records=records)

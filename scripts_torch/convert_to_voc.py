"""Materialise VOC-XML trees from raw Cityscapes/Foggy/KITTI downloads.

The reference consumes VOC conversions (``CityscapesVOC/`` etc. —
lib/datasets/cityscape.py lineage); this script produces exactly those
trees from the original distributions, using the same parsers the raw
adapters use (scda_tpu_torch/data/cityscapes.py), so either path yields
identical ground truth.  Images are symlinked, not copied.  The trees
are byte-for-byte those of scripts/convert_to_voc.py.  Host only: it
runs on no device.

Usage:
  python scripts_torch/convert_to_voc.py cityscapes --root /data/Cityscapes \
      --out $SCDA_DATA_ROOT/CityscapesVOC
  python scripts_torch/convert_to_voc.py foggy --root /data/Cityscapes \
      --beta 0.02 --out $SCDA_DATA_ROOT/FoggyCityscapesVOC
  python scripts_torch/convert_to_voc.py kitti --root /data/KITTI \
      --out $SCDA_DATA_ROOT/KITTIVOC
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scda_tpu_torch.data.synthetic import write_voc_xml  # noqa: E402
from scda_tpu_torch.data.voc import Dataset  # noqa: E402


def _refresh_symlink(link: str, target: str) -> None:
    """Point ``link`` at ``target``, replacing a stale/broken link (e.g.
    after re-running the converter with a moved --root)."""
    if os.path.lexists(link):
        if (os.path.islink(link)
                and os.path.realpath(link) == os.path.realpath(target)):
            return
        os.remove(link)
    os.symlink(target, link)


def write_voc_tree(ds: Dataset, out: str, split: str) -> None:
    os.makedirs(os.path.join(out, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(out, "JPEGImages"), exist_ok=True)
    os.makedirs(os.path.join(out, "ImageSets", "Main"), exist_ok=True)
    ids = []
    for rec in ds.records:
        ids.append(rec.image_id)
        ext = os.path.splitext(rec.image_path)[1]
        link = os.path.join(out, "JPEGImages", rec.image_id + ext)
        _refresh_symlink(link, os.path.abspath(rec.image_path))
        write_voc_xml(
            os.path.join(out, "Annotations", rec.image_id + ".xml"),
            rec.image_id + ext, rec.width, rec.height,
            rec.boxes, rec.labels, ds.classes, rec.difficult,
        )
    with open(os.path.join(out, "ImageSets", "Main",
                           f"{split}.txt"), "w") as f:
        f.write("\n".join(ids) + ("\n" if ids else ""))
    print(f"{split}: {len(ids)} images -> {out}")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["cityscapes", "foggy", "kitti"])
    p.add_argument("--root", required=True,
                   help="raw dataset root (Cityscapes: contains "
                        "leftImg8bit[_foggy]/ + gtFine/; KITTI: "
                        "contains training/)")
    p.add_argument("--out", required=True, help="VOC tree to write")
    p.add_argument("--beta", type=float, default=0.02,
                   help="foggy beta level (paper: 0.02)")
    p.add_argument("--splits", nargs="*", default=None)
    p.add_argument("--keep_empty", action="store_true")
    args = p.parse_args()

    from scda_tpu_torch.data.cityscapes import (
        load_cityscapes_dataset, load_kitti_dataset,
    )

    if args.dataset == "kitti":
        # KITTI's labeled data lives in training/; `testing` has no
        # label_2 and converts to an image-only (target-style) tree.
        for split in args.splits or ["training"]:
            ds = load_kitti_dataset(args.root, split,
                                    keep_empty=args.keep_empty)
            out_split = "train" if split == "training" else split
            write_voc_tree(ds, args.out, out_split)
        return 0

    splits = args.splits or ["train", "val"]
    for split in splits:
        if args.dataset == "foggy":
            ds = load_cityscapes_dataset(
                args.root, split, foggy_beta=args.beta,
                keep_empty=True)
        else:
            # Non-train splits always keep empty/difficult-only images:
            # the materialized tree feeds evaluation, and a dropped val
            # image can never charge false positives (the registry's
            # keep_empty=True at load time cannot resurrect records
            # missing from disk).
            keep = args.keep_empty or split != "train"
            ds = load_cityscapes_dataset(args.root, split,
                                         keep_empty=keep)
        write_voc_tree(ds, args.out, split)
    return 0


if __name__ == "__main__":
    sys.exit(main())

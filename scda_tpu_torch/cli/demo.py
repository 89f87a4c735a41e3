"""Demo CLI of the PyTorch port (port of ``scda_tpu/cli/demo.py``): detect
objects in every image of a folder and save ``<name>_det.png`` overlays
beside the inputs (or under ``--out_dir``).

    python -m scda_tpu_torch.cli.demo --image_dir images/ --net vgg16 \
        --load_dir models --checkpoint_dataset synthetic

The weights are the newest ``ckpt_*.pth`` under
``<load_dir>/<net>/<checkpoint_dataset>``, with the architecture and the
class list that ``trainval`` recorded beside it in ``config.json``, as
``test_net --load_dir`` reads them (``--classes`` and ``--set`` still
win); without a checkpoint the weights are random.  ``--device cpu``
runs the plain-PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from scda_tpu_torch.cli.test_net import _NET_TO_BACKBONE, _NET_TO_PRESET


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Detection demo (PyTorch)")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--net", default="vgg16", choices=sorted(_NET_TO_BACKBONE))
    p.add_argument("--load_dir", default="models")
    p.add_argument("--checkpoint_dataset", default="synthetic")
    p.add_argument("--classes", nargs="*", default=None,
                   help="fg class names (default: the checkpoint's, else "
                        "cityscapes 8)")
    p.add_argument("--thresh", type=float, default=0.5)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' with no GPU is an error")
    return p.parse_args(argv)


_PALETTE = [
    (255, 60, 60), (60, 200, 80), (70, 110, 255), (240, 200, 40),
    (200, 80, 220), (50, 210, 210), (250, 140, 40), (150, 150, 150),
]


def draw_detections(img_rgb: np.ndarray, boxes, scores, classes, names,
                    thresh: float):
    """PIL overlay (ref vis_detections, net_utils.py:~120)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(img_rgb.astype(np.uint8))
    dr = ImageDraw.Draw(im)
    for box, score, cls in zip(boxes, scores, classes):
        if score < thresh:
            continue
        color = _PALETTE[(int(cls) - 1) % len(_PALETTE)]
        x1, y1, x2, y2 = [float(v) for v in box]
        dr.rectangle([x1, y1, x2, y2], outline=color, width=2)
        label = f"{names[int(cls) - 1]} {score:.2f}"
        dr.text((x1 + 2, max(y1 - 12, 0)), label, fill=color)
    return np.asarray(im)


def detect(step, img_bgr: np.ndarray, cfg, device):
    """One BGR image through the host prep and the eval ``step``: numpy
    (boxes, scores, classes) of its valid detections, in original image
    coordinates."""
    import torch

    from scda_tpu_torch.data.pipeline import prepare_image

    canvas, scale, (vh, vw) = prepare_image(img_bgr, cfg.data)
    im_info = torch.tensor([[vh, vw, scale]], dtype=torch.float32)
    dets = step(torch.from_numpy(canvas[None]).to(device), im_info.to(device))
    v = dets.valid[0].cpu().numpy()
    return tuple(t[0].cpu().numpy()[v] for t in
                 (dets.boxes, dets.scores, dets.classes))


def main(argv=None) -> int:
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    args = parse_args(argv)

    import torch

    from scda_tpu_torch.config import (
        PRESETS, _merge_into, apply_overrides, parse_set_list, replace_path,
    )
    from scda_tpu_torch.data.voc import CITYSCAPES_CLASSES

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device cpu "
              "for the plain-PyTorch path)", file=sys.stderr)
        return 2

    cfg = PRESETS[_NET_TO_PRESET[args.net]]()
    cfg = replace_path(cfg, "model.backbone", _NET_TO_BACKBONE[args.net])
    run_dir = os.path.join(args.load_dir, args.net, args.checkpoint_dataset)
    cfg_json = os.path.join(run_dir, "config.json")
    trained_classes = None
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            meta = json.load(f)
        trained_classes = meta.get("classes")
        cfg = _merge_into(cfg, {"model": meta["config"].get("model", {}),
                                "anchors": meta["config"].get("anchors", {})})
        print(f"architecture from {cfg_json}")
    classes = tuple(args.classes or trained_classes or CITYSCAPES_CLASSES)
    cfg = replace_path(cfg, "model.num_classes", len(classes) + 1)
    overrides = parse_set_list(args.set_cfgs)
    if overrides:
        cfg = apply_overrides(cfg, overrides)

    from PIL import Image

    from scda_tpu_torch.data.pipeline import load_image
    from scda_tpu_torch.models.faster_rcnn import empty_model, init_params
    from scda_tpu_torch.train import checkpoint as ckpt
    from scda_tpu_torch.train.steps import make_eval_step

    model = empty_model(cfg.model, cfg.anchors.num_anchors, device=device)
    if ckpt.latest_step(run_dir) is not None:
        payload = ckpt.load_payload(run_dir)
        model.load_state_dict(payload["model"])
        print(f"loaded checkpoint step {payload['step']} from {run_dir}")
    else:
        init_params(model, torch.Generator().manual_seed(0))
        print(f"WARNING: no checkpoint under {run_dir}; random weights",
              file=sys.stderr)
    step = make_eval_step(model, cfg)

    exts = (".jpg", ".jpeg", ".png", ".bmp")
    files = sorted(f for f in os.listdir(args.image_dir)
                   if f.lower().endswith(exts) and not f.endswith("_det.png"))
    if not files:
        print(f"no images in {args.image_dir}", file=sys.stderr)
        return 1
    out_dir = args.out_dir or args.image_dir
    os.makedirs(out_dir, exist_ok=True)

    class _Rec:
        pass

    for fname in files:
        rec = _Rec()
        rec.image_path = os.path.join(args.image_dir, fname)
        img_bgr = load_image(rec)
        boxes, scores, cls_ids = detect(step, img_bgr, cfg, device)
        rgb = img_bgr[:, :, ::-1] if img_bgr.ndim == 3 else img_bgr
        out = draw_detections(rgb, boxes, scores, cls_ids, classes,
                              args.thresh)
        out_path = os.path.join(out_dir,
                                os.path.splitext(fname)[0] + "_det.png")
        Image.fromarray(out).save(out_path)
        n = int((scores >= args.thresh).sum())
        print(f"{fname}: {n} detections >= {args.thresh} -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

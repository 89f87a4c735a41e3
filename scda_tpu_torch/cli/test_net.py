"""Evaluation CLI of the PyTorch port (port of ``scda_tpu/cli/test_net.py``):
build the detector, load its weights, run inference over a dataset,
report VOC AP@0.5 per class and mAP.

    python -m scda_tpu_torch.cli.test_net --net vgg16 --dataset synthetic \
        --load_dir models
    python -m scda_tpu_torch.cli.test_net --net vgg16 --dataset synthetic \
        --torch_checkpoint reference.pth --set model.pooling_mode align_legacy

The weights come from ``--load_dir``: the newest (or ``--checkpoint_step``)
``ckpt_*.pth`` under ``<load_dir>/<net>/<checkpoint_dataset>``, with the
architecture and class list that ``trainval`` recorded beside it in
``config.json`` (source-only and SCDA runs alike; ``--set`` still
overrides); or from ``--torch_checkpoint``, a reference-layout ``.pth``
given by path, which configures nothing.

Not ported yet: Orbax checkpoints of the JAX trainer, device meshes and
``--vis`` overlays.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# As the JAX CLI's (scda_tpu/cli/trainval.py), which imports jax.
_NET_TO_PRESET = {"vgg16": "vgg16", "res50": "res50", "res101": "res101",
                  "res152": "res152", "tiny": "vgg16"}
_NET_TO_BACKBONE = {"vgg16": "vgg16", "res50": "resnet50",
                    "res101": "resnet101", "res152": "resnet152",
                    "tiny": "tiny"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate Faster R-CNN (PyTorch)")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--net", default="vgg16", choices=sorted(_NET_TO_BACKBONE))
    p.add_argument("--load_dir", default="models",
                   help="checkpoint root (save_dir of trainval)")
    p.add_argument("--checkpoint_dataset", default=None,
                   help="dataset name used at train time (defaults to "
                        "--dataset)")
    p.add_argument("--checkpoint_step", type=int, default=None,
                   help="step to load (default: the newest; 0 is a step)")
    p.add_argument("--torch_checkpoint", default=None, metavar="PTH",
                   help="reference-layout detector state dict to evaluate "
                        "(loaded with weights_only=True). Pair with --set "
                        "model.pooling_mode align_legacy for the reference "
                        "RoIAlign semantics")
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--dets_out", default=None,
                   help="write detections JSON here")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' with no GPU is an error")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--synth_images", type=int, default=8)
    p.add_argument("--synth_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--synth_fog", type=float, default=0.0,
                   help="fog level of the synthetic val set")
    p.add_argument("--synth_classes", default=None,
                   help="comma-separated class list for the synthetic "
                        "fixture (must match training)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from scda_tpu_torch.config import (
        PRESETS, _merge_into, apply_overrides, parse_set_list, replace_path,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device cpu "
              "for the plain-PyTorch path)", file=sys.stderr)
        return 2

    cfg = PRESETS[_NET_TO_PRESET[args.net]]()
    cfg = replace_path(cfg, "model.backbone", _NET_TO_BACKBONE[args.net])

    # The architecture and class list recorded at train time (trainval
    # writes config.json beside the checkpoints); --set still wins.
    run_dir = os.path.join(args.load_dir, args.net,
                           args.checkpoint_dataset or args.dataset)
    state_kind, trained_classes = None, None
    cfg_json = os.path.join(run_dir, "config.json")
    if not args.torch_checkpoint and os.path.exists(cfg_json):
        with open(cfg_json) as f:
            meta = json.load(f)
        state_kind = meta.get("state_kind")
        trained_classes = meta.get("classes")
        cfg = _merge_into(cfg, {"model": meta["config"].get("model", {}),
                                "anchors": meta["config"].get("anchors", {})})
        print(f"architecture from {cfg_json}")
    if args.synth_size:
        cfg = replace_path(cfg, "data.image_size", tuple(args.synth_size))
    overrides = parse_set_list(args.set_cfgs)
    if overrides:
        cfg = apply_overrides(cfg, overrides)

    if args.dataset == "synthetic":
        import tempfile

        from scda_tpu_torch.data.synthetic import (
            SYNTH_CLASSES, make_synthetic_dataset,
        )

        synth_kw = {}
        suffix = f"_fog{args.synth_fog}" if args.synth_fog else ""
        classes = None
        if args.synth_classes:
            classes = tuple(c.strip() for c in args.synth_classes.split(",")
                            if c.strip())
        elif trained_classes and tuple(trained_classes) != SYNTH_CLASSES:
            classes = tuple(trained_classes)   # the fixture follows training
        if classes:
            synth_kw = {"classes": classes}
            suffix += f"_c{len(classes)}"
        dataset = make_synthetic_dataset(
            os.path.join(tempfile.gettempdir(), f"scda_synth_val{suffix}"),
            num_images=args.synth_images, image_size=cfg.data.image_size,
            seed=100, split="val", fog=args.synth_fog, **synth_kw,
        )
    else:
        from scda_tpu_torch.data.voc import get_dataset

        dataset = get_dataset(args.dataset)

    cfg = replace_path(cfg, "model.num_classes", dataset.num_classes)
    if (cfg.data.auto_canvas and not args.synth_size
            and args.dataset != "synthetic"):
        from scda_tpu_torch.data.pipeline import infer_canvas

        canvas = infer_canvas(dataset.records, cfg.data)
        if canvas != tuple(cfg.data.image_size):
            print(f"canvas {tuple(cfg.data.image_size)} -> {canvas} "
                  f"(from record stats)")
            cfg = replace_path(cfg, "data.image_size", canvas)

    from scda_tpu_torch.evals.voc_eval import evaluate_detections
    from scda_tpu_torch.bridge import load_reference_checkpoint
    from scda_tpu_torch.evals.detect import run_inference
    from scda_tpu_torch.models.faster_rcnn import build_model
    from scda_tpu_torch.train import checkpoint as ckpt

    model = build_model(cfg.model, cfg.anchors.num_anchors,
                        generator=torch.Generator().manual_seed(0),
                        device=device)
    if args.torch_checkpoint:
        payload = load_reference_checkpoint(model, args.torch_checkpoint)
        print(f"loaded torch checkpoint {args.torch_checkpoint}")
        if (not ckpt.is_port_checkpoint(payload)
                and cfg.model.pooling_mode != "align_legacy"):
            print("note: reference checkpoints were trained with the legacy "
                  "RoIAlign; consider --set model.pooling_mode align_legacy",
                  file=sys.stderr)
    elif ckpt.latest_step(run_dir) is not None:
        if trained_classes and len(trained_classes) != len(dataset.classes):
            print(f"{run_dir} was trained on {len(trained_classes)} classes; "
                  f"--dataset {args.dataset} has {len(dataset.classes)}",
                  file=sys.stderr)
            return 2
        payload = ckpt.load_payload(run_dir, args.checkpoint_step)
        model.load_state_dict(payload["model"])
        kind = "SCDA checkpoint" if state_kind == "scda" else "checkpoint"
        print(f"loaded {kind} step {payload['step']} from {run_dir}")
    else:
        print(f"WARNING: no checkpoint under {run_dir}; evaluating random "
              "init", file=sys.stderr)

    all_dets, ips = run_inference(model, dataset, cfg, device=device,
                                  batch_size=args.bs, progress=True)
    results = evaluate_detections(dataset, all_dets)
    results["images_per_sec"] = ips
    print(json.dumps({"eval": {k: round(float(v), 4)
                               for k, v in results.items()},
                      "device": str(device)}))
    for cls in dataset.classes:
        print(f"AP@0.5 {cls:16s} = {results[cls]:.4f}")
    print(f"mAP@0.5 = {results['mAP']:.4f}  "
          f"({results['images_per_sec']:.2f} img/s on {device})")

    if args.dets_out:
        payload = {
            cls: [[img, [float(x) for x in box], float(s)]
                  for img, box, s in dets]
            for cls, dets in all_dets.items()
        }
        with open(args.dets_out, "w") as f:
            json.dump(payload, f)
        print(f"detections -> {args.dets_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

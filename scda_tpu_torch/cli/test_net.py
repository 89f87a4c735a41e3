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

Beyond VOC AP@0.5 (``--use_07_metric``: the 11-point AP): ``--iou_sweep``
adds mAP@[.5:.95], ``--coco_protocol`` the 12-number COCO summary,
``--vis DIR`` detection overlays of the first ``--vis_count`` images.
``--num_devices N`` evaluates on N devices, one process each, started
here (``parallel.mesh.spawn``): each runs its rows of every batch
(``--bs`` is the global batch and must divide by N) and rank 0 gathers
and scores the detections.  0 means every visible GPU, and 1 on the CPU.

Not ported: Orbax checkpoints of the JAX trainer (the port writes its
own ``.pth``; ``--torch_checkpoint`` reads reference-layout files).
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
    p.add_argument("--allow_unsafe_pickle", action="store_true",
                   help="permit full-pickle torch.load for legacy .pth "
                        "files that fail weights_only=True (runs arbitrary "
                        "code from the file: only for checkpoints you trust)")
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--use_07_metric", action="store_true")
    p.add_argument("--iou_sweep", action="store_true",
                   help="also report COCO-style mAP@[.5:.95]")
    p.add_argument("--coco_protocol", action="store_true",
                   help="also report the 12-number COCO summary (area "
                        "ranges, maxDets 1/10/100)")
    p.add_argument("--dets_out", default=None,
                   help="write detections JSON here")
    p.add_argument("--vis", default=None, metavar="DIR",
                   help="write detection overlays for the first images")
    p.add_argument("--vis_count", type=int, default=8)
    p.add_argument("--vis_thresh", type=float, default=0.3)
    p.add_argument("--num_devices", type=int, default=0,
                   help="devices for sharded eval (0 = every visible GPU; "
                        "1 on the CPU); --bs must divide by it")
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

    from scda_tpu_torch.parallel.mesh import num_devices, spawn
    from scda_tpu_torch.train.checkpoint import latest_step

    n_dev = num_devices(args.num_devices, device)
    if args.bs % n_dev:
        print(f"--bs {args.bs} not divisible by {n_dev} devices",
              file=sys.stderr)
        return 2
    if (trained_classes and len(trained_classes) != len(dataset.classes)
            and latest_step(run_dir) is not None):
        print(f"{run_dir} was trained on {len(trained_classes)} classes; "
              f"--dataset {args.dataset} has {len(dataset.classes)}",
              file=sys.stderr)
        return 2
    run = (args, cfg, dataset, run_dir, state_kind)
    if n_dev > 1:
        print(f"eval on {n_dev} devices")
        return spawn(_evaluate_rank, n_dev, device, *run,
                     threads=max(torch.get_num_threads() // n_dev, 1))
    return _evaluate(None, device, *run)


def _evaluate_rank(world, device, *run) -> int:
    """One rank of a sharded evaluation; only rank 0 prints."""
    import contextlib

    if world.is_main:
        return _evaluate(world, device, *run)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        return _evaluate(world, device, *run)


def _evaluate(world, device, args, cfg, dataset, run_dir, state_kind) -> int:
    """Build and load the detector on ``device``, run inference over
    ``dataset`` (this rank's rows with a ``world``) and, on rank 0, score
    and report."""
    import torch

    from scda_tpu_torch.bridge import load_reference_checkpoint
    from scda_tpu_torch.evals.detect import run_inference
    from scda_tpu_torch.evals.voc_eval import evaluate_detections
    from scda_tpu_torch.models.faster_rcnn import build_model
    from scda_tpu_torch.train import checkpoint as ckpt

    model = build_model(cfg.model, cfg.anchors.num_anchors,
                        generator=torch.Generator().manual_seed(0),
                        device=device)
    if args.torch_checkpoint:
        payload = load_reference_checkpoint(
            model, args.torch_checkpoint,
            allow_unsafe_pickle=args.allow_unsafe_pickle)
        print(f"loaded torch checkpoint {args.torch_checkpoint}")
        if (not ckpt.is_port_checkpoint(payload)
                and cfg.model.pooling_mode != "align_legacy"):
            print("note: reference checkpoints were trained with the legacy "
                  "RoIAlign; consider --set model.pooling_mode align_legacy",
                  file=sys.stderr)
    elif ckpt.latest_step(run_dir) is not None:
        payload = ckpt.load_payload(run_dir, args.checkpoint_step)
        model.load_state_dict(payload["model"])
        kind = "SCDA checkpoint" if state_kind == "scda" else "checkpoint"
        print(f"loaded {kind} step {payload['step']} from {run_dir}")
    elif world is None or world.is_main:
        print(f"WARNING: no checkpoint under {run_dir}; evaluating random "
              "init", file=sys.stderr)

    all_dets, ips = run_inference(model, dataset, cfg, device=device,
                                  batch_size=args.bs, progress=True,
                                  world=world)
    if all_dets is None:       # a rank other than 0: rank 0 reports
        return 0
    results = evaluate_detections(dataset, all_dets,
                                  use_07_metric=args.use_07_metric)
    results["images_per_sec"] = ips
    print(json.dumps({"eval": {k: round(float(v), 4)
                               for k, v in results.items()},
                      "device": str(device),
                      "devices": 1 if world is None else world.size}))
    for cls in dataset.classes:
        print(f"AP@0.5 {cls:16s} = {results[cls]:.4f}")
    print(f"mAP@0.5 = {results['mAP']:.4f}  "
          f"({results['images_per_sec']:.2f} img/s on {device})")

    if args.iou_sweep:
        from scda_tpu_torch.evals.voc_eval import evaluate_detections_iou_sweep

        sweep = evaluate_detections_iou_sweep(dataset, all_dets)
        print(json.dumps({"iou_sweep": {k: round(float(v), 4)
                                        for k, v in sweep.items()}}))
        print(f"mAP@[.5:.95] = {sweep['mAP@[.5:.95]']:.4f}  "
              f"(mAP@0.75 = {sweep['mAP@0.75']:.4f})")

    if args.coco_protocol:
        from scda_tpu_torch.evals.coco_protocol import evaluate_coco_protocol

        coco = evaluate_coco_protocol(dataset, all_dets)
        print(json.dumps({"coco": {k: round(float(v), 4)
                                   for k, v in coco.items()}}))
        print(f"COCO AP={coco['AP']:.4f} AP50={coco['AP50']:.4f} "
              f"AP75={coco['AP75']:.4f} "
              f"APs/m/l={coco['AP_small']:.3f}/"
              f"{coco['AP_medium']:.3f}/{coco['AP_large']:.3f} "
              f"AR@1/10/100={coco['AR@1']:.3f}/{coco['AR@10']:.3f}/"
              f"{coco['AR@100']:.3f}")

    if args.vis:
        write_overlays(dataset, all_dets, args.vis, args.vis_count,
                       args.vis_thresh)
        print(f"overlays -> {args.vis}")

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


def write_overlays(dataset, all_dets, out_dir: str, count: int,
                   thresh: float) -> None:
    """``<image_id>_det.png`` overlays of the first ``count`` records'
    detections (scores >= ``thresh``) in ``out_dir``."""
    from PIL import Image

    from scda_tpu_torch.cli.demo import draw_detections
    from scda_tpu_torch.data.pipeline import load_image

    os.makedirs(out_dir, exist_ok=True)
    by_image = {}
    for cls, dets in all_dets.items():
        ci = dataset.classes.index(cls) + 1
        for img_id, box, score in dets:
            by_image.setdefault(img_id, []).append((box, score, ci))
    for rec in dataset.records[:count]:
        dets = by_image.get(rec.image_id, [])
        rgb = load_image(rec)[:, :, ::-1]
        out = draw_detections(rgb, [d[0] for d in dets], [d[1] for d in dets],
                              [d[2] for d in dets], dataset.classes, thresh)
        Image.fromarray(out).save(
            os.path.join(out_dir, f"{rec.image_id}_det.png"))


if __name__ == "__main__":
    sys.exit(main())

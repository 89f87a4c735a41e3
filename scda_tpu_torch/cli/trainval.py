"""Training CLI of the PyTorch port: the source-only path of
``scda_tpu/cli/trainval.py``.  Builds the detector, trains it with the
supervised step (:mod:`scda_tpu_torch.train.steps`) on a dataset, logs
metrics and writes checkpoints that ``cli/test_net.py --torch_checkpoint``
evaluates.

    python -m scda_tpu_torch.cli.trainval --net vgg16 --dataset synthetic \
        --steps 100 --bs 1
    python -m scda_tpu_torch.cli.trainval --net res101 \
        --cfg_file cfgs/res101_ms.yml --dataset synthetic --steps 100

Flags follow the JAX CLI.  Where that CLI turns ``model.stem_pallas`` off
for ``vgg16`` with ``train.freeze_pretrained_layers=false``, this one
leaves the decision to ``train.steps.check_train_config``, which refuses
the config (on the CPU, ``--set model.stem_pallas=false`` trains conv1 and
conv2).  Not ported yet: SCDA adaptation (``--adapt``,
ROADMAP.md item 10) and training on more than one device
(``--num_devices``, item 12); both exit with code 2.  ``--profile DIR``
writes a ``torch.profiler`` trace of steps 3-8.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

from scda_tpu_torch.cli.test_net import _NET_TO_BACKBONE, _NET_TO_PRESET


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train Faster R-CNN, source only (PyTorch)")
    p.add_argument("--dataset", default="synthetic",
                   help="registered dataset name, or 'synthetic'")
    p.add_argument("--net", default="vgg16", choices=sorted(_NET_TO_BACKBONE))
    p.add_argument("--adapt", action="store_true",
                   help="SCDA adaptation: not ported yet (exits 2)")
    p.add_argument("--bs", type=int, default=1, help="images per step")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr_decay_step", type=int, default=None)
    p.add_argument("--steps", type=int, default=0,
                   help="cap total steps (0 = epochs * len(loader))")
    p.add_argument("--disp_interval", type=int, default=None)
    p.add_argument("--save_dir", default="models")
    p.add_argument("--checkpoint_interval", type=int, default=0,
                   help="steps between checkpoints (0 = per epoch)")
    p.add_argument("--r", dest="resume", action="store_true",
                   help="resume from the latest checkpoint in save_dir")
    p.add_argument("--torch_detector", default=None, metavar="PTH",
                   help="initialise the whole detector from a "
                        "reference-layout .pth (weights_only=True)")
    p.add_argument("--num_devices", type=int, default=0,
                   help="devices to train on; only 1 is ported (0 = 1)")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--cfg_file", default=None,
                   help="YAML config overlay")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of steps 3-8 to DIR")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[],
                   help="config overrides: dotted.path value ...")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' with no GPU is an error")
    p.add_argument("--synth_images", type=int, default=16)
    p.add_argument("--synth_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--synth_classes", default=None,
                   help="comma-separated class list for the synthetic "
                        "fixture")
    return p.parse_args(argv)


def build_config(args):
    """The JAX CLI's config: preset, YAML, flags, ``--set`` overrides."""
    from scda_tpu.config import (
        PRESETS, apply_overrides, config_from_yaml, parse_set_list,
        replace_path,
    )

    cfg = PRESETS[_NET_TO_PRESET[args.net]]()
    cfg = replace_path(cfg, "model.backbone", _NET_TO_BACKBONE[args.net])
    if args.cfg_file:
        cfg = config_from_yaml(args.cfg_file, base=cfg)
        args.adapt = args.adapt or cfg.adapt.enabled
    for flag, path in (("lr", "train.learning_rate"),
                       ("epochs", "train.max_epochs"),
                       ("lr_decay_step", "train.lr_decay_step"),
                       ("disp_interval", "train.disp_interval")):
        if getattr(args, flag) is not None:
            cfg = replace_path(cfg, path, getattr(args, flag))
    cfg = replace_path(cfg, "train.batch_size", args.bs)
    cfg = replace_path(cfg, "train.seed", args.seed)
    if args.synth_size:
        cfg = replace_path(cfg, "data.image_size", tuple(args.synth_size))
    overrides = parse_set_list(args.set_cfgs)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def get_dataset(args, cfg):
    if args.dataset != "synthetic":
        from scda_tpu.data.voc import get_dataset as registered

        return registered(args.dataset)
    from scda_tpu.data.synthetic import make_synthetic_dataset

    kw, suffix = {}, ""
    if args.synth_classes:
        kw["classes"] = tuple(c.strip() for c in args.synth_classes.split(",")
                              if c.strip())
        suffix = f"_c{len(kw['classes'])}"
    return make_synthetic_dataset(
        os.path.join(tempfile.gettempdir(), f"scda_synth_train{suffix}"),
        num_images=args.synth_images, image_size=cfg.data.image_size,
        seed=0, split="train", **kw)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = build_config(args)
    if args.adapt:
        print("--adapt: SCDA adaptation is not ported to PyTorch yet "
              "(ROADMAP.md item 10)", file=sys.stderr)
        return 2
    if args.num_devices > 1:
        print("--num_devices > 1: multi-device training is not ported to "
              "PyTorch yet (ROADMAP.md item 12)", file=sys.stderr)
        return 2

    import torch

    from scda_tpu.config import replace_path

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device cpu "
              "for the plain-PyTorch path)", file=sys.stderr)
        return 2

    from scda_tpu.data.pipeline import DataLoader
    from scda_tpu.utils.logging import MetricsLogger
    from scda_tpu_torch.bridge import load_reference_checkpoint
    from scda_tpu_torch.models.faster_rcnn import build_model, init_weights
    from scda_tpu_torch.train import checkpoint as ckpt
    from scda_tpu_torch.train.state import create_train_state
    from scda_tpu_torch.train.steps import check_train_config, make_train_step

    check_train_config(cfg, device)
    dataset = get_dataset(args, cfg)
    cfg = replace_path(cfg, "model.num_classes", dataset.num_classes)
    if (cfg.data.auto_canvas and not args.synth_size
            and args.dataset != "synthetic"):
        from scda_tpu.data.pipeline import infer_canvas

        canvas = infer_canvas(dataset.records, cfg.data)
        if canvas != tuple(cfg.data.image_size):
            print(f"canvas {tuple(cfg.data.image_size)} -> {canvas} "
                  f"(from record stats)")
            cfg = replace_path(cfg, "data.image_size", canvas)
    print(f"dataset={dataset.name} ({len(dataset)} images, "
          f"{dataset.num_classes - 1} fg classes), net={args.net}, "
          f"device={device}")

    # Seeded init with the first conv scaled to mean-subtracted 0-255
    # pixels, unless a whole detector is loaded.
    model = build_model(cfg.model, cfg.anchors.num_anchors, device="cpu")
    init_weights(model, torch.Generator().manual_seed(cfg.train.seed),
                 input_scale=1.0 / 64)
    if args.torch_detector:
        load_reference_checkpoint(model, args.torch_detector)
        print(f"initialised the detector from {args.torch_detector}")
    model = model.to(device)

    loader = DataLoader(dataset, cfg.data, args.bs, seed=cfg.train.seed)
    steps_per_epoch = len(loader)
    total_steps = args.steps or steps_per_epoch * cfg.train.max_epochs
    state = create_train_state(cfg, model, steps_per_epoch)
    step_fn = make_train_step(model, cfg)

    save_dir = os.path.join(args.save_dir, args.net, dataset.name)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump({"config": dataclasses.asdict(cfg),
                   "classes": list(dataset.classes), "state_kind": "det"},
                  f, indent=1)
    if args.resume and ckpt.latest_step(save_dir) is not None:
        ckpt.restore_checkpoint(save_dir, state)
        print(f"resumed from step {state.step}")

    logger = MetricsLogger(log_file=os.path.join(save_dir, "metrics.jsonl"))
    ckpt_every = args.checkpoint_interval or steps_per_epoch
    prof = None
    start_step = step = state.step
    win_t0, win_step0 = time.perf_counter(), step
    t_train0 = first_step = None
    while step < total_steps:
        for batch in loader:
            if step >= total_steps:
                break
            tensors = [torch.from_numpy(a).to(device) for a in (
                batch.image, batch.im_info, batch.gt_boxes, batch.num_boxes)]
            state, metrics = step_fn(state, *tensors)
            step = state.step
            if args.profile and step == 3:
                prof = _start_profile(torch, device)
            if prof is not None and step == 8:
                _stop_profile(torch, device, prof, args.profile)
                prof = None
            if step % cfg.train.disp_interval == 0 or step == 1:
                m = {k: float(v) for k, v in metrics.items()}   # a sync
                now = time.perf_counter()
                if step > win_step0:
                    m["img_per_sec"] = (step - win_step0) * args.bs / (
                        now - win_t0)
                win_t0, win_step0 = now, step
                if t_train0 is None:   # the first step builds the kernels
                    t_train0, first_step = now, step
                logger.log(step, m)
            if step % ckpt_every == 0 or step == total_steps:
                path = ckpt.save_checkpoint(save_dir, state,
                                            epoch=step // steps_per_epoch)
                print(f"checkpoint -> {path}", flush=True)
    if prof is not None:
        _stop_profile(torch, device, prof, args.profile)
    logger.close()
    if t_train0 is not None and step > first_step:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        avg = (step - first_step) * args.bs / (time.perf_counter() - t_train0)
        print(f"done: {step - start_step} steps, avg {avg:.2f} img/s "
              f"(after the first logged step)")
    else:
        print(f"done: {step - start_step} steps")
    return 0


def _start_profile(torch, device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(torch, device, prof, out_dir):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace -> {path}", flush=True)


if __name__ == "__main__":
    sys.exit(main())

"""Training CLI of the PyTorch port (port of ``scda_tpu/cli/trainval.py``):
source-only Faster R-CNN and SCDA adaptation.  Builds the detector,
trains it with the supervised step (:mod:`scda_tpu_torch.train.steps`) or
the adaptation step (:mod:`scda_tpu_torch.adapt.scda`), logs metrics and
writes checkpoints that ``cli/test_net.py --load_dir`` evaluates.

    python -m scda_tpu_torch.cli.trainval --net vgg16 --dataset synthetic \
        --steps 100 --bs 1
    python -m scda_tpu_torch.cli.trainval --net res101 \
        --cfg_file cfgs/res101_ms.yml --dataset synthetic --steps 100

SCDA: ``--adapt --target_dataset <name>`` (or ``adapt.enabled`` in a
``--cfg_file``).  A second, unlabeled loader feeds the same step; the
usual workflow adapts a source-pretrained detector:

    python -m scda_tpu_torch.cli.trainval --net vgg16 --dataset synthetic \
        --steps 100 --save_dir models/src
    python -m scda_tpu_torch.cli.trainval --net vgg16 --dataset synthetic \
        --adapt --init_from models/src/vgg16/synthetic --steps 100 \
        --save_dir models/scda

Flags follow the JAX CLI.  Where that CLI turns ``model.stem_pallas`` off
for ``vgg16`` with ``train.freeze_pretrained_layers=false``, this one
leaves the decision to ``train.steps.check_train_config``, which refuses
the config (on the CPU, ``--set model.stem_pallas=false`` trains conv1 and
conv2).  ``--pretrained PTH`` loads a torchvision / caffe backbone
(``train/torch_convert.py``), ``--use_tfb`` mirrors the metrics to
TensorBoard where its writer is installed, ``--profile DIR`` writes a
``torch.profiler`` trace of steps 3-8, with the program's ``scda.*`` spans
(``utils/profile.py``) over its layers: here ``scda.data.wait``, the wait
for the loader's next batch, and ``scda.data.h2d``, its copy to the
device.  Every logged line has ``data_wait_frac``, the share of the wall
time since the last logged line that the loop spent waiting on the
loaders (host clock): near 1, the loader starves the device.

``--num_devices N`` trains data-parallel on N devices, one process each,
started here (``parallel.mesh.spawn``; NCCL on CUDA, gloo with ``--device
cpu``): ``--bs`` is the global batch and must divide by N, each rank
prepares and runs its rows, and the step is the global batch's (see
``parallel/mesh.py``).  Rank 0 writes the checkpoints and logs.  0 means
every visible GPU, as the JAX CLI's 0 means every device, and 1 on the CPU.
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
        description="Train Faster R-CNN / SCDA (PyTorch)")
    p.add_argument("--dataset", default="synthetic",
                   help="registered dataset name, or 'synthetic'")
    p.add_argument("--net", default="vgg16", choices=sorted(_NET_TO_BACKBONE))
    p.add_argument("--target_dataset", default=None,
                   help="unlabeled target-domain dataset (SCDA): a "
                        "registered name, 'dir:<path>' for a folder of "
                        "images, or 'synthetic_foggy' (the default target "
                        "of --adapt --dataset synthetic)")
    p.add_argument("--adapt", action="store_true",
                   help="SCDA adaptation training")
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
    p.add_argument("--init_from", default=None, metavar="DIR",
                   help="initialise the detector (model and momentum) from "
                        "the newest checkpoint in DIR and start at step 0: "
                        "adapt a source-pretrained detector")
    p.add_argument("--pretrained", default=None, metavar="PTH",
                   help="torchvision / caffe backbone .pth to load")
    p.add_argument("--torch_detector", default=None, metavar="PTH",
                   help="initialise the whole detector from a "
                        "reference-layout .pth (weights_only=True)")
    p.add_argument("--allow_unsafe_pickle", action="store_true",
                   help="permit full-pickle torch.load for legacy .pth "
                        "files that fail weights_only=True (runs arbitrary "
                        "code from the file: only for checkpoints you trust)")
    p.add_argument("--num_devices", type=int, default=0,
                   help="devices to train on, one process each (0 = every "
                        "visible GPU; 1 on the CPU); --bs must divide by it")
    p.add_argument("--use_tfb", action="store_true",
                   help="also write TensorBoard summaries (where the "
                        "writer's package is installed)")
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
    p.add_argument("--synth_src_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="scene size of the source fixture only (default: "
                        "the canvas size)")
    p.add_argument("--synth_fog", type=float, default=0.5,
                   help="fog level of the synthetic_foggy target fixture")
    p.add_argument("--synth_classes", default=None,
                   help="comma-separated class list for the synthetic "
                        "fixtures (e.g. 'car' for the car-only protocol)")
    return p.parse_args(argv)


def build_config(args):
    """The JAX CLI's config: preset, YAML, flags, ``--set`` overrides."""
    from scda_tpu_torch.config import (
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
    if args.adapt:
        cfg = replace_path(cfg, "adapt.enabled", True)
    if args.synth_size:
        cfg = replace_path(cfg, "data.image_size", tuple(args.synth_size))
    overrides = parse_set_list(args.set_cfgs)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def target_name(args):
    """The target dataset's name: ``--target_dataset``, or the foggy
    fixture for ``--adapt --dataset synthetic``, else None."""
    if args.target_dataset is None and args.adapt and args.dataset == "synthetic":
        return "synthetic_foggy"
    return args.target_dataset


def get_dataset(args, cfg, name):
    """Resolve a dataset name: ``synthetic`` / ``synthetic_foggy`` (the
    fixtures, drawn on the fly), ``dir:<path>`` (a folder of images, for
    the unlabeled target) or a registered name."""
    if name.startswith("dir:"):
        from scda_tpu_torch.data.voc import load_image_dir_dataset

        return load_image_dir_dataset(name[4:], name=os.path.basename(name[4:]))
    if name not in ("synthetic", "synthetic_foggy"):
        from scda_tpu_torch.data.voc import get_dataset as registered

        return registered(name)
    from scda_tpu_torch.data.synthetic import make_synthetic_dataset

    kw, suffix = {}, ""
    if args.synth_classes:
        kw["classes"] = tuple(c.strip() for c in args.synth_classes.split(",")
                              if c.strip())
        suffix = f"_c{len(kw['classes'])}"
    canvas = tuple(cfg.data.image_size)
    if name == "synthetic_foggy":
        return make_synthetic_dataset(
            os.path.join(tempfile.gettempdir(),
                         f"scda_synth_tgt_fog{args.synth_fog}{suffix}"),
            num_images=args.synth_images, image_size=canvas, seed=1,
            split="train", fog=args.synth_fog, name="synthetic_foggy", **kw)
    size = tuple(args.synth_src_size) if args.synth_src_size else canvas
    if size != canvas:
        suffix += f"_s{size[0]}x{size[1]}"
    return make_synthetic_dataset(
        os.path.join(tempfile.gettempdir(), f"scda_synth_train{suffix}"),
        num_images=args.synth_images, image_size=size,
        seed=0, split="train", **kw)


def main(argv=None) -> int:
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    args = parse_args(argv)
    cfg = build_config(args)
    tgt_name = target_name(args)
    if args.adapt and tgt_name is None:
        print("--adapt requires --target_dataset (or --dataset synthetic)",
              file=sys.stderr)
        return 2

    import torch

    from scda_tpu_torch.config import replace_path
    from scda_tpu_torch.parallel.mesh import num_devices, spawn

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device cpu "
              "for the plain-PyTorch path)", file=sys.stderr)
        return 2
    n_dev = num_devices(args.num_devices, device)
    if args.bs % n_dev:
        print(f"batch size {args.bs} not divisible by {n_dev} devices",
              file=sys.stderr)
        return 2

    from scda_tpu_torch.train.steps import check_train_config

    check_train_config(cfg, device)
    dataset = get_dataset(args, cfg, args.dataset)
    tgt_dataset = get_dataset(args, cfg, tgt_name) if tgt_name else None
    cfg = replace_path(cfg, "model.num_classes", dataset.num_classes)
    if (cfg.data.auto_canvas and not args.synth_size
            and not args.dataset.startswith("synthetic")):
        from scda_tpu_torch.data.pipeline import infer_canvas

        # One canvas for both domains: they share the step's shapes.
        records = list(dataset.records) + (
            list(tgt_dataset.records) if tgt_dataset is not None else [])
        canvas = infer_canvas(records, cfg.data)
        if canvas != tuple(cfg.data.image_size):
            print(f"canvas {tuple(cfg.data.image_size)} -> {canvas} "
                  f"(from record stats)")
            cfg = replace_path(cfg, "data.image_size", canvas)
    print(f"dataset={dataset.name} ({len(dataset)} images, "
          f"{dataset.num_classes - 1} fg classes), net={args.net}, "
          f"device={device}, devices={n_dev}, adapt={args.adapt}"
          + (f", target={tgt_dataset.name} ({len(tgt_dataset)} images)"
             if args.adapt else ""))
    run = (args, cfg, dataset, tgt_dataset)
    if n_dev > 1:
        # Each rank's share of this process's CPU threads.
        return spawn(_train_rank, n_dev, device, *run,
                     threads=max(torch.get_num_threads() // n_dev, 1))
    return _train(None, device, *run)


def _train_rank(world, device, *run) -> int:
    """One rank of data-parallel training; only rank 0 prints."""
    import contextlib

    if world.is_main:
        return _train(world, device, *run)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        return _train(world, device, *run)


def _train(world, device, args, cfg, dataset, tgt_dataset) -> int:
    """The training loop on ``device``: one process, or one rank of a
    ``world`` (this rank's rows of every batch; rank 0 writes)."""
    import torch

    from scda_tpu_torch.bridge import load_reference_checkpoint
    from scda_tpu_torch.data.pipeline import DataLoader
    from scda_tpu_torch.models.faster_rcnn import empty_model, init_params
    from scda_tpu_torch.parallel.mesh import ShardedDataLoader
    from scda_tpu_torch.train import checkpoint as ckpt
    from scda_tpu_torch.train.state import create_train_state
    from scda_tpu_torch.train.steps import make_train_step
    from scda_tpu_torch.utils.logging import MetricsLogger
    from scda_tpu_torch.utils.profile import span

    main_rank = world is None or world.is_main

    def loader_for(ds, seed):
        if world is None:
            return DataLoader(ds, cfg.data, args.bs, seed=seed)
        return ShardedDataLoader(ds, cfg.data, args.bs, seed=seed, world=world)

    # The JAX package's init distributions from the train seed, then a
    # pretrained backbone, unless a whole detector is loaded (the JAX
    # CLI's order).  ``--init_from`` restores every tensor of the
    # detector below, so the init (seconds of host time for VGG16) is
    # left out there: the weights that train are the same.
    model = empty_model(cfg.model, cfg.anchors.num_anchors)
    if not args.init_from:
        init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    if args.pretrained:
        from scda_tpu_torch.train.torch_convert import load_pretrained_backbone

        load_pretrained_backbone(model, args.pretrained, cfg.model.backbone,
                                 allow_unsafe_pickle=args.allow_unsafe_pickle)
        print(f"loaded pretrained backbone from {args.pretrained}")
    if args.torch_detector:
        load_reference_checkpoint(model, args.torch_detector,
                                  allow_unsafe_pickle=args.allow_unsafe_pickle)
        print(f"initialised the detector from {args.torch_detector}")
    model = model.to(device)

    loader = loader_for(dataset, cfg.train.seed)
    steps_per_epoch = len(loader)
    total_steps = args.steps or steps_per_epoch * cfg.train.max_epochs
    state = create_train_state(cfg, model, steps_per_epoch)
    if args.init_from:
        ckpt.restore_checkpoint(args.init_from, state)
        state.step = 0          # adaptation starts its own schedule
        print(f"detector initialised from {args.init_from}")
    tgt_iter = None
    if args.adapt:
        from scda_tpu_torch.adapt.scda import (
            create_scda_state, init_discriminator, make_scda_train_step,
        )

        d_model = init_discriminator(
            cfg, torch.Generator().manual_seed(cfg.train.seed + 1), device)
        state = create_scda_state(cfg, state, d_model)
        step_fn = make_scda_train_step(model, d_model, cfg, world)
        tgt_loader = loader_for(tgt_dataset, cfg.train.seed + 7)
        tgt_iter = iter(tgt_loader.repeat())
    else:
        step_fn = make_train_step(model, cfg, world)

    save_dir = os.path.join(args.save_dir, args.net, dataset.name)
    if main_rank:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump({"config": dataclasses.asdict(cfg),
                       "classes": list(dataset.classes),
                       # The checkpoints' layout: "scda" ones also hold the
                       # discriminator and its momentum.
                       "state_kind": "scda" if args.adapt else "det"},
                      f, indent=1)
    if args.resume and ckpt.latest_step(save_dir) is not None:
        ckpt.restore_checkpoint(save_dir, state)
        # The loaders too stand where the checkpointed run left them.
        loader.fast_forward(state.step)
        if args.adapt:
            tgt_loader.fast_forward(state.step)
        print(f"resumed from step {state.step}")

    logger = MetricsLogger(
        log_file=os.path.join(save_dir, "metrics.jsonl") if main_rank else None,
        tensorboard_dir=(os.path.join(save_dir, "tb")
                         if args.use_tfb and main_rank else None))
    ckpt_every = args.checkpoint_interval or steps_per_epoch
    prof = None
    start_step = step = state.step
    win_t0, win_step0 = time.perf_counter(), step
    waited = 0.0
    t_train0 = first_step = None

    def fetch(batches):
        """The next batch of ``batches`` (None at its end), and the
        seconds spent waiting for it."""
        t0 = time.perf_counter()
        with span("data.wait"):
            batch = next(batches, None)
        return batch, time.perf_counter() - t0

    def to_device(arrays):
        with span("data.h2d"):
            return [torch.from_numpy(a).to(device) for a in arrays]

    while step < total_steps:
        batches = iter(loader)
        while True:
            batch, dt = fetch(batches)
            waited += dt
            if batch is None or step >= total_steps:
                break
            tensors = to_device((batch.image, batch.im_info, batch.gt_boxes,
                                 batch.num_boxes))
            if tgt_iter is not None:
                tb, dt = fetch(tgt_iter)
                waited += dt
                tensors += to_device((tb.image, tb.im_info))
            state, metrics = step_fn(state, *tensors)
            step = state.step
            if args.profile and main_rank and step == 3:
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
                m["data_wait_frac"] = waited / (now - win_t0)
                win_t0, win_step0, waited = now, step, 0.0
                if t_train0 is None:   # the first step builds the kernels
                    t_train0, first_step = now, step
                logger.log(step, m)
            if main_rank and (step % ckpt_every == 0 or step == total_steps):
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

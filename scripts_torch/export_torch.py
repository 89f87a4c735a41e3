"""Export a checkpoint of the PyTorch port as a reference-layout .pth.

The inverse of ``test_net --torch_checkpoint``: writes the
jwyang/SCDA-lineage ``{'model': state_dict, ...}`` payload the
reference's own ``test_net.py --r`` loads, so a model trained with the
port can be evaluated by the reference codebase (the strongest
cross-framework fidelity check), or handed to a torch user.

Usage:
  python scripts_torch/export_torch.py --load_dir models --net vgg16 \
      --dataset cityscapes_train --out faster_rcnn_export.pth

It reads ``<load_dir>/<net>/<dataset>/ckpt_<step>.pth`` (the newest, or
``--checkpoint_step``) and the ``config.json`` that ``trainval`` wrote
beside it; of an SCDA checkpoint it takes the detector.  The state dict
carries every shape, so the port needs no ``--num_classes``.  A file
operation: it runs on no device.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--load_dir", default="models")
    p.add_argument("--net", default="vgg16",
                   choices=["vgg16", "res50", "res101", "res152"])
    p.add_argument("--dataset", required=True,
                   help="dataset name used at train time (checkpoint "
                        "subdirectory)")
    p.add_argument("--checkpoint_step", type=int, default=None)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import json

    import torch

    from scda_tpu_torch.cli.test_net import _NET_TO_BACKBONE, _NET_TO_PRESET
    from scda_tpu_torch.config import PRESETS, _merge_into, replace_path
    from scda_tpu_torch.train import checkpoint as ckpt
    from scda_tpu_torch.train.torch_convert import reference_payload

    cfg = PRESETS[_NET_TO_PRESET[args.net]]()
    cfg = replace_path(cfg, "model.backbone", _NET_TO_BACKBONE[args.net])
    save_dir = os.path.join(args.load_dir, args.net, args.dataset)
    cfg_json = os.path.join(save_dir, "config.json")
    state_kind = None
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            meta = json.load(f)
        cfg = _merge_into(cfg, {"model": meta["config"].get("model", {}),
                                "anchors": meta["config"].get("anchors",
                                                              {})})
        state_kind = meta.get("state_kind")

    # Source-only and SCDA checkpoints alike keep the detector under
    # "model"; an SCDA one adds the discriminator beside it.
    restored = ckpt.load_payload(save_dir, args.checkpoint_step)
    step = int(restored["step"])
    payload = reference_payload(restored["model"], cfg.model, step)
    torch.save(payload, args.out)
    kind = "SCDA " if state_kind == "scda" else ""
    print(f"exported step-{step} {kind}checkpoint -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.0f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

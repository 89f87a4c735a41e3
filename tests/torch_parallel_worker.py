"""The train steps that ``test_torch_parallel.py`` runs on two gloo ranks
and in one process.  Kept apart from the test module so that the ranks,
which start from a fresh interpreter, import only torch and the port."""

import os

import torch

from scda_tpu_torch.adapt.scda import (
    create_scda_state, init_discriminator, make_scda_train_step,
)
from scda_tpu_torch.models.faster_rcnn import build_model
from scda_tpu_torch.train.state import create_train_state
from scda_tpu_torch.train.steps import make_train_step

STEPS = 2


def run_steps(world, device, cfg, state_dict, batches, out_dir):
    """Two source-only steps and two SCDA joint steps from the same
    weights on ``batches`` (global numpy batches: source image, im_info,
    gt, num, target image, im_info), this rank's rows with a ``world``.
    Saves ``{kind: (metrics per step, parameters)}`` to
    ``out_dir/rank<r>.pt`` (``single.pt`` without a world).  oneDNN is
    off: its CPU conv backward is inexact (test_torch_train.py)."""
    rows = slice(None) if world is None else world.rows(len(batches[0]))
    local = [torch.from_numpy(a[rows]).to(device) for a in batches]
    out = {}
    with torch.backends.mkldnn.flags(enabled=False):
        for kind in ("source", "scda_joint"):
            model = build_model(cfg.model, cfg.anchors.num_anchors)
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in state_dict.items()})
            state = create_train_state(cfg, model)
            if kind == "source":
                step, args = make_train_step(model, cfg, world), local[:4]
            else:
                d_model = init_discriminator(
                    cfg, torch.Generator().manual_seed(1), device)
                state = create_scda_state(cfg, state, d_model)
                step = make_scda_train_step(model, d_model, cfg, world)
                args = local
            metrics = []
            for _ in range(STEPS):
                state, m = step(state, *args)
                metrics.append({k: float(v) for k, v in m.items()})
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
            if kind == "scda_joint":
                params.update({f"D.{n}": p.detach().clone()
                               for n, p in state.d_model.named_parameters()})
            out[kind] = (metrics, params)
    name = "single" if world is None else f"rank{world.rank}"
    torch.save(out, os.path.join(out_dir, f"{name}.pt"))
    return 0

"""The supervised train step (port of ``scda_tpu/train/steps.py``).

JAX jits forward, backward and optimizer into one XLA program; here the
step runs eagerly: :func:`forward_train`, ``torch.autograd.grad`` over the
trainable parameters, then the optimizer chain in place.  Params are
float32; the modules compute in ``model.compute_dtype``.

The step's randomness comes from three ``torch.Generator``\\ s seeded from
(seed, step) alone, as JAX folds the step into its base key, so a resumed
run needs no hidden RNG state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from scda_tpu_torch.config import Config
from scda_tpu_torch.models.detector import StepGenerators, forward_train
from scda_tpu_torch.models.faster_rcnn import FasterRCNN
from scda_tpu_torch.train.state import TrainState


def check_train_config(cfg: Config, device: torch.device) -> None:
    """Reject configs that would train incorrectly.

    Kernel K3 (the VGG stem) has no backward, so conv1/conv2 must stay
    frozen.  On a CUDA device the port always runs K3, whatever
    ``model.stem_pallas`` says, so there ``vgg16`` with
    ``train.freeze_pretrained_layers=false`` is refused.  On the CPU the
    rule is JAX's: refused only with ``model.stem_pallas`` on.
    """
    mc = cfg.model
    if mc.backbone != "vgg16" or cfg.train.freeze_pretrained_layers:
        return
    if torch.device(device).type == "cuda":
        raise ValueError(
            "vgg16 on CUDA trains through kernel K3, which has no backward: "
            "set train.freeze_pretrained_layers=true (conv1/conv2 frozen, "
            "as the reference does)")
    if mc.stem_pallas:
        raise ValueError(
            "model.stem_pallas requires train.freeze_pretrained_layers "
            "(the fused stem produces no conv1/conv2 gradients); set "
            "model.stem_pallas=false to train those layers")


def step_generators(seed: int, step: int, device) -> StepGenerators:
    """Three generators on ``device`` seeded from (seed, step): the
    anchor, roi and dropout streams."""
    seeds = np.random.SeedSequence([seed, step]).generate_state(3)
    return StepGenerators(*(torch.Generator(device=device).manual_seed(int(s))
                            for s in seeds))


def make_train_step(model: FasterRCNN, cfg: Config):
    """The supervised train step for ``model`` (on its device).

    ``step(state, image, im_info, gt_boxes, num_boxes, draws=None)``
    updates ``state`` in place and returns (state, metrics); the metrics
    stay on the device.  ``draws`` injects the target functions'
    uniforms (see :func:`forward_train`).  The generators are seeded
    from ``cfg.train.seed`` and the step.
    """
    device = next(model.parameters()).device
    check_train_config(cfg, device)
    seed = cfg.train.seed

    def step(state: TrainState, image, im_info, gt_boxes, num_boxes,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        rngs = step_generators(seed, state.step, device)
        out = forward_train(state.model, image, im_info, gt_boxes, num_boxes,
                            cfg, rngs, draws=draws)
        names, params = state.trainable()
        grads = torch.autograd.grad(out.loss, params, materialize_grads=True)
        state.apply_gradients(dict(zip(names, grads)))
        return state, {k: v.detach() for k, v in out.metrics.items()}

    return step

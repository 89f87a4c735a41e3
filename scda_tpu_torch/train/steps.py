"""The supervised train step (port of ``scda_tpu/train/steps.py``).

JAX jits forward, backward and optimizer into one XLA program; here the
step runs eagerly: :func:`forward_train`, ``torch.autograd.grad`` over the
trainable parameters, then the optimizer chain in place.  Params are
float32; the modules compute in ``model.compute_dtype``.

The step's randomness comes from three ``torch.Generator``\\ s seeded from
(seed, step) alone, as JAX folds the step into its base key, so a resumed
run needs no hidden RNG state.  The SCDA step
(:mod:`scda_tpu_torch.adapt.scda`) draws two more streams from the same
pair.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from scda_tpu_torch.config import Config, parse_backbone
from scda_tpu_torch.models.detector import (
    Detections, StepGenerators, forward_inference, forward_train,
)
from scda_tpu_torch.models.faster_rcnn import FasterRCNN
from scda_tpu_torch.train.state import TrainState
from scda_tpu_torch.utils.profile import span


def check_train_config(cfg: Config, device: torch.device) -> None:
    """Reject configs that would train incorrectly.

    Kernel K3 (the VGG stem) has no backward, so conv1/conv2 must stay
    frozen.  On a CUDA device the port always runs K3, whatever
    ``model.stem_pallas`` says, so there ``vgg16`` with
    ``train.freeze_pretrained_layers=false`` is refused.  On the CPU the
    rule is JAX's: refused only with ``model.stem_pallas`` on.
    """
    mc = cfg.model
    if (parse_backbone(mc.backbone)[0] != "vgg16"
            or cfg.train.freeze_pretrained_layers):
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


class ScdaGenerators(NamedTuple):
    """The SCDA step's randomness: the detection forward's three streams
    and one k-means init stream per domain."""

    det: StepGenerators
    mine_src: torch.Generator
    mine_tgt: torch.Generator


def scda_step_generators(seed: int, step: int, device) -> ScdaGenerators:
    """:func:`step_generators`' three streams (the same ones: a seed
    sequence's words are prefix-stable) and two more for the k-means
    inits of source and target mining."""
    seeds = np.random.SeedSequence([seed, step]).generate_state(5)
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    return ScdaGenerators(StepGenerators(*gens[:3]), gens[3], gens[4])


def make_train_step(model: FasterRCNN, cfg: Config, world=None):
    """The supervised train step for ``model`` (on its device).

    ``step(state, image, im_info, gt_boxes, num_boxes, draws=None)``
    updates ``state`` in place and returns (state, metrics); the metrics
    stay on the device.  ``draws`` injects the target functions'
    uniforms (see :func:`forward_train`).  The generators are seeded
    from ``cfg.train.seed`` and the step.

    With a ``world`` (:class:`scda_tpu_torch.parallel.mesh.World`, the
    JAX step's ``mesh``) the batch is this rank's rows of the global
    batch: each rank draws its rows of the global draws, the losses take
    the global denominators, and the gradients (one bucketed
    ``all_reduce``) and the metrics are summed over the ranks before the
    optimizer, so every replica takes the global batch's step.
    """
    device = next(model.parameters()).device
    check_train_config(cfg, device)
    seed = cfg.train.seed

    def step(state: TrainState, image, im_info, gt_boxes, num_boxes,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        with span("train_step", step=state.step):
            rngs = step_generators(seed, state.step, device)
            if world is not None:
                rngs = StepGenerators(*map(world.shard, rngs))
            out = forward_train(state.model, image, im_info, gt_boxes,
                                num_boxes, cfg, rngs, draws=draws, world=world)
            names, params = state.trainable()
            with span("backward"):
                grads = torch.autograd.grad(out.loss, params,
                                            materialize_grads=True)
            metrics = {k: v.detach() for k, v in out.metrics.items()}
            if world is not None:
                grads = world.sum_tensors(grads)
                metrics = world.sum_metrics(metrics)
            with span("optimizer"):
                state.apply_gradients(dict(zip(names, grads)))
        return state, metrics

    return step


def make_eval_step(model: FasterRCNN, cfg: Config):
    """The inference step: ``step(image, im_info)`` -> fixed-size
    :class:`Detections` (``cfg.test.max_per_image`` per image, invalid
    slots masked), under ``torch.inference_mode``.

    The JAX step's ``mesh`` shards the batch; here each data-parallel rank
    calls the step on its own rows (``parallel.mesh.ShardedDataLoader``)
    and the detections are gathered on rank 0
    (:func:`scda_tpu_torch.evals.detect.run_inference`)."""

    @torch.inference_mode()
    def step(image: torch.Tensor, im_info: torch.Tensor) -> Detections:
        return forward_inference(model, image, im_info, cfg)

    return step

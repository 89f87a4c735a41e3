"""SCDA adaptation training (port of ``scda_tpu/adapt/scda.py``):
region-level adversarial alignment.

One step: the source detection forward with its losses, a target forward
for proposals only, region mining on both domains, RoI-pooled region
patches from the stride-16 map, and a count-weighted domain loss from the
patch discriminator.

Objective, ``adapt.d_update="joint"`` (DANN single loss):
  L = L_det(source) + adv_weight * sum_k w_k * BCE(D(GRL(patch_k)), dom_k)
The discriminator descends on the BCE; the detector sees the reversed
gradient.  ``"alternating"`` is the GAN-style pair of losses
(:func:`scda_forward_alternating`).  Either way one forward serves both
networks and both optimizers step from gradients taken at the pre-update
discriminator.

JAX jits the step into one program; here it runs eagerly, as the
supervised step does (:mod:`scda_tpu_torch.train.steps`).  The step's
randomness is five ``torch.Generator``\\ s seeded from (seed, step): the
supervised step's three, then the mining inits of source and target.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from scda_tpu_torch.adapt.region_mining import MinedRegions, mine_regions
from scda_tpu_torch.config import Config, parse_backbone
from scda_tpu_torch.core.grad_reverse import grad_reverse
from scda_tpu_torch.models.detector import (
    StepGenerators, TrainForward, forward_train, global_sum,
)
from scda_tpu_torch.models.discriminator import (
    PatchDiscriminator, init_discriminator_weights,
)
from scda_tpu_torch.models.faster_rcnn import FasterRCNN, pool_rois
from scda_tpu_torch.models.rpn import anchor_grid, propose
from scda_tpu_torch.train.state import PlainSgd, TrainState
from scda_tpu_torch.train.steps import (
    ScdaGenerators, check_train_config, scda_step_generators,
)
from scda_tpu_torch.utils.profile import span, span_ids


@dataclasses.dataclass
class ScdaTrainState:
    """The detector's train state plus the discriminator and its
    optimizer: plain SGD with momentum (``trace = g + d_decay * trace``,
    ``p -= d_lr * trace``), with no clipping, no weight decay and no
    doubled bias rate, unlike the detector's chain."""

    det: TrainState
    d_model: PatchDiscriminator
    d_momentum: Dict[str, torch.Tensor]
    d_lr: float
    d_decay: float

    @property
    def step(self) -> int:
        return self.det.step

    @property
    def model(self) -> FasterRCNN:
        return self.det.model

    @torch.no_grad()
    def apply_gradients(self, g_det: Dict[str, torch.Tensor],
                        g_d: Dict[str, torch.Tensor]) -> None:
        """One step of both optimizers, in place, in one pass of the
        detector's chain (the discriminator as its plain group)."""
        self.det.apply_gradients(g_det, PlainSgd(
            dict(self.d_model.named_parameters()), g_d, self.d_momentum,
            self.d_decay, self.d_lr))


def create_scda_state(cfg: Config, det_state: TrainState,
                      d_model: PatchDiscriminator) -> ScdaTrainState:
    return ScdaTrainState(
        det=det_state, d_model=d_model,
        d_momentum={n: torch.zeros_like(p)
                    for n, p in d_model.named_parameters()},
        d_lr=cfg.adapt.d_lr, d_decay=cfg.train.momentum)


def discriminator_in_channels(cfg: Config) -> int:
    """Channels of the backbone's stride-16 map."""
    family = parse_backbone(cfg.model.backbone)[0]
    return {"vgg16": 512, "tiny": 64}.get(family, 1024)


def init_discriminator(cfg: Config, generator: torch.Generator,
                       device: torch.device | str = "cpu"
                       ) -> PatchDiscriminator:
    """Build and init the patch discriminator for the backbone's channels."""
    d_model = PatchDiscriminator(discriminator_in_channels(cfg),
                                 cfg.adapt.d_channels)
    init_discriminator_weights(d_model, generator)
    return d_model.to(device)


def _weighted_bce(logits: torch.Tensor, weights: torch.Tensor,
                  valid: torch.Tensor, domain: int, world=None):
    """Count-weighted BCE of domain logits against one label, and the
    accuracy over the valid groups (denominators over the global batch
    with a ``world``)."""
    labels = torch.full_like(logits, float(domain))
    per = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    w = torch.where(valid, weights, torch.zeros_like(weights))
    hit = ((logits > 0) == (labels > 0.5)) & valid
    acc = hit.float().sum() / global_sum(valid.float().sum(), world).clamp_min(1.0)
    return (torch.sum(per * w) / global_sum(w.sum(), world).clamp_min(1e-6),
            acc)


Patches = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _scda_parts(
    model: FasterRCNN,
    src_batch,
    tgt_image: torch.Tensor,
    tgt_im_info: torch.Tensor,
    cfg: Config,
    rngs: ScdaGenerators,
    draws: Optional[Dict[str, object]] = None,
    world=None,
) -> Tuple[TrainForward, Patches, Patches]:
    """The shared forward: source detection losses and the mined region
    patches of both domains, each as (patches f32, weights, valid) over
    the flat (B * K) groups."""
    ac = cfg.adapt
    draws = draws or {}
    det_out = forward_train(model, *src_batch, cfg, rngs.det, draws=draws,
                            world=world)

    def pooled_patches(feat, mined: MinedRegions) -> Patches:
        patches = pool_rois(feat, mined.boxes, None, cfg.model,
                            output_size=ac.region_pool_size)
        return (patches.float(), mined.weights.reshape(-1),
                mined.valid.reshape(-1))

    with span("adapt"):
        # Target domain: features and proposals only (no labels).  The RPN
        # head feeds nothing but the proposal layer, which has no gradient.
        with span("adapt.target"):
            feat_t = model.features(tgt_image)
            with torch.no_grad():
                rpn_cls_t, rpn_bbox_t = model.rpn_out(feat_t)
            anchors = anchor_grid(
                cfg.anchors.base_size, cfg.anchors.ratios, cfg.anchors.scales,
                cfg.model.feat_stride, feat_t.shape[1], feat_t.shape[2],
                feat_t.device)
            # Mining reads the top ``mining_top_n`` proposals, and greedy
            # NMS is prefix-stable (the first K kept boxes do not depend on
            # the output budget), so capping post_nms_top_n there is exact
            # and shortens the NMS scan and every gather after it.
            tgt_pcfg = dataclasses.replace(
                cfg.train.proposal,
                post_nms_top_n=min(cfg.train.proposal.post_nms_top_n,
                                   max(int(ac.mining_top_n), 1)))
            props_t = propose(rpn_cls_t, rpn_bbox_t, anchors, tgt_im_info,
                              tgt_pcfg)

        with span("adapt.mine"):
            mined_s = mine_regions(det_out.proposals.boxes,
                                   det_out.proposals.valid, ac, rngs.mine_src,
                                   draws=draws.get("mine_src"))
            mined_t = mine_regions(props_t.boxes, props_t.valid, ac,
                                   rngs.mine_tgt, draws=draws.get("mine_tgt"))

        with span("adapt.patches"):
            patches_s = pooled_patches(det_out.base_feat, mined_s)
            patches_t = pooled_patches(feat_t, mined_t)
    return det_out, patches_s, patches_t


def _span_backward(adv: torch.Tensor, det_loss: torch.Tensor) -> None:
    """While a profiler records: ``scda.adapt.bwd`` opens when the
    backward reaches ``adv``'s node and closes when it reaches
    ``det_loss``'s.  Autograd runs the ready node created last first, and
    every node only the adversarial loss reaches (the discriminator, the
    gradient reversals, the patches' RoI-Align, the target tower) was
    created after the detection loss's, so the span holds all of them and
    no node of the detection loss.  The nodes run on autograd's thread:
    the span carries the ids of this forward."""
    ids = span_ids()
    if ids is None or adv.grad_fn is None or det_loss.grad_fn is None:
        return
    opened = []

    def open_(grad_outputs):
        opened.append(span("adapt.bwd", **ids))
        opened[-1].__enter__()

    def close(grad_outputs):
        if opened:
            opened.pop().__exit__(None, None, None)

    adv.grad_fn.register_prehook(open_)
    det_loss.grad_fn.register_prehook(close)


def scda_forward(model: FasterRCNN, d_model: PatchDiscriminator, src_batch,
                 tgt_image, tgt_im_info, cfg: Config, rngs: ScdaGenerators,
                 draws=None, world=None):
    """The joint SCDA loss: source detection plus the weighted
    region-adversarial BCE, whose gradient reaches the detector reversed.
    The discriminator's gradient is that of this total, so it carries the
    factor ``adv_weight``.  Returns (total, metrics)."""
    ac = cfg.adapt
    det_out, (p_s, w_s, v_s), (p_t, w_t, v_t) = _scda_parts(
        model, src_batch, tgt_image, tgt_im_info, cfg, rngs, draws, world)
    with span("adapt"), span("adapt.disc"):
        loss_s, acc_s = _weighted_bce(
            d_model(grad_reverse(p_s, ac.grl_weight)), w_s, v_s, 1, world)
        loss_t, acc_t = _weighted_bce(
            d_model(grad_reverse(p_t, ac.grl_weight)), w_t, v_t, 0, world)
        adv = 0.5 * (loss_s + loss_t)
    _span_backward(adv, det_out.loss)

    total = det_out.loss + ac.adv_weight * adv
    metrics = dict(det_out.metrics)
    metrics.update(adv=adv, adv_src=loss_s, adv_tgt=loss_t,
                   d_acc=0.5 * (acc_s + acc_t), loss=total)
    return total, metrics


def scda_forward_alternating(model: FasterRCNN, d_model: PatchDiscriminator,
                             src_batch, tgt_image, tgt_im_info, cfg: Config,
                             rngs: ScdaGenerators, draws=None, world=None):
    """The GAN-style pair of losses (``adapt.d_update="alternating"``):

      * D loss: BCE with the true domain labels on detached patches, so
        only the discriminator receives its gradient;
      * G loss: BCE with flipped labels (source 0, target 1) through a
        frozen discriminator (its parameters detached in a functional
        call over the same graph), so only the detector receives it.

    Returns (total, metrics) with ``total = det + adv_weight * G + D``:
    its gradient is det + adv_weight * G for the detector and D alone for
    the discriminator.  The logged ``loss`` leaves ``d_loss`` out, so that
    curves compare with the joint schedule's.
    """
    ac = cfg.adapt
    det_out, (p_s, w_s, v_s), (p_t, w_t, v_t) = _scda_parts(
        model, src_batch, tgt_image, tgt_im_info, cfg, rngs, draws, world)

    with span("adapt"), span("adapt.disc"):
        d_loss_s, acc_s = _weighted_bce(d_model(p_s.detach()), w_s, v_s, 1,
                                        world)
        d_loss_t, acc_t = _weighted_bce(d_model(p_t.detach()), w_t, v_t, 0,
                                        world)
        d_loss = 0.5 * (d_loss_s + d_loss_t)

        frozen = {n: p.detach() for n, p in d_model.named_parameters()}
        g_loss_s, _ = _weighted_bce(
            torch.func.functional_call(d_model, frozen, (p_s,)), w_s, v_s, 0,
            world)
        g_loss_t, _ = _weighted_bce(
            torch.func.functional_call(d_model, frozen, (p_t,)), w_t, v_t, 1,
            world)
        adv = 0.5 * (g_loss_s + g_loss_t)
    _span_backward(adv, det_out.loss)

    total = det_out.loss + ac.adv_weight * adv + d_loss
    metrics = dict(det_out.metrics)
    metrics.update(adv=adv, adv_src=g_loss_s, adv_tgt=g_loss_t, d_loss=d_loss,
                   d_acc=0.5 * (acc_s + acc_t),
                   loss=det_out.loss + ac.adv_weight * adv)
    return total, metrics


def make_scda_train_step(model: FasterRCNN, d_model: PatchDiscriminator,
                         cfg: Config, world=None):
    """The adaptation step for ``model`` and ``d_model`` (on the model's
    device).

    ``step(state, src_image, src_info, src_gt, src_num, tgt_image,
    tgt_info, draws=None)`` updates ``state`` in place and returns (state,
    metrics); the metrics stay on the device.  ``cfg.adapt.d_update``
    picks the objective, ``"joint"`` or ``"alternating"``; the step's
    structure (one forward, two optimizers) is the same either way.
    ``draws`` may hold the target functions' uniforms (``"anchor"``,
    ``"roi"``) and the mining inits' noise (``"mine_src"``,
    ``"mine_tgt"``, see :func:`scda_tpu_torch.core.kmeans.kmeans`).

    With a ``world`` (:class:`scda_tpu_torch.parallel.mesh.World`) the
    batches are this rank's rows, the draws its rows of the global ones,
    and the gradients and metrics are summed over the ranks: the step is
    the global batch's.
    """
    device = next(model.parameters()).device
    check_train_config(cfg, device)
    if cfg.adapt.d_update not in ("joint", "alternating"):
        raise ValueError(f"adapt.d_update: {cfg.adapt.d_update!r} "
                         "(want 'joint' or 'alternating')")
    if parse_backbone(cfg.model.backbone)[0] == "resnet_fpn":
        raise ValueError(f"SCDA adapts single-level detectors; "
                         f"{cfg.model.backbone} has a feature pyramid")
    forward = (scda_forward if cfg.adapt.d_update == "joint"
               else scda_forward_alternating)
    seed = cfg.train.seed

    def step(state: ScdaTrainState, src_image, src_info, src_gt, src_num,
             tgt_image, tgt_info, draws=None):
        with span("scda_step", step=state.step):
            rngs = scda_step_generators(seed, state.step, device)
            if world is not None:
                rngs = ScdaGenerators(
                    StepGenerators(*map(world.shard, rngs.det)),
                    world.shard(rngs.mine_src), world.shard(rngs.mine_tgt))
            total, metrics = forward(
                state.model, state.d_model,
                (src_image, src_info, src_gt, src_num), tgt_image, tgt_info,
                cfg, rngs, draws, world)
            names, params = state.det.trainable()
            d_names, d_params = zip(*state.d_model.named_parameters())
            with span("backward"):
                grads = torch.autograd.grad(total, [*params, *d_params],
                                            materialize_grads=True)
            if world is not None:
                grads = world.sum_tensors(grads)
                metrics = world.sum_metrics(metrics)
            with span("optimizer"):
                state.apply_gradients(dict(zip(names, grads[:len(names)])),
                                      dict(zip(d_names, grads[len(names):])))
        return state, {k: v.detach() for k, v in metrics.items()}

    return step

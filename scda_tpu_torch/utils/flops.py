"""Analytic FLOP counts for the detector configs (MFU denominators; port
of ``scda_tpu/utils/flops.py``, arithmetic on the port's own ``Config``).

These counters walk the actual layer shapes, so a run can report
MFU = img/s x FLOPs/img / peak beside raw throughput.  Convention:
1 MAC = 2 FLOPs; elementwise/pool/NMS work is ignored (<2% of a conv
detector's arithmetic).

Backward-pass convention for train steps: each TRAINABLE conv/dense
costs ~2x its forward FLOPs in backward (input-grad + weight-grad
matmuls); FROZEN layers cost nothing extra — the r2 frozen-grad DCE
eliminates their entire backward (RESULTS.md), and VGG's conv1-2 /
ResNet's conv1+layer1 are frozen per the reference recipe.
"""

from __future__ import annotations

from typing import Tuple

from scda_tpu_torch.config import Config
from scda_tpu_torch.models.backbones.resnet import RESNET_DEPTHS
from scda_tpu_torch.models.backbones.vgg import VGG16_LAYOUT, _FROZEN_TORCH_IDX


def conv_flops(h: int, w: int, cin: int, cout: int, k: int,
               stride: int = 1) -> float:
    # SAME-style padding (pad = k//2, the only convention used here):
    # output extent is ceil(h/s) — floor undercounts odd extents (the
    # 7x7 RoI head's layer4 is 4x4, not 3x3).
    ho, wo = -(-h // stride), -(-w // stride)
    return 2.0 * ho * wo * cin * cout * k * k


def dense_flops(n: int, cin: int, cout: int) -> float:
    return 2.0 * n * cin * cout


def vgg16_backbone_flops(h: int, w: int,
                         split_frozen: bool = False):
    """Conv1_1..conv5_3 FLOPs at canvas (h, w); optionally split into
    (frozen conv1-2, trainable conv3-5)."""
    frozen = trainable = 0.0
    cin = 3
    for item in VGG16_LAYOUT:
        if item == "M":
            h, w = h // 2, w // 2
            continue
        idx, cout = item
        f = conv_flops(h, w, cin, cout, 3)
        if idx in _FROZEN_TORCH_IDX:
            frozen += f
        else:
            trainable += f
        cin = cout
    if split_frozen:
        return frozen, trainable
    return frozen + trainable


def _bottleneck_flops(h, w, cin, f, stride):
    fl = conv_flops(h, w, cin, f, 1)
    fl += conv_flops(h, w, f, f, 3, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    fl += conv_flops(ho, wo, f, f * 4, 1)
    if cin != f * 4 or stride != 1:
        fl += conv_flops(h, w, cin, f * 4, 1, stride)
    return fl, ho, wo, f * 4


def resnet_backbone_flops(depth: int, h: int, w: int,
                          fixed_blocks: int = 1, split_frozen: bool = False):
    """conv1..layer3 FLOPs; frozen = conv1 + layer1..layer{fixed}."""
    blocks = RESNET_DEPTHS[depth]
    frozen = conv_flops(h, w, 3, 64, 7, 2)
    h, w = h // 4, w // 4          # conv1 /2 + maxpool /2
    cin = 64
    trainable = 0.0
    for li, (n, f) in enumerate(zip(blocks[:3], (64, 128, 256)), start=1):
        stage = 0.0
        for bi in range(n):
            stride = 2 if (bi == 0 and li > 1) else 1
            fl, h, w, cin = _bottleneck_flops(h, w, cin, f, stride)
            stage += fl
        if li <= fixed_blocks:
            frozen += stage
        else:
            trainable += stage
    if split_frozen:
        return frozen, trainable
    return frozen + trainable


def resnet_head_flops(depth: int, rois: int, p: int = 7) -> float:
    """layer4 on (rois, p, p, 1024) pooled features."""
    blocks = RESNET_DEPTHS[depth]
    h = w = p
    cin = 1024
    total = 0.0
    for bi in range(blocks[3]):
        fl, h, w, cin = _bottleneck_flops(h, w, cin, 512, 2 if bi == 0
                                          else 1)
        total += fl
    return total * rois


def rpn_flops(fh: int, fw: int, cin: int, channels: int,
              num_anchors: int = 9) -> float:
    fl = conv_flops(fh, fw, cin, channels, 3)
    fl += conv_flops(fh, fw, channels, 2 * num_anchors, 1)
    fl += conv_flops(fh, fw, channels, 4 * num_anchors, 1)
    return fl


def vgg_head_flops(rois: int, p: int = 7) -> float:
    return (dense_flops(rois, 512 * p * p, 4096)
            + dense_flops(rois, 4096, 4096))


def cls_head_flops(rois: int, feat_dim: int, num_classes: int,
                   class_agnostic: bool) -> float:
    out = num_classes + (4 if class_agnostic else 4 * num_classes)
    return dense_flops(rois, feat_dim, out)


def inference_flops_per_image(cfg: Config,
                              canvas_hw: Tuple[int, int]) -> float:
    """Forward-only FLOPs for one image at test settings."""
    h, w = canvas_hw
    mc = cfg.model
    rois = cfg.test.proposal.post_nms_top_n
    if mc.backbone == "vgg16":
        total = vgg16_backbone_flops(h, w)
        total += rpn_flops(h // 16, w // 16, 512, mc.rpn_channels)
        total += vgg_head_flops(rois)
        total += cls_head_flops(rois, 4096, mc.num_classes,
                                mc.class_agnostic)
    elif mc.backbone.startswith("resnet"):
        depth = int(mc.backbone.replace("resnet", ""))
        total = resnet_backbone_flops(depth, h, w)
        total += rpn_flops(h // 16, w // 16, 1024, mc.rpn_channels)
        total += resnet_head_flops(depth, rois)
        total += cls_head_flops(rois, 2048, mc.num_classes,
                                mc.class_agnostic)
        if mc.multiscale_roi:
            if mc.ms_proj_after_pool:
                # Commuted lateral projection: one 1x1 over the POOLED
                # fine level (R*P*P positions) instead of the full map.
                p = mc.pooling_size
                total += dense_flops(rois * p * p, 512, 1024)
            else:
                # c3_proj lateral 1x1 (512 -> 1024) on the stride-8 map.
                total += conv_flops(h // 8, w // 8, 512, 1024, 1)
    else:
        raise ValueError(mc.backbone)
    return total


def train_flops_per_image(cfg: Config,
                          canvas_hw: Tuple[int, int]) -> float:
    """fwd + ~2x fwd backward for trainable layers, per image."""
    h, w = canvas_hw
    mc = cfg.model
    rois = cfg.train.roi_target.batch_size
    frozen_on = cfg.train.freeze_pretrained_layers
    if mc.backbone == "vgg16":
        fr, tr = vgg16_backbone_flops(h, w, split_frozen=True)
        if not frozen_on:
            fr, tr = 0.0, fr + tr
        head = (vgg_head_flops(rois)
                + cls_head_flops(rois, 4096, mc.num_classes,
                                 mc.class_agnostic))
    else:
        depth = int(mc.backbone.replace("resnet", ""))
        fr, tr = resnet_backbone_flops(depth, h, w,
                                       mc.resnet_fixed_blocks,
                                       split_frozen=True)
        if not frozen_on:
            fr, tr = 0.0, fr + tr
        head = (resnet_head_flops(depth, rois)
                + cls_head_flops(rois, 2048, mc.num_classes,
                                 mc.class_agnostic))
    rpn = rpn_flops(h // 16, w // 16,
                    512 if mc.backbone == "vgg16" else 1024,
                    mc.rpn_channels)
    return fr + 3.0 * (tr + rpn + head)


def scda_step_flops_per_src_image(cfg: Config,
                                  canvas_hw: Tuple[int, int]) -> float:
    """One SCDA step: source train step + target fwd (backbone+RPN,
    with backward through the adversarial path ~ 2x fwd on trainable
    layers) + discriminator (negligible)."""
    h, w = canvas_hw
    mc = cfg.model
    src = train_flops_per_image(cfg, canvas_hw)
    fr, tr = vgg16_backbone_flops(h, w, split_frozen=True) \
        if mc.backbone == "vgg16" else resnet_backbone_flops(
            int(mc.backbone.replace("resnet", "")), h, w,
            mc.resnet_fixed_blocks, split_frozen=True)
    if not cfg.train.freeze_pretrained_layers:
        fr, tr = 0.0, fr + tr
    rpn = rpn_flops(h // 16, w // 16,
                    512 if mc.backbone == "vgg16" else 1024,
                    mc.rpn_channels)
    tgt = fr + 3.0 * (tr + rpn)
    return src + tgt

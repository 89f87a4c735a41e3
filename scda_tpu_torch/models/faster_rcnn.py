"""Faster R-CNN assembly (port of ``scda_tpu/models/faster_rcnn.py``).

The module holds the network pieces — backbone, RPN head, RoI head —
under the reference lineage's state-dict names (``RCNN_base``,
``RCNN_rpn``, ``RCNN_top``, ``RCNN_cls_score``, ``RCNN_bbox_pred``), so a
reference-layout ``.pth`` loads with ``load_state_dict`` unchanged.  The
pipeline lives in :mod:`scda_tpu_torch.models.detector`.

The public methods keep the JAX layouts (NHWC images and features);
inside, modules run NCHW in ``torch.channels_last``, whose permuted view
is the NHWC tensor without a copy.

Ported: the ``vgg16`` and ``tiny`` backbones with ``align`` and
``align_legacy`` pooling on grouped rois.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from scda_tpu.config import ModelConfig
from scda_tpu_torch.models.backbones.tiny import TinyBackbone, TinyHead
from scda_tpu_torch.models.backbones.vgg import VGG16Backbone, VGG16Head
from scda_tpu_torch.models.rpn import RPNHead
from scda_tpu_torch.ops.roi_ops import (
    roi_align_grouped, roi_align_legacy_grouped,
)

_POOLING_MODES = ("align", "align_legacy")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.backbone.startswith("resnet"):
        raise NotImplementedError(
            f"backbone {cfg.backbone!r}: ResNet comes with slice 4 of the "
            "PyTorch port (see ROADMAP.md)")
    if cfg.multiscale_roi:
        raise NotImplementedError(
            "model.multiscale_roi comes with slice 4 of the PyTorch port "
            "(see ROADMAP.md)")
    if cfg.pooling_mode in ("pool", "crop"):
        raise NotImplementedError(
            f"pooling_mode {cfg.pooling_mode!r} is not ported yet (see "
            "ROADMAP.md); use 'align' or 'align_legacy'")
    if cfg.pooling_mode not in _POOLING_MODES:
        raise ValueError(f"unknown pooling_mode {cfg.pooling_mode!r}")
    if cfg.backbone not in ("vgg16", "tiny"):
        raise ValueError(f"unknown backbone {cfg.backbone!r}")


class FasterRCNN(nn.Module):
    """Backbone + RPN head + RoI classification head."""

    def __init__(self, cfg: ModelConfig, num_anchors: int = 9):
        super().__init__()
        _check_ported(cfg)
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.dtype = dt
        p = cfg.pooling_size
        if cfg.backbone == "vgg16":
            feat_ch = 512
            self.RCNN_base = VGG16Backbone(dtype=dt)
            self.RCNN_top = VGG16Head(feat_ch * p * p, dtype=dt)
        else:
            feat_ch = 64
            self.RCNN_base = TinyBackbone(feat_ch, dtype=dt)
            self.RCNN_top = TinyHead(feat_ch * p * p, dtype=dt)
        self.RCNN_rpn = RPNHead(feat_ch, cfg.rpn_channels, num_anchors, dtype=dt)
        head_dim = self.RCNN_top.out_dim
        self.RCNN_cls_score = nn.Linear(head_dim, cfg.num_classes)
        self.RCNN_bbox_pred = nn.Linear(
            head_dim, 4 if cfg.class_agnostic else 4 * cfg.num_classes)

    def features(self, image: torch.Tensor) -> torch.Tensor:
        """Image (B, H, W, 3) -> base features (B, H/16, W/16, C)."""
        return self.RCNN_base(image.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def rpn_out(self, feat: torch.Tensor):
        """(B, h, w, C) -> cls logits (B, h, w, A, 2), deltas (B, h, w, A, 4)."""
        return self.RCNN_rpn(feat)

    def roi_head(self, pooled: torch.Tensor, train: bool = False):
        """Pooled rois (R, P, P, C) -> (cls_logits (R, classes), bbox_deltas
        (R, 4 or 4 * classes)), both float32."""
        dt = self.dtype
        hidden = self.RCNN_top(pooled, train=train)
        cls = F.linear(hidden, self.RCNN_cls_score.weight.to(dt),
                       self.RCNN_cls_score.bias.to(dt))
        bbox = F.linear(hidden, self.RCNN_bbox_pred.weight.to(dt),
                        self.RCNN_bbox_pred.bias.to(dt))
        return cls.float(), bbox.float()


def pool_rois(
    feat: torch.Tensor,
    rois: torch.Tensor,
    batch_indices: torch.Tensor | None,
    cfg: ModelConfig,
    *,
    output_size: int | None = None,
) -> torch.Tensor:
    """RoI-Align per ``cfg.pooling_mode`` on NHWC features and grouped
    (B, R, 4) rois; returns flat (B*R, P, P, C) for the RoI head."""
    if rois.dim() != 3 or batch_indices is not None:
        raise NotImplementedError(
            "flat (R, 4) rois with batch indices are not ported yet (see "
            "ROADMAP.md); pass grouped (B, R, 4) rois")
    _check_ported(cfg)
    p = output_size or cfg.pooling_size
    if cfg.pooling_mode == "align_legacy":
        out = roi_align_legacy_grouped(feat, rois, output_size=p,
                                       spatial_scale=1.0 / cfg.feat_stride)
    else:
        out = roi_align_grouped(feat, rois, output_size=p,
                                spatial_scale=1.0 / cfg.feat_stride,
                                sampling_ratio=cfg.sampling_ratio)
    return out.reshape((-1,) + tuple(out.shape[2:]))


def init_weights(model: FasterRCNN, generator: torch.Generator,
                 *, input_scale: float = 1.0, he_heads: bool = False) -> None:
    """Seeded random init, in place.

    Convs and the fc head: He-normal (std sqrt(2 / fan_in)), zero bias.
    The first conv is scaled by ``input_scale`` (e.g. 1/64 for raw
    mean-subtracted 0-255 pixels, so activations stay O(1) through the
    ReLU stack).  ``RCNN_cls_score`` / ``RCNN_bbox_pred``: N(0, 0.01) /
    N(0, 0.001) as the reference initialises them, or He-normal with
    ``he_heads`` so that random-weight scores spread out.
    """
    first = True
    for name, mod in model.named_modules():
        if not isinstance(mod, (nn.Conv2d, nn.Linear)):
            continue
        fan_in = mod.weight[0].numel()
        std = math.sqrt(2.0 / fan_in)
        if name == "RCNN_cls_score" and not he_heads:
            std = 0.01
        elif name == "RCNN_bbox_pred" and not he_heads:
            std = 0.001
        if first:
            std *= input_scale
            first = False
        w = torch.randn(mod.weight.shape, generator=generator) * std
        with torch.no_grad():
            mod.weight.copy_(w)
            mod.bias.zero_()


def build_model(cfg: ModelConfig, num_anchors: int = 9, *,
                generator: torch.Generator | None = None,
                device: torch.device | str = "cpu") -> FasterRCNN:
    """FasterRCNN on ``device`` in ``torch.channels_last``, in eval mode,
    initialised by :func:`init_weights` from ``generator`` (seed 0 when
    None)."""
    model = FasterRCNN(cfg, num_anchors)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(device=device, memory_format=torch.channels_last).eval()

"""Faster R-CNN assembly (port of ``scda_tpu/models/faster_rcnn.py``).

The module holds the network pieces — backbone, RPN head, RoI head —
under the reference lineage's state-dict names (``RCNN_base``,
``RCNN_rpn``, ``RCNN_top``, ``RCNN_cls_score``, ``RCNN_bbox_pred``), so a
reference-layout ``.pth`` loads with ``load_state_dict`` unchanged.  The
pipeline lives in :mod:`scda_tpu_torch.models.detector`.

The public methods keep the JAX layouts (NHWC images and features);
inside, modules run NCHW in ``torch.channels_last``, whose permuted view
is the NHWC tensor without a copy.

The ``vgg16``, ``tiny`` and ``resnet50/101/152`` backbones, and the
``resnet50/101/152_fpn`` feature pyramids (:mod:`scda_tpu_torch.models.
fpn`: ``RCNN_fpn`` beside those five, ``RCNN_top`` its two-layer MLP
head); the four pooling modes (``align``, ``align_legacy``, ``pool``,
``crop``) on grouped or flat rois; multiscale RoI-Align (``multiscale_roi``) with the lateral
projection before or after pooling (``ms_proj_after_pool``).

The model picks its layout once, when built (one stride-16 map, that map
and a stride-8 level for pooling, or an FPN's P2 .. P6): the maps it
runs the RPN on and pools from (:meth:`FasterRCNN.levels`), and how it
pools (:meth:`FasterRCNN.pool`).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scda_tpu_torch.config import ModelConfig, parse_backbone
from scda_tpu_torch.models import fpn
from scda_tpu_torch.models.backbones.resnet import (
    FrozenBatchNorm2d, ResNetBackbone, ResNetC4Head,
)
from scda_tpu_torch.models.backbones.tiny import TinyBackbone, TinyHead
from scda_tpu_torch.models.backbones.vgg import VGG16Backbone, VGG16Head
from scda_tpu_torch.models.rpn import RPNHead
from scda_tpu_torch.ops.roi_ops import (
    contract_axis_weights, roi_align, roi_align_axis_weights,
    roi_align_grouped, roi_align_legacy, roi_align_legacy_grouped, roi_crop,
    roi_pool,
)
from scda_tpu_torch.utils.profile import span

_POOLING_MODES = ("align", "align_legacy", "pool", "crop")


def _check_config(cfg: ModelConfig) -> None:
    if cfg.pooling_mode not in _POOLING_MODES:
        raise ValueError(f"unknown pooling_mode {cfg.pooling_mode!r}")
    if parse_backbone(cfg.backbone)[0] == "resnet_fpn" and (
            cfg.pooling_mode != "align" or cfg.multiscale_roi):
        raise ValueError(f"{cfg.backbone} pools with RoI-Align from its own "
                         f"levels: pooling_mode must be 'align' and "
                         f"multiscale_roi false")


class Level(NamedTuple):
    """A map the RPN runs on."""

    map: torch.Tensor           # (B, h, w, C) NHWC
    stride: int
    base_size: Optional[int]    # of its anchors; None: ``anchors.base_size``
    level: Optional[int]        # its pyramid level, None for a single map


class FasterRCNN(nn.Module):
    """Backbone + RPN head + RoI classification head."""

    def __init__(self, cfg: ModelConfig, num_anchors: int = 9):
        super().__init__()
        _check_config(cfg)
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.dtype = dt
        self.cfg = cfg
        p = cfg.pooling_size
        family, depth = parse_backbone(cfg.backbone)
        if family == "resnet_fpn":
            feat_ch = fpn.FPN_DIM
            self.RCNN_base = ResNetBackbone(depth, dtype=dt, layer4=True)
            self.RCNN_fpn = fpn.FPN(dtype=dt)
            self.RCNN_top = fpn.MLPHead(fpn.FPN_DIM * p * p, dtype=dt)
        elif family == "vgg16":
            feat_ch = f8_ch = 512
            self.RCNN_base = VGG16Backbone(dtype=dt)
            self.RCNN_top = VGG16Head(feat_ch * p * p, dtype=dt)
        elif family == "tiny":
            feat_ch, f8_ch = 64, 48
            self.RCNN_base = TinyBackbone(feat_ch, dtype=dt)
            self.RCNN_top = TinyHead(feat_ch * p * p, dtype=dt)
        else:
            feat_ch, f8_ch = 1024, 512
            self.RCNN_base = ResNetBackbone(depth, dtype=dt)
            self.RCNN_top = ResNetC4Head(depth, dtype=dt)
        self.RCNN_rpn = RPNHead(feat_ch, cfg.rpn_channels, num_anchors, dtype=dt)
        if cfg.multiscale_roi:
            # Lateral 1x1 projection of the stride-8 level to the stride-16
            # channel count, so the RoI head is level-agnostic.
            self.RCNN_c3_proj = nn.Conv2d(f8_ch, feat_ch, 1)
        head_dim = self.RCNN_top.out_dim
        self.RCNN_cls_score = nn.Linear(head_dim, cfg.num_classes)
        self.RCNN_bbox_pred = nn.Linear(
            head_dim, 4 if cfg.class_agnostic else 4 * cfg.num_classes)
        if family == "resnet_fpn":
            self._layout = self._pyramid_levels, self._pyramid_pool
        elif cfg.multiscale_roi:
            self._layout = self._two_levels, self._two_level_pool
        else:
            self._layout = self._one_level, self._one_level_pool

    def levels(self, image: torch.Tensor) -> Tuple[tuple, List[Level]]:
        """Image (B, H, W, 3) -> (the maps :meth:`pool` reads, the RPN's
        levels), under the ``backbone`` span (and ``fpn``, a pyramid's)."""
        return self._layout[0](image)

    def pool(self, maps: tuple, rois: torch.Tensor) -> torch.Tensor:
        """RoI pooling of grouped rois (B, R, 4) from :meth:`levels`'
        maps: flat (B * R, P, P, C) for the RoI head."""
        return self._layout[1](maps, rois)

    def _one_level(self, image):
        with span("backbone"):
            feat = self.features(image)
        return (feat,), [Level(feat, self.cfg.feat_stride, None, None)]

    def _one_level_pool(self, maps, rois):
        return pool_rois(maps[0], rois, None, self.cfg)

    def _two_levels(self, image):
        with span("backbone"):
            maps = self.features_pyramid(image)
        return maps, [Level(maps[1], self.cfg.feat_stride, None, None)]

    def _two_level_pool(self, maps, rois):
        if self.cfg.ms_proj_after_pool:
            return self.pool_multiscale(*maps, rois)
        return pool_rois_multiscale(*maps, rois, self.cfg)

    def _pyramid_levels(self, image):
        with span("backbone"):
            trunk = self.RCNN_base.levels(image.permute(0, 3, 1, 2))
        with span("fpn"):
            pyramid = tuple(self.RCNN_fpn(trunk))
        return pyramid, [Level(p, 2 ** k, 2 ** k, k)
                         for k, p in zip(fpn.RPN_LEVELS, pyramid)]

    def _pyramid_pool(self, maps, rois):
        return fpn.pool_levels(maps, rois, self.cfg)

    def features(self, image: torch.Tensor) -> torch.Tensor:
        """Image (B, H, W, 3) -> base features (B, H/16, W/16, C)."""
        return self.RCNN_base(image.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _c3_proj(self, x: torch.Tensor) -> torch.Tensor:
        """The lateral 1x1 projection on NHWC ``x``, in the compute dtype."""
        dt, conv = self.dtype, self.RCNN_c3_proj
        w = conv.weight.reshape(conv.weight.shape[0], -1)
        return F.linear(x.to(dt), w.to(dt), conv.bias.to(dt))

    def features_pyramid(self, image: torch.Tensor):
        """Image -> (stride-8, stride-16) NHWC feature pair for multiscale
        RoI pooling.  The stride-8 level is projected here unless
        ``ms_proj_after_pool`` moves the projection after pooling
        (:meth:`pool_multiscale`)."""
        f8, f16 = self.RCNN_base(image.permute(0, 3, 1, 2), return_pyramid=True)
        f8, f16 = f8.permute(0, 2, 3, 1), f16.permute(0, 2, 3, 1)
        if self.cfg.ms_proj_after_pool:
            return f8, f16
        return self._c3_proj(f8), f16

    def pool_multiscale(self, f8_raw: torch.Tensor, f16: torch.Tensor,
                        rois: torch.Tensor) -> torch.Tensor:
        """Level-assigned RoI-Align with the lateral projection applied
        after pooling (``ms_proj_after_pool``).

        A 1x1 projection (W, b) commutes with RoI-Align, except that the
        bias enters scaled by the bilinear weight mass ``wsum`` (1 for
        interior rois, less where border samples drop):
        ``align(proj(f)) = align(f) @ W + b * wsum``.  So the projected
        fine level is ``proj(align(f)) + b * (wsum - 1)``.
        """
        pooled8, wsum = pool_fine_raw(f8_raw, rois, self.cfg)
        proj = self._c3_proj(pooled8)
        bias = self.RCNN_c3_proj.bias.to(self.dtype).float()
        fine = ((wsum[..., None] - 1.0) * bias + proj.float()).to(proj.dtype)
        return pool_rois_multiscale(None, f16, rois, self.cfg,
                                    fine_override=fine)

    def rpn_out(self, feat: torch.Tensor):
        """(B, h, w, C) -> cls logits (B, h, w, A, 2), deltas (B, h, w, A, 4)."""
        return self.RCNN_rpn(feat)

    def roi_head(self, pooled: torch.Tensor, train: bool = False,
                 generator: torch.Generator | None = None):
        """Pooled rois (R, P, P, C) -> (cls_logits (R, classes), bbox_deltas
        (R, 4 or 4 * classes)), both float32.  ``train`` turns on the
        head's dropout (VGG16), drawn from ``generator``."""
        dt = self.dtype
        hidden = self.RCNN_top(pooled, train=train, generator=generator)
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
    """Pool per ``cfg.pooling_mode`` from NHWC features; returns flat
    (R_total, P, P, C) for the RoI head.

    ``rois`` are grouped (B, R, 4), or flat (R, 4) with ``batch_indices``
    (or (R, 5) with the index first).  ``align`` and ``align_legacy`` on
    grouped rois are the two contractions of kernel K2; on flat rois, and
    ``pool`` and ``crop`` always, they are gathers (flat, with the grouped
    rois flattened image-major)."""
    _check_config(cfg)
    p = output_size or cfg.pooling_size
    scale = 1.0 / cfg.feat_stride
    mode = cfg.pooling_mode
    if rois.dim() == 3 and mode in ("align", "align_legacy"):
        if mode == "align_legacy":
            out = roi_align_legacy_grouped(feat, rois, output_size=p,
                                           spatial_scale=scale)
        else:
            out = roi_align_grouped(feat, rois, output_size=p,
                                    spatial_scale=scale,
                                    sampling_ratio=cfg.sampling_ratio)
        return out.reshape((-1,) + tuple(out.shape[2:]))
    if rois.dim() == 3:
        b, r, _ = rois.shape
        batch_indices = torch.arange(b, device=rois.device).repeat_interleave(r)
        rois = rois.reshape(b * r, 4)
    if mode == "align":
        return roi_align(feat, rois, batch_indices, output_size=p,
                         spatial_scale=scale,
                         sampling_ratio=cfg.sampling_ratio)
    op = {"align_legacy": roi_align_legacy, "pool": roi_pool,
          "crop": roi_crop}[mode]
    return op(feat, rois, batch_indices, output_size=p, spatial_scale=scale)


def pool_rois_multiscale(
    f8: torch.Tensor | None,
    f16: torch.Tensor,
    rois: torch.Tensor,
    cfg: ModelConfig,
    *,
    fine_override: torch.Tensor | None = None,
) -> torch.Tensor:
    """FPN-style level-assigned RoI-Align (BASELINE config #5).

    f8 (B, H/8, W/8, C) projected and f16 (B, H/16, W/16, C) NHWC, rois
    (B, R, 4) in image coords.  A roi whose sqrt-area is below
    ``ms_fine_threshold`` pools from the stride-8 level, the others from
    stride 16: both levels are pooled (static shapes) and selected per
    roi.  ``fine_override`` (B, R, P, P, C) supplies the pooled fine level
    (:meth:`FasterRCNN.pool_multiscale`); ``f8`` may then be None.
    Returns flat (B*R, P, P, C), as :func:`pool_rois`.
    """
    wh = (torch.clamp(rois[..., 2] - rois[..., 0], min=0.0)
          * torch.clamp(rois[..., 3] - rois[..., 1], min=0.0))
    fine = torch.sqrt(wh) < cfg.ms_fine_threshold            # (B, R)
    kw = dict(output_size=cfg.pooling_size, sampling_ratio=cfg.sampling_ratio)
    p16 = roi_align_grouped(f16, rois, spatial_scale=1.0 / 16.0, **kw)
    p8 = (fine_override if fine_override is not None else
          roi_align_grouped(f8, rois, spatial_scale=1.0 / 8.0, **kw))
    out = torch.where(fine[..., None, None, None], p8, p16)
    return out.reshape((-1,) + tuple(out.shape[2:]))


def pool_fine_raw(f8: torch.Tensor, rois: torch.Tensor,
                  cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Stride-8 RoI-Align of the unprojected level f8 (B, H/8, W/8, C3),
    and the bilinear weight mass that moves the projection's bias after
    pooling.  Returns (pooled (B, R, P, P, C3), wsum (B, R, P, P) f32);
    one set of axis weights serves both."""
    _, h8, w8, _ = f8.shape
    wy, wx = roi_align_axis_weights(rois, h8, w8,
                                    output_size=cfg.pooling_size,
                                    spatial_scale=1.0 / 8.0,
                                    sampling_ratio=cfg.sampling_ratio)
    wsum = wy.sum(-1)[..., :, None] * wx.sum(-1)[..., None, :]
    return contract_axis_weights(wy, wx, f8), wsum


def init_weights(model: FasterRCNN, generator: torch.Generator,
                 *, input_scale: float = 1.0, he_heads: bool = False) -> None:
    """Seeded random init, in place: the weights of the comparisons
    (``chip_smoke.py``, ``bench_torch.py``).  The trainer, and the CLIs
    without a checkpoint, start from :func:`init_params` instead.

    Convs and the fc head: He-normal (std sqrt(2 / fan_in)), zero bias.
    The first conv is scaled by ``input_scale`` (e.g. 1/64 for raw
    mean-subtracted 0-255 pixels, so activations stay O(1) through the
    ReLU stack).  ``RCNN_cls_score`` / ``RCNN_bbox_pred``: N(0, 0.01) /
    N(0, 0.001) as the reference initialises them, or He-normal with
    ``he_heads`` so that random-weight scores spread out.

    Frozen BatchNorms get near-identity statistics: weight and variance
    uniform in [0.5, 1.5), bias and mean N(0, 0.05).  Each bottleneck's
    ``bn3`` weight is damped by 0.1, as pretrained nets keep the residual
    branch small: with O(1) branches, 33 residual adds grow a ResNet-101's
    activations until rounding swamps any comparison.
    """
    first = True
    for name, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm2d):
            n = mod.weight.shape[0]
            with torch.no_grad():
                mod.weight.copy_(torch.rand(n, generator=generator) + 0.5)
                mod.bias.copy_(torch.randn(n, generator=generator) * 0.05)
                mod.running_mean.copy_(
                    torch.randn(n, generator=generator) * 0.05)
                mod.running_var.copy_(torch.rand(n, generator=generator) + 0.5)
                if name.endswith(".bn3"):
                    mod.weight.mul_(0.1)
            continue
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
            if mod.bias is not None:
                mod.bias.zero_()


# Stddev of a unit normal truncated at +-2: flax's ``lecun_normal``
# divides by it so that the truncated draw keeps variance 1 / fan_in.
_TRUNC2_STD = 0.87962566103423978


def truncated_normal_(weight: torch.Tensor, std: float,
                      generator: torch.Generator) -> None:
    """``weight`` <- N(0, 1) truncated at +-2, times ``std``, in place
    (``jax.nn.initializers.truncated_normal``)."""
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.copy_(w * std)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``, in place: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in (``weight`` laid
    out output first, as conv and linear weights are)."""
    truncated_normal_(weight, math.sqrt(1.0 / weight[0].numel()) / _TRUNC2_STD,
                      generator)


def init_params(model: FasterRCNN, generator: torch.Generator) -> None:
    """The JAX package's ``init_params`` distributions, in place.

    Every conv and linear layer: flax's ``lecun_normal`` (a normal
    truncated at two standard deviations, scaled to variance 1 / fan_in),
    zero bias.  ``RCNN_cls_score`` / ``RCNN_bbox_pred``: N(0, 0.01) /
    N(0, 0.001), truncated at two standard deviations when
    ``model.truncated_init`` is set (``jax.nn.initializers.
    truncated_normal``).  Frozen BatchNorms: weight 1, bias 0, mean 0,
    variance 1.  The draws are this generator's, not JAX's.
    """
    heads = {"RCNN_cls_score": 0.01, "RCNN_bbox_pred": 0.001}
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, FrozenBatchNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
                continue
            if not isinstance(mod, (nn.Conv2d, nn.Linear)):
                continue
            if name not in heads:
                lecun_normal_(mod.weight, generator)
            elif model.cfg.truncated_init:
                truncated_normal_(mod.weight, heads[name], generator)
            else:
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator) * heads[name])
            if mod.bias is not None:
                mod.bias.zero_()


def empty_model(cfg: ModelConfig, num_anchors: int = 9, *,
                device: torch.device | str = "cpu") -> FasterRCNN:
    """FasterRCNN on ``device`` laid out as :func:`build_model` lays it
    out, its parameters and buffers allocated but not set: for a caller
    that loads a whole state dict or calls :func:`init_params` next."""
    with torch.device("meta"):
        model = FasterRCNN(cfg, num_anchors)
    return model.to_empty(device=device).to(
        memory_format=torch.channels_last).eval()


def build_model(cfg: ModelConfig, num_anchors: int = 9, *,
                generator: torch.Generator | None = None,
                device: torch.device | str = "cpu") -> FasterRCNN:
    """FasterRCNN on ``device`` in ``torch.channels_last``, in eval mode,
    initialised by :func:`init_weights` from ``generator`` (seed 0 when
    None)."""
    model = FasterRCNN(cfg, num_anchors)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(device=device, memory_format=torch.channels_last).eval()

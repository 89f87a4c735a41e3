"""Feature Pyramid Network (Lin et al., CVPR 2017, arXiv:1612.03144) on a
ResNet trunk, as Detectron's ``e2e_faster_rcnn_R-101-FPN_1x`` builds it.
The JAX package has no FPN; this is the port's own architecture, chosen
by the backbone names ``resnet50_fpn``, ``resnet101_fpn`` and
``resnet152_fpn``.  :class:`~scda_tpu_torch.models.faster_rcnn.
FasterRCNN` builds it from the pieces here and runs its levels and its
pooling.

* The trunk is :class:`~scda_tpu_torch.models.backbones.resnet.
  ResNetBackbone` with layer4 (``RCNN_base.7``), whose identity tails run
  through kernel K4 as every stage's do; it gives C2 .. C5.
* The pyramid (:class:`FPN`, ``RCNN_fpn``): a 1x1 lateral conv to
  :data:`FPN_DIM` channels on each of C2 .. C5, the top-down path by
  nearest 2x upsampling and an add, a 3x3 output conv on each sum, and P6
  as P5 subsampled with stride 2 (Detectron's kernel-1 max pool), which
  only the RPN reads.
* The RPN: one head (``RCNN_rpn``) shared by P2 .. P6, with anchors at
  each level's stride and of that base size (``models.rpn.anchor_grid``);
  each level's proposals are one call of the proposal layer, then
  :func:`collect` keeps the top ``post_nms_top_n`` of every level by
  score, per image.
* RoI-Align from the level :func:`roi_levels` assigns each roi
  (:func:`pool_levels`, through kernel K2), then :class:`MLPHead`, two
  fully connected layers of :data:`MLP_HEAD_DIM` (``RCNN_top.fc6``,
  ``.fc7``), in place of layer4.

Maps are NHWC views of ``channels_last`` tensors, as elsewhere in the
port.  Everything here is fixed-size and stays on the device; the one
host read is the per-level roi count that the ``scda.roi.level`` span
carries, taken only while a profiler records.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scda_tpu_torch.core import boxes as box_ops
from scda_tpu_torch.models.rpn import Proposals
from scda_tpu_torch.ops.roi_ops import roi_align_grouped
from scda_tpu_torch.utils.profile import span, span_ids

FPN_DIM = 256                      # Detectron FPN.DIM
MLP_HEAD_DIM = 1024                # Detectron FAST_RCNN.MLP_HEAD_DIM
TRUNK_CHANNELS = (256, 512, 1024, 2048)   # C2 .. C5
RPN_LEVELS = (2, 3, 4, 5, 6)       # P2 .. P6, strides 4 .. 64
ROI_LEVELS = (2, 3, 4, 5)          # P2 .. P5
ROI_CANONICAL_SCALE = 224.0        # Detectron FPN.ROI_CANONICAL_SCALE
ROI_CANONICAL_LEVEL = 4            # Detectron FPN.ROI_CANONICAL_LEVEL
# Image coordinates of the box a level's K2 call gets for a roi of another
# level: far outside any map, so that RoI-Align drops all its samples.
NOWHERE = -1.0e6


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of NCHW ``x`` (``channels_last``), by a
    broadcast whose backward is a plain sum."""
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1)[:, :, None, :, None, :]
    y = y.expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
    return y.permute(0, 3, 1, 2)


class FPN(nn.Module):
    """Laterals (``inner_blocks``), output convs (``layer_blocks``), P6."""

    def __init__(self, in_channels: Sequence[int] = TRUNK_CHANNELS,
                 dim: int = FPN_DIM, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.inner_blocks = nn.ModuleList(nn.Conv2d(c, dim, 1)
                                          for c in in_channels)
        self.layer_blocks = nn.ModuleList(nn.Conv2d(dim, dim, 3, padding=1)
                                          for _ in in_channels)
        self.dtype = dtype

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                        padding=conv.padding)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """C2 .. C5 (NCHW) -> P2 .. P6, NHWC."""
        inner = self._conv(self.inner_blocks[-1], feats[-1])
        outs = [self._conv(self.layer_blocks[-1], inner)]
        for i in range(len(feats) - 2, -1, -1):
            lateral = self._conv(self.inner_blocks[i], feats[i])
            h, w = lateral.shape[2:]
            inner = lateral + upsample2(inner)[:, :, :h, :w]
            outs.insert(0, self._conv(self.layer_blocks[i], inner))
        outs.append(outs[-1][:, :, ::2, ::2])
        return [o.permute(0, 2, 3, 1) for o in outs]


class MLPHead(nn.Module):
    """fc6 and fc7 with ReLUs over the pooled rois flattened (C, P, P) as
    Detectron flattens them; no dropout."""

    def __init__(self, in_dim: int, dim: int = MLP_HEAD_DIM,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc6 = nn.Linear(in_dim, dim)
        self.fc7 = nn.Linear(dim, dim)
        self.out_dim = dim
        self.dtype = dtype

    def forward(self, pooled: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """pooled (R, P, P, C) NHWC -> (R, dim).  ``train`` and
        ``generator`` change nothing."""
        dt = self.dtype
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1).to(dt)
        for fc in (self.fc6, self.fc7):
            x = F.relu(F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))
        return x


def collect(level_props: Sequence[Proposals], top_n: int) -> Proposals:
    """The top ``top_n`` proposals of all levels by score, per image:
    invalid slots last, ties to the lower level, then the lower slot (a
    stable sort over the levels laid end to end)."""
    valid = torch.cat([p.valid for p in level_props], dim=1)
    scores = torch.cat([p.scores for p in level_props], dim=1)
    boxes = torch.cat([p.boxes for p in level_props], dim=1)
    keyed = torch.where(valid, scores, torch.full_like(scores, -1.0))
    n = min(top_n, keyed.shape[1])
    _, idx = torch.sort(keyed, dim=-1, descending=True, stable=True)
    idx = idx[:, :n]
    v = torch.gather(valid, 1, idx)
    s = torch.gather(scores, 1, idx)
    b = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return Proposals(boxes=torch.where(v[..., None], b, torch.zeros_like(b)),
                     scores=torch.where(v, s, torch.zeros_like(s)), valid=v)


def roi_levels(rois: torch.Tensor) -> torch.Tensor:
    """Each roi's pyramid level, Detectron's rule in f32:
    clamp(floor(4 + log2(sqrt(area) / 224 + 1e-6)), 2, 5), the area with
    the legacy +1 widths."""
    r = rois.float()
    w = torch.clamp(r[..., 2] - r[..., 0] + box_ops.LEGACY_PLUS_ONE, min=0.0)
    h = torch.clamp(r[..., 3] - r[..., 1] + box_ops.LEGACY_PLUS_ONE, min=0.0)
    s = torch.sqrt(w * h)
    lvl = torch.floor(ROI_CANONICAL_LEVEL
                      + torch.log2(s / ROI_CANONICAL_SCALE + 1e-6))
    return torch.clamp(lvl, ROI_LEVELS[0], ROI_LEVELS[-1]).long()


def pool_levels(pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
                mc) -> torch.Tensor:
    """RoI-Align of grouped rois (B, R, 4) from P2 .. P5 (NHWC), each roi
    from the level :func:`roi_levels` gives it: flat (B * R, P, P, C).

    One K2 call a level over every slot: a slot of another level pools
    there a box outside the map (:data:`NOWHERE`), every sample of which
    drops, so that the kernel's forward and backward pass it by (a box
    on the map would cost its taps, and its zero cotangent the tiles it
    covers), and its output is not taken."""
    lvl = roi_levels(rois)
    counts = ([int(n) for n in torch.stack(
        [(lvl == k).sum() for k in ROI_LEVELS]).tolist()]
        if span_ids() is not None else [None] * len(ROI_LEVELS))
    out = None
    for feat, k, count in zip(pyramid, ROI_LEVELS, counts):
        with span("roi.level", level=k, rois=count):
            mine = lvl == k
            pooled = roi_align_grouped(
                feat, torch.where(mine[..., None], rois,
                                  torch.full_like(rois, NOWHERE)),
                output_size=mc.pooling_size, spatial_scale=1.0 / 2 ** k,
                sampling_ratio=mc.sampling_ratio)
            out = (pooled if out is None
                   else torch.where(mine[..., None, None, None], pooled, out))
    return out.reshape((-1,) + tuple(out.shape[2:]))


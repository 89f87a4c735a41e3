"""ResNet-50/101/152 backbone and C4 head (port of
``scda_tpu/models/backbones/resnet.py``), with frozen BatchNorm.

Modules follow the reference lineage's state-dict layout, which
``scda_tpu/train/torch_convert.py:export_reference_detector`` writes:
``RCNN_base.0`` conv1, ``.1`` bn1, ``.4/.5/.6`` layer1..3 (each a
Sequential of :class:`Bottleneck`), ``RCNN_top.0.{b}`` layer4.  Every
BatchNorm is a :class:`FrozenBatchNorm2d` (the reference keeps all of
them in eval mode), whose state dict has exactly ``weight``, ``bias``,
``running_mean`` and ``running_var``.

Modules run NCHW in ``torch.channels_last``.  In a stage, block0 (strided,
with the downsample) runs per block through ``F.conv2d``; the identity
tail runs as one call of kernel K4
(:func:`scda_tpu_torch.ops.kernels.bottleneck_kernel.bottleneck_chain`)
over the folded weights.  The layer4 head stays per block, as in JAX;
``model.head_matmul`` only changes how XLA lowers it, and the port
ignores it.

Training: conv1 and the first ``resnet_fixed_blocks`` stages are frozen
(:func:`resnet_frozen_param_paths`); every ``FrozenBatchNorm2d`` holds
buffers, never parameters, so none of them trains.  The fold is
differentiable in the conv weights and K4's ``autograd.Function`` carries
the gradient through the identity tails.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scda_tpu_torch.ops.kernels.bottleneck_kernel import (
    bn_root, bottleneck_chain, fold_bottleneck_params,
)

RESNET_DEPTHS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def resnet_frozen_param_paths(fixed_blocks: int = 1):
    """Module prefixes of the frozen parameters: conv1/bn1 always, then
    layer1 .. layer``fixed_blocks`` (at most 3), as JAX
    ``resnet.py:329``."""
    paths = ["RCNN_base.0", "RCNN_base.1"]
    for i in range(1, min(max(fixed_blocks, 0), 3) + 1):
        paths.append(f"RCNN_base.{i + 3}")
    return tuple(paths)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with constant statistics and affine, as buffers.

    The JAX arithmetic: ``mult`` and ``add`` computed in f32, cast to the
    input's dtype, then ``x * mult + add`` in that dtype.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        root = bn_root(self.running_var, self.eps)
        mult = self.weight / root
        add = self.bias - self.running_mean * self.weight / root
        shape = (1, -1, 1, 1)
        return x * mult.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck, expansion 4, torchvision layout:
    the stride on conv2 and a "B" (1x1 conv + BN) downsample."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(features)
        self.conv3 = nn.Conv2d(features, 4 * features, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(4 * features)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, 4 * features, 1, stride=stride, bias=False),
            FrozenBatchNorm2d(4 * features)) if downsample else None)
        self.stride = stride
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        out = F.relu(self.bn1(F.conv2d(x, self.conv1.weight.to(dt))))
        out = F.relu(self.bn2(F.conv2d(out, self.conv2.weight.to(dt),
                                       stride=self.stride, padding=1)))
        out = self.bn3(F.conv2d(out, self.conv3.weight.to(dt)))
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn(F.conv2d(x, conv.weight.to(dt), stride=self.stride))
        return F.relu(out + residual)


def _stage_blocks(in_channels, features, blocks, stride, dtype):
    """block0 (strided, downsample) + ``blocks - 1`` identity bottlenecks."""
    return [Bottleneck(in_channels, features, stride, downsample=True,
                       dtype=dtype)] + [
        Bottleneck(4 * features, features, dtype=dtype)
        for _ in range(1, blocks)]


class ResNetStage(nn.Sequential):
    """A backbone stage: block0 per block, then the identity tail as one
    K4 call over the folded weights."""

    def __init__(self, in_channels: int, features: int, blocks: int,
                 stride: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(*_stage_blocks(in_channels, features, blocks,
                                        stride, dtype))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x)
        if len(self) == 1:
            return x
        folded = fold_bottleneck_params(list(self)[1:])
        y = bottleneck_chain(x.permute(0, 2, 3, 1), *folded, dtype=self.dtype)
        return y.permute(0, 3, 1, 2)


class ResNetBackbone(nn.Sequential):
    """conv1 .. layer3: (B, 3, H, W) -> (B, 1024, H/16, W/16); with
    ``layer4`` (the FPN trunk) layer4 follows as ``RCNN_base.7``, and
    :meth:`levels` gives C2 .. C5."""

    def __init__(self, depth: int = 101, dtype: torch.dtype = torch.bfloat16,
                 layer4: bool = False):
        blocks = RESNET_DEPTHS[depth]
        stages = [ResNetStage(64, 64, blocks[0], 1, dtype),
                  ResNetStage(256, 128, blocks[1], 2, dtype),
                  ResNetStage(512, 256, blocks[2], 2, dtype)]
        if layer4:
            stages.append(ResNetStage(1024, 512, blocks[3], 2, dtype))
        super().__init__(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            FrozenBatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1), *stages)
        self.dtype = dtype

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        x = F.conv2d(x, self[0].weight.to(dt), stride=2, padding=3)
        return F.max_pool2d(F.relu(self[1](x)), 3, 2, padding=1)

    def forward(self, x: torch.Tensor, return_pyramid: bool = False):
        """With ``return_pyramid``, (layer2's stride-8 map (512 channels),
        layer3's stride-16 map)."""
        f8 = self[5](self[4](self._stem(x)))
        x = self[6](f8)
        return (f8, x) if return_pyramid else x

    def levels(self, x: torch.Tensor):
        """C2 .. C5: layer1 .. layer4's maps (256, 512, 1024, 2048 channels
        at strides 4 .. 32), NCHW in ``channels_last``."""
        out = [self[4](self._stem(x))]
        for stage in list(self)[5:]:
            out.append(stage(out[-1]))
        return out


class ResNetC4Head(nn.Sequential):
    """layer4 on the pooled rois, per block, then the mean over H and W
    (the reference's ``_head_to_tail``)."""

    out_dim = 2048

    def __init__(self, depth: int = 101, dtype: torch.dtype = torch.bfloat16):
        blocks = RESNET_DEPTHS[depth]
        super().__init__(nn.Sequential(
            *_stage_blocks(1024, 512, blocks[3], 2, dtype)))
        self.dtype = dtype

    def forward(self, pooled: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """pooled (R, P, P, 1024) NHWC -> (R, 2048).  No dropout: ``train``
        and ``generator`` change nothing."""
        x = pooled.permute(0, 3, 1, 2).to(self.dtype)
        x = self[0](x.contiguous(memory_format=torch.channels_last))
        return x.mean(dim=(2, 3))

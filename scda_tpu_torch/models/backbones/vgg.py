"""VGG16 backbone and head (port of ``scda_tpu/models/backbones/vgg.py``).

Both are ``nn.Sequential`` laid out as the reference lineage's modules,
so a reference state dict loads unchanged: the backbone is torchvision
VGG16 ``features[:-1]`` (``RCNN_base.N``, convs at 0, 2, 5, ... 28), the
head ``classifier[:-1]`` (``RCNN_top.0`` fc6, ``RCNN_top.3`` fc7).

They run NCHW in ``torch.channels_last``.  Weights may be float32 or
bfloat16; each forward casts them to the compute dtype.  The stem
(conv1_1, conv1_2, pool1) goes through kernel K3; conv3 .. conv5_3 are
``F.conv2d`` (cuDNN on the card), as XLA ran them outside Pallas.

Training: conv1/conv2 are frozen (:func:`vgg_frozen_param_paths`, the
reference's "fix the layers before conv3"); K3 has no backward, and on
the card its wrapper refuses inputs that require grad.  Pools 2-4
are :class:`MaxPool2x2`, whose backward splits the cotangent evenly among
tied maxima as the JAX ``max_pool_2x2`` does.  The head's dropout draws
from the train step's own ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scda_tpu_torch.core.draws import uniform
from scda_tpu_torch.ops.kernels.stem_kernel import vgg_stem_fused

# (torch index, channels) per conv, "M" per maxpool: torchvision VGG16
# features without its final pool.
VGG16_LAYOUT = (
    (0, 64), (2, 64), "M",
    (5, 128), (7, 128), "M",
    (10, 256), (12, 256), (14, 256), "M",
    (17, 512), (19, 512), (21, 512), "M",
    (24, 512), (26, 512), (28, 512),
)

# Torch indices of conv1_1 .. conv2_2, frozen in the reference (JAX
# ``vgg.py:_FROZEN_TORCH_IDX``).
_FROZEN_TORCH_IDX = (0, 2, 5, 7)


def vgg_frozen_param_paths():
    """Module prefixes of the parameters that stay frozen."""
    return tuple(f"RCNN_base.{i}" for i in _FROZEN_TORCH_IDX)


class MaxPool2x2(torch.autograd.Function):
    """2x2/stride-2 max pool on NCHW x (even H and W).  The backward is
    JAX ``max_pool_2x2``'s: the cotangent splits evenly among the tied
    maxima of a window.  ``F.max_pool2d`` routes it to one of them, and
    in bf16 ties are common."""

    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x, 2, 2)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        up = lambda t: t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        is_max = (x == up(y)).to(g.dtype)
        ties = F.avg_pool2d(is_max, 2, 2) * 4.0
        return is_max * up(g / ties)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return MaxPool2x2.apply(x)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout`` semantics: keep with probability 1 - rate,
    scale the kept by 1 / (1 - rate); the uniforms come from
    ``generator``, drawn on its device."""
    keep = 1.0 - rate
    u = uniform(generator, x.shape)
    return torch.where(u.to(x.device) < keep, x / keep, torch.zeros_like(x))


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


class VGG16Backbone(nn.Sequential):
    """conv1_1 .. conv5_3: (B, 3, H, W) -> (B, 512, H/16, W/16)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        layers = []
        in_ch = 3
        for item in VGG16_LAYOUT:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                _, ch = item
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU()]
                in_ch = ch
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, return_pyramid: bool = False):
        """With ``return_pyramid``, (conv4_3's stride-8 map, conv5_3's)."""
        dt = self.dtype
        x = x.contiguous(memory_format=torch.channels_last)
        conv1_1, conv1_2 = self[0], self[2]
        y = vgg_stem_fused(x.permute(0, 2, 3, 1), _hwio(conv1_1), conv1_1.bias,
                           _hwio(conv1_2), conv1_2.bias, dtype=dt)
        x = y.permute(0, 3, 1, 2)
        pools, f8 = 1, None
        for layer in list(self)[5:]:  # after conv1_1, relu, conv1_2, relu, pool1
            if isinstance(layer, nn.Conv2d):
                x = F.conv2d(x, layer.weight.to(dt), layer.bias.to(dt),
                             padding=1)
            elif isinstance(layer, nn.ReLU):
                x = F.relu(x)
            else:
                if pools == 3:
                    f8 = x
                x = max_pool_2x2(x)
                pools += 1
        return (f8, x) if return_pyramid else x


class VGG16Head(nn.Sequential):
    """fc6 / fc7 per-RoI head; dropout (rate 0.5) only when ``train``."""

    def __init__(self, in_features: int = 512 * 7 * 7,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(
            nn.Linear(in_features, 4096), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(0.5),
        )
        self.dtype = dtype

    out_dim = 4096

    def forward(self, pooled: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """pooled (R, P, P, C) NHWC, flattened in torch CHW order so fc6
        keeps the reference's meaning.  With ``train``, dropout draws from
        ``generator``, which must then be given."""
        if train and generator is None:
            raise ValueError("VGG16Head: train=True needs the step's "
                             "dropout generator")
        dt = self.dtype
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1).to(dt)
        for fc in (self[0], self[3]):
            x = F.relu(F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))
            if train:
                x = dropout(x, 0.5, generator)
        return x

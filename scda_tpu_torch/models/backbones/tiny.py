"""Tiny CNN backbone and head for tests and CPU smoke runs (port of
``scda_tpu/models/backbones/tiny.py``): stride 16, four conv + relu +
pool stages.  Module indices follow the reference naming scheme:
``RCNN_base.{0,3,6,9}`` are the convs, ``RCNN_top.0`` the fc."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class TinyBackbone(nn.Sequential):
    """(B, 3, H, W) -> (B, channels, H/16, W/16)."""

    def __init__(self, channels: int = 64, dtype: torch.dtype = torch.float32):
        layers = []
        in_ch = 3
        for ch in (16, 32, 48, channels):
            layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU(),
                       nn.MaxPool2d(2, 2)]
            in_ch = ch
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, return_pyramid: bool = False):
        """With ``return_pyramid``, (the stride-8 map, the stride-16 map)."""
        dt = self.dtype
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        f8 = None
        for i, conv in enumerate(list(self)[0::3]):
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
            x = F.max_pool2d(F.relu(x), 2, 2)
            if i == 2:
                f8 = x
        return (f8, x) if return_pyramid else x


class TinyHead(nn.Sequential):
    """One fc + relu over pooled rois flattened in NHWC order, as the JAX
    ``TinyHead`` flattens them (``VGG16Head`` uses CHW)."""

    def __init__(self, in_features: int, features: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Linear(in_features, features), nn.ReLU())
        self.dtype = dtype
        self.out_dim = features

    def forward(self, pooled: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """No dropout: ``train`` and ``generator`` change nothing."""
        dt = self.dtype
        x = pooled.reshape(pooled.shape[0], -1).to(dt)
        fc = self[0]
        return F.relu(F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))

"""SCDA patch discriminator (port of ``scda_tpu/models/discriminator.py``):
a small conv stack over pooled region patches, one domain logit per
patch.  The detector receives its adversarial gradient through the
gradient-reversal layer on the discriminator's *input*
(:mod:`scda_tpu_torch.adapt.scda`).

Three 3x3 convs (the second at stride 2; all with an explicit padding
of 1, not ``SAME``), leaky-relu 0.2 after each, a spatial mean and one
linear layer.  Patches come in NHWC, as ``pool_rois`` gives them; the
parameters and the logits are float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scda_tpu_torch.models.faster_rcnn import lecun_normal_


class PatchDiscriminator(nn.Module):
    def __init__(self, in_channels: int, channels: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, padding=1)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
        self.conv3 = nn.Conv2d(channels, channels, 3, padding=1)
        self.fc = nn.Linear(channels, 1)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        """patches (R, P, P, C) -> domain logits (R,) float32."""
        x = patches.float().permute(0, 3, 1, 2)
        x = F.leaky_relu(self.conv1(x), 0.2)
        x = F.leaky_relu(self.conv2(x), 0.2)
        x = F.leaky_relu(self.conv3(x), 0.2)
        return self.fc(x.mean(dim=(2, 3)))[..., 0]


def init_discriminator_weights(d_model: PatchDiscriminator,
                               generator: torch.Generator) -> None:
    """Seeded init, in place: weights N(0, 1 / fan_in) truncated at two
    standard deviations (flax's ``lecun_normal`` default), zero biases."""
    with torch.no_grad():
        for mod in (d_model.conv1, d_model.conv2, d_model.conv3, d_model.fc):
            lecun_normal_(mod.weight, generator)
            mod.bias.zero_()

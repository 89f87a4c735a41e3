"""The benchmark's weights, made on the device from the seed in two large
draws (one normal, one uniform) and cut into tensors.

Distributions of ``scda_tpu_torch/models/faster_rcnn.py:init_weights``:
convolutions and linear layers He-normal (std sqrt(2 / fan_in)) with zero
biases, the first convolution scaled by 1/64 for 0-255 pixels; the
classifier and box heads N(0, 0.01) / N(0, 0.001) for training, or
He-normal for serving, so that random-weight scores spread out and
are not near ties; frozen batch norms with weight and variance uniform in
[0.5, 1.5), bias and mean N(0, 0.05), each bottleneck's ``bn3`` weight
damped by 0.1.  The discriminator: N(0, 1 / fan_in) truncated at two
standard deviations (``init_discriminator_weights``' distribution),
zero biases.  Both sides of the output check receive these tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

_TRUNC2_STD = 0.87962566103423978


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


# The first convolution's scale for raw mean-subtracted 0-255 pixels.
INPUT_SCALE = 1.0 / 64


def make(layout: List[tuple], generator: torch.Generator, *,
         he_heads: bool) -> Dict[str, torch.Tensor]:
    """float32 tensors on the generator's device for ``layout`` (see
    ``program.model_layout``)."""
    dev = generator.device
    n_normal = sum(_numel(s) for _, s, role, _ in layout
                   if role in ("weight", "bn_bias", "bn_running_mean"))
    n_uniform = sum(_numel(s) for _, s, role, _ in layout
                    if role in ("bn_weight", "bn_running_var"))
    normal = torch.randn(n_normal, generator=generator, device=dev)
    uniform = torch.rand(max(n_uniform, 1), generator=generator, device=dev)
    out: Dict[str, torch.Tensor] = {}
    i = j = 0
    first = True
    for key, shape, role, module in layout:
        n = _numel(shape)
        if role == "weight":
            std = math.sqrt(2.0 / (n // shape[0]))
            if module == "RCNN_cls_score" and not he_heads:
                std = 0.01
            elif module == "RCNN_bbox_pred" and not he_heads:
                std = 0.001
            if first:
                std *= INPUT_SCALE
                first = False
            out[key] = normal[i:i + n].view(shape) * std
            i += n
        elif role == "bias":
            out[key] = torch.zeros(shape, device=dev)
        elif role in ("bn_bias", "bn_running_mean"):
            out[key] = normal[i:i + n].view(shape) * 0.05
            i += n
        else:
            t = uniform[j:j + n].view(shape) + 0.5
            if role == "bn_weight" and module.endswith(".bn3"):
                t = t * 0.1
            out[key] = t
            j += n
    return {k: v.contiguous() for k, v in out.items()}


def make_discriminator(layout: List[tuple],
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
    dev = generator.device
    out = {}
    for key, shape, role, _ in layout:
        if role == "bias":
            out[key] = torch.zeros(shape, device=dev)
            continue
        w = torch.empty(shape, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        out[key] = w * (math.sqrt(1.0 / (_numel(shape) // shape[0])) / _TRUNC2_STD)
    return out

"""Gradient reversal layer (port of ``scda_tpu/core/grad_reverse.py``).

One ``torch.autograd.Function`` with the identity as its forward and
``-scale * grad`` as its backward: the discriminator descends on its
loss while the detector, upstream of the layer, ascends.
"""

from __future__ import annotations

import torch


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


def grad_reverse(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Identity forward; gradient multiplied by ``-scale`` on the way back."""
    return _GradReverse.apply(x, float(scale))


def scaled_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward, gradient multiplied by ``scale`` (no flip)."""
    return grad_reverse(x, -scale)

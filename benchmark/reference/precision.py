"""The precision the reference computes its products in.

``F32`` is the reference itself: every convolution and matrix product in
float32 with TF32 off (the caller's process settings; :func:`check_f32`
refuses to run otherwise).  The others are controls of the output check,
the same arithmetic with the operands of every convolution and matrix
product rounded, accumulated in float32, in the forward pass and in the
backward pass each:

* ``FP8``: float8 e4m3 operands under a per-tensor scale (the tensor's
  largest magnitude maps to 448, e4m3's largest finite value), e5m2
  cotangents; the step below the bfloat16 the configurations state;
* ``BF16``: bfloat16 operands and cotangents, forward and backward;
* ``FP8_BWD``: a bfloat16 forward and an fp8 backward (e4m3 operands,
  e5m2 cotangents).

Each rounding is a straight-through estimator.  Where the backward
rounds otherwise than the forward, a product is computed twice: the
forward's value, and the backward's rounded operands that autograd
differentiates.
"""

from __future__ import annotations

from typing import Callable

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
KINDS = ("f32", "bf16", "fp8")


def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn,
              top: float = E4M3_MAX) -> torch.Tensor:
    """``x`` rounded to an fp8 type under a per-tensor scale, back in
    float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x.detach() * scale).to(dtype).float() / scale


def _operand(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "f32":
        return x
    r = x.detach().bfloat16().float() if kind == "bf16" else fp8_round(x)
    return x + (r - x).detach()


def _cotangent(g: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bf16":
        return g.float().bfloat16().float().to(g.dtype)
    return fp8_round(g.float(), torch.float8_e5m2, E5M2_MAX).to(g.dtype)


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, kind):
        ctx.kind = kind
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _cotangent(g, ctx.kind), None


class Precision:
    def __init__(self, name: str, forward: str, backward: str):
        if forward not in KINDS or backward not in KINDS:
            raise ValueError(f"unknown reference precision {name!r}")
        self.name, self.forward, self.backward = name, forward, backward

    def product(self, fn: Callable, x: torch.Tensor, w: torch.Tensor,
                *rest) -> torch.Tensor:
        """``fn(x, w, *rest)`` with its operands and its cotangent as this
        precision rounds them."""
        x, w = x.float(), w.float()
        y = fn(_operand(x, self.forward), _operand(w, self.forward), *rest)
        if self.backward != self.forward:
            yb = fn(_operand(x, self.backward), _operand(w, self.backward), *rest)
            y = yb + (y - yb).detach()
        if self.backward == "f32":
            return y
        return _RoundGrad.apply(y, self.backward)

    def __repr__(self) -> str:
        return f"Precision({self.name!r})"


F32 = Precision("f32", "f32", "f32")
FP8 = Precision("fp8", "fp8", "fp8")
BF16 = Precision("bf16", "bf16", "bf16")
FP8_BWD = Precision("fp8_bwd", "bf16", "fp8")
BY_NAME = {p.name: p for p in (F32, FP8, BF16, FP8_BWD)}


def check_f32() -> None:
    """The reference's products must be float32: refuse TF32."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("the reference runs with TF32 off: set "
                           "torch.backends.cuda.matmul.allow_tf32 and "
                           "torch.backends.cudnn.allow_tf32 to False")

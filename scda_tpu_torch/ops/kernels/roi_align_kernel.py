"""RoI-Align double contraction: CUDA kernel K2, forward and backward, with
plain twins and the ``autograd.Function`` that joins them.

Replaces ``scda_tpu/ops/pallas/roi_align_kernel.py:roi_align_contract``:

    out[b,r,p,q,c] = sum_w wx[b,r,q,w] * sum_h wy[b,r,p,h] * feat[b,h,w,c]

The axis weights (``scda_tpu_torch.ops.roi_ops``) carry every sampling
mode, so one kernel serves align, adaptive and align_legacy.  The kernel,
``csrc/roi_align.cu``, exploits what the TPU's dense matmuls could not:
each weight row has at most 2*S nonzero taps.  One block per (b, r) and
channel slice compacts the taps of the roi's 2*P rows once, in shared
memory; a thread then owns 16 bytes of channels (8 bf16 or 4 f32) of one
bin and, where no row of the roi has more than 4 taps, sends its up to
16 tap loads back to back from unrolled loops.  A roi with a longer row
(adaptive sampling, dense weights) takes general loops over the same
lists and stays exact; a channel count that is no multiple of the vector
runs at one channel per thread.  On the H100 the forward is bound by the
latency of those loads from L2, not by bytes.

The backward is JAX's ``_contract_bwd`` (two einsums there, no Pallas
call): ``dfeat = sum_{r,p,q} wy * wx * g``, in f32, cast once to the
features' dtype.  Its kernel (same file) adds into an f32 ``dfeat`` with
atomics, whose bytes through L2 are what bounds it, so it sends few: a
block per (b, r) and 64-channel slice stages its slice of ``g`` in shared
memory, lists the pixels the roi touches with the bins that reach each,
sums a pixel's contributions in registers and adds them once, four
channels per ``atomicAdd`` on ``float4``.  The order of the f32 adds
across rois, and so the rounding of ``dfeat``,
varies from run to run on the card: it is held to its twin with a
tolerance, never bit for bit.  The weights get no gradient (zero
cotangents in JAX: they come from stop-gradient boxes); asking for one
raises.

:func:`roi_align_contract` is the differentiable entry point.  The ctypes
wrappers below it refuse inputs that require grad while grad mode is on,
so no caller can get a detached output by going around it.
"""

from __future__ import annotations

import ctypes

import torch

from scda_tpu_torch.ops.kernels import _build


def roi_align_contract_plain(wy: torch.Tensor, wx: torch.Tensor,
                             features: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the forward: the two einsums, h first as the
    TPU kernel contracts, in float32."""
    tmp = torch.einsum("brph,bhwc->brpwc", wy.float(), features.float())
    return torch.einsum("brqw,brpwc->brpqc", wx.float(), tmp)


def roi_align_contract_bwd_plain(wy: torch.Tensor, wx: torch.Tensor,
                                 g: torch.Tensor,
                                 dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """Plain PyTorch twin of the backward, JAX's ``_contract_bwd``:
    (B, R, P, P, C) cotangent -> dfeat (B, H, W, C) summed in f32 through
    the (B, R, P, W, C) intermediate, cast to ``dtype``."""
    tmp = torch.einsum("brqw,brpqc->brpwc", wx.float(), g.float())
    return torch.einsum("brph,brpwc->bhwc", wy.float(), tmp).to(dtype)


_USE_AUTOGRAD = ("call roi_align_contract, whose autograd.Function has the "
                 "backward kernel")


def _check_cuda(name: str, tensors) -> None:
    dev = tensors[0][1].device
    for t_name, t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: {t_name} on {t.device}; all inputs "
                             f"must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.dtype != torch.float32 and t_name != "features":
            raise TypeError(f"{name}: {t_name} must be float32")


def _shapes(name, wy, wx, b, h, w):
    _, r, p, _ = wy.shape
    if wy.shape != (b, r, p, h) or wx.shape != (b, r, p, w):
        raise ValueError(f"{name}: wy {tuple(wy.shape)} / wx "
                         f"{tuple(wx.shape)} do not match the map "
                         f"(B={b}, H={h}, W={w})")
    return r, p


def roi_align_contract_fwd(wy: torch.Tensor, wx: torch.Tensor,
                           features: torch.Tensor) -> torch.Tensor:
    """The forward alone: wy (B, R, P, H) f32, wx (B, R, P, W) f32,
    features (B, H, W, C) f32 or bf16 -> (B, R, P, P, C) float32.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    _build.refuse_grad("roi_align_contract_fwd", (wy, wx, features),
                       _USE_AUTOGRAD)
    if features.device.type == "cpu":
        return roi_align_contract_plain(wy, wx, features)
    name = "roi_align_contract_fwd"
    _check_cuda(name, [("features", features), ("wy", wy), ("wx", wx)])
    if features.dtype == torch.float32:
        fn_name = "scda_roi_align_contract_f32"
    elif features.dtype == torch.bfloat16:
        fn_name = "scda_roi_align_contract_bf16"
    else:
        raise TypeError(f"{name}: features must be float32 or bfloat16, "
                        f"got {features.dtype}")
    b, h, w, c = features.shape
    r, p = _shapes(name, wy, wx, b, h, w)

    out = torch.empty((b, r, p, p, c), dtype=torch.float32,
                      device=features.device)
    fn = _build.function(fn_name, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
    with torch.cuda.device(features.device):
        rc = fn(wy.data_ptr(), wx.data_ptr(), features.data_ptr(),
                out.data_ptr(), b, r, p, h, w, c,
                _build.stream_ptr(features.device))
    _build.check(rc, fn_name)
    roi_align_contract.launches += 1
    return out


def roi_align_contract_bwd(wy: torch.Tensor, wx: torch.Tensor,
                           g: torch.Tensor, height: int, width: int,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dfeat (B, height, width, C) in ``dtype`` from the cotangent g
    (B, R, P, P, C) of :func:`roi_align_contract_fwd`'s output.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel into an
    f32 buffer, cast once."""
    _build.refuse_grad("roi_align_contract_bwd", (wy, wx, g), _USE_AUTOGRAD)
    if g.device.type == "cpu":
        return roi_align_contract_bwd_plain(wy, wx, g, dtype)
    name = "roi_align_contract_bwd"
    _check_cuda(name, [("g", g), ("wy", wy), ("wx", wx)])
    b, r, p, q, c = g.shape
    if q != p or _shapes(name, wy, wx, b, height, width) != (r, p):
        raise ValueError(f"{name}: g {tuple(g.shape)} does not match wy "
                         f"{tuple(wy.shape)}")

    dfeat = torch.zeros((b, height, width, c), dtype=torch.float32,
                        device=g.device)
    fn = _build.function("scda_roi_align_contract_bwd",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
    with torch.cuda.device(g.device):
        rc = fn(wy.data_ptr(), wx.data_ptr(), g.data_ptr(), dfeat.data_ptr(),
                b, r, p, height, width, c, _build.stream_ptr(g.device))
    _build.check(rc, "scda_roi_align_contract_bwd")
    roi_align_contract_bwd.launches += 1
    return dfeat.to(dtype)


class _RoiAlignContract(torch.autograd.Function):
    """Forward: K2.  Backward: the K2 backward kernel (the twins on the
    CPU), differentiating the features only."""

    @staticmethod
    def forward(ctx, wy, wx, features):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise RuntimeError(
                "roi_align_contract: the axis weights are not "
                "differentiable (they come from stop-gradient boxes); "
                "detach them")
        ctx.save_for_backward(wy, wx)
        ctx.map = (features.shape[1], features.shape[2], features.dtype)
        return roi_align_contract_fwd(wy, wx, features)

    @staticmethod
    def backward(ctx, g):
        wy, wx = ctx.saved_tensors
        h, w, dtype = ctx.map
        dfeat = roi_align_contract_bwd(wy, wx, g.contiguous(), h, w, dtype)
        return None, None, dfeat


def roi_align_contract(wy: torch.Tensor, wx: torch.Tensor,
                       features: torch.Tensor) -> torch.Tensor:
    """wy (B, R, P, H) f32, wx (B, R, P, W) f32, features (B, H, W, C)
    f32 or bf16 -> (B, R, P, P, C) float32, differentiable in
    ``features``.  CPU tensors take the plain twins; CUDA tensors launch
    the kernels."""
    return _RoiAlignContract.apply(wy, wx, features)


roi_align_contract.launches = 0
roi_align_contract_bwd.launches = 0

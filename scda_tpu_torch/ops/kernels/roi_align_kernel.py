"""RoI-Align double contraction: CUDA kernel K2 (forward) and its plain twin.

Replaces ``scda_tpu/ops/pallas/roi_align_kernel.py:roi_align_contract``:

    out[b,r,p,q,c] = sum_w wx[b,r,q,w] * sum_h wy[b,r,p,h] * feat[b,h,w,c]

The axis weights (``scda_tpu_torch.ops.roi_ops``) carry every sampling
mode, so one kernel serves align, adaptive and align_legacy.  The kernel,
``csrc/roi_align.cu``, exploits what the TPU's dense matmuls could not:
each weight row has at most 2*S nonzero taps.  One block per (b, r, p)
compacts those taps in shared memory and accumulates along C with
coalesced reads of ``feat[b, h, w, :]``; on the H100 it is bound by those
reads and the f32 output write.  Dense weights stay exact.

The backward (``_contract_bwd`` in the JAX package) waits for the
training slice.
"""

from __future__ import annotations

import ctypes

import torch

from scda_tpu_torch.ops.kernels import _build


def roi_align_contract_plain(wy: torch.Tensor, wx: torch.Tensor,
                             features: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of :func:`roi_align_contract`: the two einsums,
    h first as the TPU kernel contracts, in float32."""
    tmp = torch.einsum("brph,bhwc->brpwc", wy.float(), features.float())
    return torch.einsum("brqw,brpwc->brpqc", wx.float(), tmp)


def roi_align_contract(wy: torch.Tensor, wx: torch.Tensor,
                       features: torch.Tensor) -> torch.Tensor:
    """wy (B, R, P, H) f32, wx (B, R, P, W) f32, features (B, H, W, C)
    f32 or bf16 -> (B, R, P, P, C) float32.  CPU tensors take the plain
    twin; CUDA tensors launch the kernel."""
    if features.device.type == "cpu":
        return roi_align_contract_plain(wy, wx, features)
    for name, t in (("wy", wy), ("wx", wx), ("features", features)):
        if t.device != features.device or t.device.type != "cuda":
            raise ValueError(f"roi_align_contract: {name} on {t.device}; all "
                             f"inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"roi_align_contract: {name} must be contiguous")
    if wy.dtype != torch.float32 or wx.dtype != torch.float32:
        raise TypeError("roi_align_contract: weights must be float32")
    if features.dtype == torch.float32:
        name = "scda_roi_align_contract_f32"
    elif features.dtype == torch.bfloat16:
        name = "scda_roi_align_contract_bf16"
    else:
        raise TypeError(f"roi_align_contract: features must be float32 or "
                        f"bfloat16, got {features.dtype}")
    b, h, w, c = features.shape
    _, r, p, _ = wy.shape
    if wy.shape != (b, r, p, h) or wx.shape != (b, r, p, w):
        raise ValueError(f"roi_align_contract: wy {tuple(wy.shape)} / wx "
                         f"{tuple(wx.shape)} do not match features "
                         f"{tuple(features.shape)}")

    out = torch.empty((b, r, p, p, c), dtype=torch.float32,
                      device=features.device)
    fn = _build.function(name, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
    with torch.cuda.device(features.device):
        rc = fn(wy.data_ptr(), wx.data_ptr(), features.data_ptr(),
                out.data_ptr(), b, r, p, h, w, c,
                _build.stream_ptr(features.device))
    _build.check(rc, name)
    roi_align_contract.launches += 1
    return out


roi_align_contract.launches = 0

"""Fused VGG16 stem: CUDA kernel K3 and its plain twin.

Replaces ``scda_tpu/ops/pallas/stem_kernel.py:vgg_stem_fused``:
conv1_1 + relu + conv1_2 + relu + 2x2 max-pool, 3 -> 64 -> 64 channels,
NHWC.  The kernel, ``csrc/vgg_stem.cu``, keeps conv1_2's weights and a
haloed y1 tile in shared memory, pools in registers and writes only the
pooled output, so the two full-resolution 64-channel activations never
reach device memory.  In bf16 conv1_2 (38.7 GFLOP at 512x1024) is an
implicit GEMM on the tensor cores (``wgmma`` with A gathered from the y1
tile by ``ldmatrix``) and conv1_1 stays on the CUDA cores so that y1
equals the twin's bit for bit; f32 runs wholly on the CUDA cores.

Numerics follow the Pallas kernel: inputs and weights in the compute
dtype, f32 accumulation, biases added in f32, y1 rounded to the compute
dtype once.  The JAX package's ``supported()`` gate reflects TPU VMEM
budgets, not this card: any even H and W run here.

Forward only, as in JAX, which wraps the Pallas stem's inputs in
``stop_gradient`` (``vgg.py:176-178``): conv1_1 and conv1_2 are frozen in
every config the card trains (``train/steps.py:check_train_config``).
The wrapper raises when grad mode is on and an input requires grad,
instead of returning a tensor with no gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from scda_tpu_torch.ops.kernels import _build


def vgg_stem_plain(x, k1, b1, k2, b2, *, dtype=torch.bfloat16):
    """Plain PyTorch twin of :func:`vgg_stem_fused`.

    conv1_1 is the 27-tap sum in the kernel's (dy, dx, ci) order, so in
    bf16 (exact products) y1 equals the kernel's bit for bit; conv1_2 is
    an f32 ``F.conv2d``.
    """
    b, h, w, _ = x.shape
    xp = F.pad(x.to(dtype).float(), (0, 0, 1, 1, 1, 1))
    w1 = k1.to(dtype).float()
    acc = torch.zeros((b, h, w, 64), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            for ci in range(3):
                acc = acc + xp[:, dy:dy + h, dx:dx + w, ci:ci + 1] * w1[dy, dx, ci]
    y1 = torch.relu(acc + b1.float()).to(dtype).float()
    y = F.conv2d(y1.permute(0, 3, 1, 2), k2.to(dtype).float().permute(3, 2, 0, 1),
                 b2.float(), padding=1)
    y = F.max_pool2d(torch.relu(y), 2, 2)
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def vgg_stem_fused(x, k1, b1, k2, b2, *, dtype=torch.bfloat16):
    """maxpool2x2(relu(conv3x3(relu(conv3x3(x, k1) + b1), k2) + b2)).

    x (B, H, W, 3) float, H and W even; k1 (3, 3, 3, 64) and k2
    (3, 3, 64, 64) HWIO; b1, b2 (64,).  Returns (B, H/2, W/2, 64) in
    ``dtype`` (float32 or bfloat16).  CPU tensors take the plain twin,
    which carries gradients; CUDA tensors launch the kernel, which has no
    backward, so there it raises if grad mode is on and any input
    requires grad.
    """
    if x.device.type == "cpu":
        return vgg_stem_plain(x, k1, b1, k2, b2, dtype=dtype)
    _build.refuse_grad(
        "vgg_stem_fused", (x, k1, b1, k2, b2),
        "the stem has no backward: conv1_1/conv1_2 must be frozen "
        "(train.freeze_pretrained_layers) and the image must not require "
        "grad")
    if dtype == torch.float32:
        name = "scda_vgg_stem_f32"
    elif dtype == torch.bfloat16:
        name = "scda_vgg_stem_bf16"
    else:
        raise TypeError(f"vgg_stem_fused: dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    for t_name, t in (("x", x), ("k1", k1), ("b1", b1), ("k2", k2), ("b2", b2)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"vgg_stem_fused: {t_name} on {t.device}; all "
                             f"inputs must be on one CUDA device")
        if not t.is_floating_point():
            raise TypeError(f"vgg_stem_fused: {t_name} must be floating point")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"vgg_stem_fused: x must be (B, H, W, 3), got "
                         f"{tuple(x.shape)}")
    b, h, w, _ = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"vgg_stem_fused: H and W must be even, got {h}x{w}")
    if (k1.shape != (3, 3, 3, 64) or k2.shape != (3, 3, 64, 64)
            or b1.shape != (64,) or b2.shape != (64,)):
        raise ValueError("vgg_stem_fused: weights must be k1 (3,3,3,64), "
                         "b1 (64,), k2 (3,3,64,64), b2 (64,)")
    if not x.is_contiguous():
        raise ValueError("vgg_stem_fused: x must be contiguous NHWC")

    # Pack as the Pallas wrapper does: (dy, dx, ci) rows, co columns.
    xc = x.to(dtype).contiguous()
    w1 = k1.reshape(27, 64).to(dtype).contiguous()
    w2 = k2.reshape(576, 64).to(dtype).contiguous()
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    out = torch.empty((b, h // 2, w // 2, 64), dtype=dtype, device=x.device)
    fn = _build.function(name, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        rc = fn(xc.data_ptr(), w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(),
                b2f.data_ptr(), out.data_ptr(), b, h, w,
                _build.stream_ptr(x.device))
    _build.check(rc, name)
    vgg_stem_fused.launches += 1
    return out


vgg_stem_fused.launches = 0

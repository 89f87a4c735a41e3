"""Fused ResNet bottleneck chain: CUDA kernel K4 and its plain twin.

Replaces ``scda_tpu/ops/pallas/bottleneck_kernel.py:bottleneck_chain``:
N stride-1 identity bottlenecks (1x1 reduce + b1 + relu, 3x3 pad 1 + b2
+ relu, 1x1 expand + b3 + residual + relu) with FrozenBatchNorm folded
into each conv (:func:`fold_bottleneck_params`), f32 accumulation and a
rounding to the compute dtype after each stage.

The TPU kernel keeps the whole residual stream in VMEM across the chain;
an H100 SM has 227 KB of shared memory, so the kernel,
``csrc/bottleneck_chain.cu``, runs each block as three launches of one
tiled GEMM (the 3x3 as an implicit GEMM whose copies zero-fill the
padding) and the stream stays in L2 between them.  bf16 runs on the
tensor cores (``wgmma`` on 128-byte-swizzled shared-memory tiles filled
by a ring of ``cp.async`` stages), f32 on the CUDA cores.  On paper the
H100 bounds it by arithmetic, about 4.6 GFLOP per block at every
ResNet-101 stage at 512x1024; in practice each of the 3N short launches
is bound by the L2 traffic of re-reading operand tiles.

Training: :func:`bottleneck_chain` is an ``autograd.Function`` whose
forward is the kernel and whose backward re-runs the twin under autograd
in uniform f32 on the bf16-rounded inputs and weights, as the JAX
``custom_vjp`` does (``bottleneck_kernel.py:304-323``): the linearisation
point is the kernel's, the per-stage roundings are dropped.  The remat
holds every block's f32 activations until the backward ends.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from scda_tpu_torch.ops.kernels import _build


def bn_root(var: torch.Tensor, eps: float) -> torch.Tensor:
    """sqrt(var + eps) in f32, correctly rounded as XLA's sqrt is: the
    sum in f32, the root through f64 (PyTorch's vectorised f32 sqrt on
    the CPU is off by an ulp for some inputs)."""
    return torch.sqrt((var.float() + eps).double()).float()


def fold_bottleneck_params(blocks, eps: float = 1e-5):
    """Fold each block's FrozenBatchNorm into its conv, in f32.

    ``blocks``: identity bottlenecks, each with ``conv1..3`` (OIHW
    weights, no bias) and ``bn1..3`` (``weight``, ``bias``,
    ``running_mean``, ``running_var``).  Returns the stacks of the JAX
    function: w1 (N,C,F), b1 (N,1,F), w2 (N,9,F,F) ordered (tap, in,
    out), b2 (N,1,F), w3 (N,F,C), b3 (N,1,C).
    """
    def fold(convs, bns):
        k = torch.stack([c.weight for c in convs]).float()      # (N,O,I,kh,kw)
        scale, bias, mean, var = (
            torch.stack([getattr(b, name) for b in bns]).float()
            for name in ("weight", "bias", "running_mean", "running_var"))
        mult = scale / bn_root(var, eps)                         # (N, O)
        add = bias - mean * mult
        return k * mult[:, :, None, None, None], add[:, None, :]

    w1, b1 = fold([b.conv1 for b in blocks], [b.bn1 for b in blocks])
    w2, b2 = fold([b.conv2 for b in blocks], [b.bn2 for b in blocks])
    w3, b3 = fold([b.conv3 for b in blocks], [b.bn3 for b in blocks])
    n, f = w2.shape[:2]
    return (w1[..., 0, 0].transpose(1, 2), b1,
            w2.permute(0, 3, 4, 2, 1).reshape(n, 9, f, f), b2,
            w3[..., 0, 0].transpose(1, 2), b3)


def bottleneck_chain_plain(x, w1, b1, w2, b2, w3, b3, *,
                           dtype=torch.bfloat16):
    """Plain PyTorch twin of :func:`bottleneck_chain` (a port of the JAX
    ``chain_reference``): inputs and weights rounded to ``dtype`` and
    computed in f32, rounded to ``dtype`` after each stage."""
    n, _, f = w1.shape
    x = x.to(dtype)
    for i in range(n):
        y1 = torch.matmul(x.float(), w1[i].to(dtype).float())
        y1 = torch.relu(y1 + b1[i, 0].float()).to(dtype)
        k2 = w2[i].reshape(3, 3, f, f).to(dtype).float().permute(3, 2, 0, 1)
        y2 = F.conv2d(y1.float().permute(0, 3, 1, 2), k2, padding=1)
        y2 = torch.relu(y2.permute(0, 2, 3, 1) + b2[i, 0].float()).to(dtype)
        y3 = torch.matmul(y2.float(), w3[i].to(dtype).float())
        x = torch.relu(y3 + b3[i, 0].float() + x.float()).to(dtype)
    return x.contiguous()


def _check(x, w1, b1, w2, b2, w3, b3):
    if x.dim() != 4:
        raise ValueError(f"bottleneck_chain: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    if w1.dim() != 3 or w1.shape[1] != c:
        raise ValueError(f"bottleneck_chain: w1 must be (N, C={c}, F), got "
                         f"{tuple(w1.shape)}")
    n, _, f = w1.shape
    want = {"b1": (n, 1, f), "w2": (n, 9, f, f), "b2": (n, 1, f),
            "w3": (n, f, c), "b3": (n, 1, c)}
    for name, t in (("b1", b1), ("w2", w2), ("b2", b2), ("w3", w3),
                    ("b3", b3)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"bottleneck_chain: {name} must be "
                             f"{want[name]}, got {tuple(t.shape)}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2), ("w3", w3), ("b3", b3)):
        if t.device != x.device:
            raise ValueError(f"bottleneck_chain: {name} on {t.device}, x on "
                             f"{x.device}; all inputs must be on one device")
        if not t.is_floating_point():
            raise TypeError(f"bottleneck_chain: {name} must be floating point")


def chain_launcher(x, w1, b1, w2, b2, w3, b3, *, dtype=torch.bfloat16):
    """Check and pack the inputs of the CUDA kernel once; returns a
    function of no arguments that copies x into a fresh residual stream,
    launches the chain on it and returns it.  :func:`bottleneck_chain_fwd`
    calls it once; a caller that times the launches alone calls it again
    and again."""
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_chain: unsupported device {x.device}")
    if dtype == torch.float32:
        name = "scda_bottleneck_chain_f32"
    elif dtype == torch.bfloat16:
        name = "scda_bottleneck_chain_bf16"
    else:
        raise TypeError(f"bottleneck_chain: dtype must be float32 or "
                        f"bfloat16, got {dtype}")
    b, h, w, c = x.shape
    n, _, f = w1.shape
    if c % 64 or f % 64:
        raise ValueError(f"bottleneck_chain: the kernel needs C and F "
                         f"multiples of 64, got C={c}, F={f}")

    # Weights transposed to (out, in) with the contraction axis contiguous.
    w1t = w1.transpose(1, 2).to(dtype).contiguous()
    w2t = w2.permute(0, 3, 1, 2).reshape(n, f, 9 * f).to(dtype).contiguous()
    w3t = w3.transpose(1, 2).to(dtype).contiguous()
    b1f, b2f, b3f = (t.reshape(n, -1).float().contiguous()
                     for t in (b1, b2, b3))
    y1 = torch.empty((b, h, w, f), dtype=dtype, device=x.device)
    y2 = torch.empty_like(y1)
    fn = _build.function(name, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])

    def launch():
        # The residual stream, updated in place by the kernel.
        out = torch.empty((b, h, w, c), dtype=dtype, device=x.device)
        out.copy_(x)
        with torch.cuda.device(x.device):
            rc = fn(out.data_ptr(), w1t.data_ptr(), b1f.data_ptr(),
                    w2t.data_ptr(), b2f.data_ptr(), w3t.data_ptr(),
                    b3f.data_ptr(), y1.data_ptr(), y2.data_ptr(),
                    b, h, w, c, f, n, _build.stream_ptr(x.device))
        _build.check(rc, name)
        bottleneck_chain.launches += 1
        return out

    return launch


def bottleneck_chain_fwd(x, w1, b1, w2, b2, w3, b3, *,
                         dtype=torch.bfloat16):
    """The forward alone, outside autograd: CPU tensors take the plain
    twin; CUDA tensors launch the kernel, which needs C and F multiples
    of 64.  Refuses inputs that require grad while grad mode is on."""
    _check(x, w1, b1, w2, b2, w3, b3)
    _build.refuse_grad("bottleneck_chain_fwd", (x, w1, b1, w2, b2, w3, b3),
                       "call bottleneck_chain, whose autograd.Function "
                       "remats the backward")
    if x.device.type == "cpu":
        return bottleneck_chain_plain(x, w1, b1, w2, b2, w3, b3, dtype=dtype)
    return chain_launcher(x, w1, b1, w2, b2, w3, b3, dtype=dtype)()


class _BottleneckChain(torch.autograd.Function):
    """Forward: K4 (the twin on the CPU).  Backward: the twin re-run
    under autograd in f32 on the inputs rounded to ``dtype``."""

    @staticmethod
    def forward(ctx, dtype, x, *ws):
        ctx.dtype = dtype
        ctx.save_for_backward(x, *ws)
        return bottleneck_chain_fwd(x, *ws, dtype=dtype)

    @staticmethod
    def backward(ctx, g):
        x, *ws = ctx.saved_tensors

        def up(t):
            return t.detach().to(ctx.dtype).float().requires_grad_()

        ins = [up(x)] + [up(w) for w in ws]
        with torch.enable_grad():
            y = bottleneck_chain_plain(*ins, dtype=torch.float32)
        grads = torch.autograd.grad(y, ins, g.float())
        return (None,) + tuple(gr.to(t.dtype)
                               for gr, t in zip(grads, (x, *ws)))


def bottleneck_chain(x, w1, b1, w2, b2, w3, b3, *, dtype=torch.bfloat16):
    """N identity bottlenecks over x (B, H, W, C) with the folded weights
    of :func:`fold_bottleneck_params`; returns (B, H, W, C) contiguous in
    ``dtype`` (float32 or bfloat16), differentiable in x and every
    weight.  CPU tensors take the plain twin; CUDA tensors launch the
    kernel, which needs C and F multiples of 64."""
    return _BottleneckChain.apply(dtype, x, w1, b1, w2, b2, w3, b3)


bottleneck_chain.launches = 0

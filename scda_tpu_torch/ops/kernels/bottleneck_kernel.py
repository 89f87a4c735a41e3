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
forward is the kernel and whose backward is a second CUDA kernel,
``csrc/bottleneck_chain_bwd.cu`` (:func:`bottleneck_chain_bwd`).  It does
what the JAX ``custom_vjp`` does (``bottleneck_kernel.py:297-325``): a
remat of the chain in uniform f32 on the inputs and weights rounded to
the forward's dtype (the linearisation point is the kernel's, the
per-stage roundings are dropped), then the data and weight gradients
block by block, last to first, with no atomics, so that two calls give
the same bits.  Every product runs on the tensor cores in split TF32
(each f32 operand as hi + lo TF32 halves: two passes for the data
products when the weights are bf16 values, three otherwise), at
f32-class accuracy.  It computes only the gradients autograd asks for
(the folded biases come from frozen BatchNorm buffers and are never
asked for in the model).  Its plain twin,
:func:`bottleneck_chain_bwd_plain`, is the same backward written out in
plain torch; CPU tensors take it.  The remat holds every block's f32
activations (about 12.6 MB a block at layer3, 512x1024, bs 1) until the
call ends; :func:`chain_bwd_launcher` hands them back for checks.
"""

from __future__ import annotations

import ctypes
import itertools

import torch
import torch.nn.functional as F

from scda_tpu_torch.ops.kernels import _build
from scda_tpu_torch.utils.profile import span, span_ids


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

    # After a launch the scratch holds the last block's y1 and y2.
    launch.scratch = (y1, y2)
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


# The 3x3's taps, (dy, dx) in the order of w2's tap axis.
TAPS = tuple((t // 3 - 1, t % 3 - 1) for t in range(9))
GRAD_NAMES = ("x", "w1", "b1", "w2", "b2", "w3", "b3")
ALL_GRADS = (True,) * 7
# The weight gradients reduce over the B*H*W pixels; the kernel cuts that
# axis into splits of partial sums (added in split order afterwards), so
# that about WGRAD_BLOCKS tiles run at once (four on each of the H100's
# 132 SMs), with at least WGRAD_MIN_ROWS pixels a split.
WGRAD_BLOCKS = 528
WGRAD_MIN_ROWS = 256
BIAS_CHUNK = 256


# The data products (remat, dy2, dy1, dx) run in 64-row tiles, 128
# columns wide where N allows (else 64).  A product with fewer tiles than
# PRODUCT_BLOCKS (about one for each of the H100's 132 SMs) splits its K
# range: the 3x3s into groups of whole taps, the 1x1s into channel ranges
# of a multiple of 32; the partials are added in split order.  At layer3
# at bs 1 (64 tiles) two splits of the 1x1 and three of the 3x3 were the
# fastest (``kernel_probe k4bwd-phases``): more splits cost more in
# partial sums than they gain in blocks.
PRODUCT_BLOCKS = 128


def product_tiles(m: int, n: int) -> int:
    """Output tiles of a data product of ``m`` pixels and ``n`` columns."""
    return -(-m // 64) * (n // (128 if n % 128 == 0 else 64))


def product_splits(m: int, n: int, k: int, conv: bool = False) -> int:
    """K splits of a data product: the fewest that give PRODUCT_BLOCKS
    blocks, among 1, 3, 9 for a 3x3 (``k`` = 9 f) and the powers of two
    that leave a multiple of 32 channels for a 1x1, else the most."""
    valid = (1, 3, 9) if conv else [s for s in (1, 2, 4, 8)
                                    if k % (32 * s) == 0]
    tiles = product_tiles(m, n)
    return next((s for s in valid if tiles * s >= PRODUCT_BLOCKS), valid[-1])


def chain_bwd_splits(m: int, c: int, f: int):
    """K splits of the reduce-side 1x1 products (remat y1, dy2: K = C, N
    = F), the 3x3s (K = 9F, N = F) and the expand-side ones (remat x, dx:
    K = F, N = C)."""
    return (product_splits(m, f, c), product_splits(m, f, 9 * f, conv=True),
            product_splits(m, c, f))


def data_passes(dtype) -> int:
    """TF32 passes of a data product: two when the weights are bf16
    values (exact in TF32), three for f32 weights."""
    return 2 if dtype == torch.bfloat16 else 3


def wgrad_chunk(m: int, tiles: int) -> int:
    """Pixels per split of a weight gradient with ``tiles`` 64x64 output
    tiles over ``m`` pixels: a multiple of 16 (the kernel's slice)."""
    splits = max(1, min(-(-WGRAD_BLOCKS // tiles), m // WGRAD_MIN_ROWS))
    return -(-m // (splits * 16)) * 16


def _shift(t, dy, dx):
    """t (B, H, W, K) read at pixel (y + dy, x + dx), zero outside the
    image."""
    _, h, w, _ = t.shape
    p = F.pad(t, (0, 0, 1, 1, 1, 1))
    return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _rounded(x, ws, dtype):
    """x and the weights rounded to ``dtype``, then f32: the JAX
    backward's ``up``."""
    return [t.detach().to(dtype).float() for t in (x, *ws)]


def chain_bwd_operands(x, ws, dtype):
    """The kernel's operands, contiguous f32: x and the six weights
    rounded to ``dtype`` in the inputs' layouts, then the weights of the
    products packed as (out, in) with the reduction axis contiguous, the
    only operand layout of TF32 ``wgmma``: for the remat w1t (N, F, C),
    w2t (N, F, 9F) with w2t[i, o, t F + c] = w2[i, t, c, o], w3t (N, C,
    F); for the data gradients w3 (N, F, C) and w1 (N, C, F) as they are
    and w2r (N, F, 9F) with w2r[i, c, t F + o] = w2[i, 8 - t, c, o], so
    that the 3x3's transpose is the forward's implicit GEMM over the taps
    reversed.  Returns (x, w1, b1, w2, b2, w3, b3, w1t, w2t, w2r, w3t)."""
    xr, w1, b1, w2, b2, w3, b3 = (t.contiguous()
                                  for t in _rounded(x, ws, dtype))
    n, _, f = w1.shape
    return (xr, w1, b1, w2, b2, w3, b3, w1.transpose(1, 2).contiguous(),
            w2.permute(0, 3, 1, 2).reshape(n, f, 9 * f).contiguous(),
            w2.flip(1).permute(0, 2, 1, 3).reshape(n, f, 9 * f).contiguous(),
            w3.transpose(1, 2).contiguous())


def chain_remat_plain(x, w1, b1, w2, b2, w3, b3):
    """The chain's forward in f32 with every activation kept: (xs, y1s,
    y2s), x_0 .. x_N and each block's y1 and y2 after their relu."""
    xs, y1s, y2s = [x], [], []
    for i in range(w1.shape[0]):
        y1 = torch.relu(xs[-1] @ w1[i] + b1[i, 0])
        y2 = torch.relu(sum(_shift(y1, dy, dx) @ w2[i, t]
                            for t, (dy, dx) in enumerate(TAPS)) + b2[i, 0])
        xs.append(torch.relu(y2 @ w3[i] + b3[i, 0] + xs[-1]))
        y1s.append(y1)
        y2s.append(y2)
    return xs, y1s, y2s


def chain_remat_kernel(x, w1, b1, w2, b2, w3, b3):
    """:func:`chain_remat_plain` from the forward kernel's f32 path on
    CUDA tensors (CUDA-core FMAs, every output summed in k order), one
    block a launch (its scratch then holds the block's y1 and y2): the
    f32 chain that the backward kernel's split-TF32 remat is held to."""
    xs, y1s, y2s = [x], [], []
    for i in range(w1.shape[0]):
        launch = chain_launcher(xs[-1], *(t[i:i + 1] for t in (
            w1, b1, w2, b2, w3, b3)), dtype=torch.float32)
        xs.append(launch())
        y1s.append(launch.scratch[0].clone())
        y2s.append(launch.scratch[1].clone())
    return xs, y1s, y2s


def remat_gaps(remat, ref):
    """Per map of two remats (xs, y1s, y2s): max |a - b| over the map's
    largest magnitude in ``ref``, in the order x_0 .. x_N, y1_0 .., y2_0
    ..; and how many relu gates (a > 0 against b > 0) differ in all."""
    gaps, flips = [], 0
    for a, b in zip((t for part in remat for t in part),
                    (t for part in ref for t in part)):
        top = float(b.abs().max())
        gaps.append(float((a - b).abs().max()) / top if top > 0 else
                    float((a - b).abs().max()))
        flips += int(((a > 0) != (b > 0)).sum())
    return gaps, flips


def bottleneck_chain_bwd_plain(x, w1, b1, w2, b2, w3, b3, g, *,
                               dtype=torch.bfloat16, needs=ALL_GRADS,
                               remat=None):
    """Plain PyTorch twin of :func:`bottleneck_chain_bwd`: the explicit
    backward in the kernel's order, no autograd.  The remat in f32 on the
    inputs rounded to ``dtype`` (:func:`chain_remat_plain`; ``remat``
    gives its (xs, y1s, y2s) instead, to linearise at other activations),
    then per block, last to first, with g3 the cotangent of its pre-relu
    output: dW3 = y2^T g3, dy2 = g3 W3^T [y2 > 0], dW2[tap] = shift(y1,
    tap)^T dy2, dy1 = sum over taps of shift(dy2, -tap) W2[tap]^T [y1 >
    0], dW1 = x_i^T dy1, dx = dy1 W1^T + g3 (times [x_i > 0]: the
    previous block's g3); the biases' are the column sums of g3, dy2,
    dy1.  Returns the seven gradients in f32, in the inputs' shapes,
    ``None`` where ``needs`` says no."""
    x, w1, b1, w2, b2, w3, b3 = _rounded(x, (w1, b1, w2, b2, w3, b3), dtype)
    n = w1.shape[0]
    xs, y1s, y2s = remat or chain_remat_plain(x, w1, b1, w2, b2, w3, b3)

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    def masked(v, y):
        return torch.where(y > 0, v, torch.zeros((), dtype=v.dtype))

    grads = [[None] * n for _ in range(6)]    # w1, b1, w2, b2, w3, b3
    g3 = masked(g.detach().float(), xs[n])
    for i in reversed(range(n)):
        grads[4][i] = flat(y2s[i]).T @ flat(g3)
        grads[5][i] = flat(g3).sum(0)[None]
        dy2 = masked(g3 @ w3[i].T, y2s[i])
        grads[2][i] = torch.stack([flat(_shift(y1s[i], dy, dx)).T @ flat(dy2)
                                   for dy, dx in TAPS])
        grads[3][i] = flat(dy2).sum(0)[None]
        dy1 = masked(sum(_shift(dy2, -dy, -dx) @ w2[i, t].T
                         for t, (dy, dx) in enumerate(TAPS)), y1s[i])
        grads[0][i] = flat(xs[i]).T @ flat(dy1)
        grads[1][i] = flat(dy1).sum(0)[None]
        g3 = dy1 @ w1[i].T + g3
        if i:
            g3 = masked(g3, xs[i])
    out = [g3] + [torch.stack(gr) for gr in grads]
    return tuple(t if need else None for t, need in zip(out, needs))


def chain_bwd_launcher(x, w1, b1, w2, b2, w3, b3, g, *,
                       dtype=torch.bfloat16, needs=ALL_GRADS):
    """Pack the CUDA kernel's operands and allocate its workspace and
    outputs once (CUDA tensors, C and F multiples of 64); returns a
    function of no arguments that launches the backward and returns the
    seven gradients (the same tensors at every launch; ``None`` where
    ``needs`` says no).  ``launch.remat`` is the kernel's remat after a
    launch, views of its workspace in the twin's ``remat=`` form (xs,
    y1s, y2s), x_0 being x rounded to ``dtype``.
    :func:`bottleneck_chain_bwd` launches it once; a caller that checks
    the remat or times the launches alone keeps it."""
    name = "scda_bottleneck_chain_bwd_f32"
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_chain_bwd: unsupported device "
                         f"{x.device}")
    b, h, w, c = x.shape
    n, _, f = w1.shape
    if c % 64 or f % 64:
        raise ValueError(f"bottleneck_chain_bwd: the kernel needs C and F "
                         f"multiples of 64, got C={c}, F={f}")
    ops = chain_bwd_operands(x, (w1, b1, w2, b2, w3, b3), dtype)
    # The C call's order: x, w1, b1, w2t, b2, w3, b3, w1t, w2r, w3t.
    packed = ops[:3] + (ops[8],) + ops[4:8] + ops[9:]
    gf = g.detach().float().contiguous()
    m = b * h * w
    chunks = (wgrad_chunk(m, (c // 64) * (f // 64)),
              wgrad_chunk(m, 9 * (f // 64) ** 2), BIAS_CHUNK)
    splits = chain_bwd_splits(m, c, f)
    size = _build.function("scda_bottleneck_chain_bwd_workspace",
                           [ctypes.c_int] * 12, ctypes.c_longlong)
    work = torch.empty(size(b, h, w, c, f, n, *chunks, *splits),
                       dtype=torch.float32, device=x.device)
    outs = [torch.empty(t.shape, dtype=torch.float32, device=x.device)
            if need else None
            for t, need in zip((x, w1, b1, w2, b2, w3, b3), needs)]
    fn = _build.function(name, [ctypes.c_void_p] * 19 + [ctypes.c_int] * 13
                         + [ctypes.c_void_p])

    def launch():
        with torch.cuda.device(x.device):
            rc = fn(*(t.data_ptr() for t in packed), gf.data_ptr(),
                    *(None if t is None else t.data_ptr() for t in outs),
                    work.data_ptr(), b, h, w, c, f, n, *chunks, *splits,
                    data_passes(dtype), _build.stream_ptr(x.device))
        _build.check(rc, name)
        bottleneck_chain_bwd.launches += 1
        return tuple(outs)

    mc, mf = m * c, m * f
    xs = [ops[0]] + [work[i * mc:(i + 1) * mc].view(b, h, w, c)
                     for i in range(n)]
    y1s = [work[n * mc + i * mf:n * mc + (i + 1) * mf].view(b, h, w, f)
           for i in range(n)]
    y2s = [work[n * (mc + mf) + i * mf:n * (mc + mf) + (i + 1) * mf]
           .view(b, h, w, f) for i in range(n)]
    launch.remat = (xs, y1s, y2s)
    return launch


def bottleneck_chain_bwd(x, w1, b1, w2, b2, w3, b3, g, *,
                         dtype=torch.bfloat16, needs=ALL_GRADS):
    """The gradients of :func:`bottleneck_chain_fwd`'s inputs from the
    cotangent ``g`` of its output (shaped as x): seven f32 tensors in
    the inputs' shapes, ``None`` where ``needs`` (seven bools) says no.
    CPU tensors take the plain twin; CUDA tensors launch
    ``scda_bottleneck_chain_bwd_f32`` (``csrc/bottleneck_chain_bwd.cu``),
    which needs C and F multiples of 64.  Refuses inputs that require
    grad while grad mode is on."""
    name = "bottleneck_chain_bwd"
    _check(x, w1, b1, w2, b2, w3, b3)
    if tuple(g.shape) != tuple(x.shape) or g.device != x.device:
        raise ValueError(f"{name}: g must be shaped as x {tuple(x.shape)} on "
                         f"{x.device}, got {tuple(g.shape)} on {g.device}")
    if not g.is_floating_point():
        raise TypeError(f"{name}: g must be floating point")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got "
                        f"{dtype}")
    needs = tuple(bool(v) for v in needs)
    if len(needs) != 7:
        raise ValueError(f"{name}: needs must be seven bools, got {needs}")
    _build.refuse_grad(name, (x, w1, b1, w2, b2, w3, b3, g),
                       "call bottleneck_chain, whose autograd.Function "
                       "launches this kernel in its backward")
    if x.device.type == "cpu":
        return bottleneck_chain_bwd_plain(x, w1, b1, w2, b2, w3, b3, g,
                                          dtype=dtype, needs=needs)
    return chain_bwd_launcher(x, w1, b1, w2, b2, w3, b3, g, dtype=dtype,
                              needs=needs)()


class _BottleneckChain(torch.autograd.Function):
    """Forward: K4.  Backward: the K4 backward kernel in f32 on the inputs
    rounded to ``dtype`` (the plain twins on the CPU), inside a
    ``scda.k4.bwd`` span with the ids ``ids`` of its forward's."""

    @staticmethod
    def forward(ctx, dtype, ids, x, *ws):
        ctx.dtype, ctx.ids = dtype, ids
        ctx.save_for_backward(x, *ws)
        return bottleneck_chain_fwd(x, *ws, dtype=dtype)

    @staticmethod
    def backward(ctx, g):
        x, *ws = ctx.saved_tensors
        with span("k4.bwd", **(ctx.ids or {})):
            grads = bottleneck_chain_bwd(x, *ws, g, dtype=ctx.dtype,
                                         needs=ctx.needs_input_grad[2:])
            return (None, None) + tuple(
                None if gr is None else gr.to(t.dtype)
                for gr, t in zip(grads, (x, *ws)))


# The ``call`` id of the ``scda.k4`` spans: this process's K4 calls.
_calls = itertools.count()


def bottleneck_chain(x, w1, b1, w2, b2, w3, b3, *, dtype=torch.bfloat16):
    """N identity bottlenecks over x (B, H, W, C) with the folded weights
    of :func:`fold_bottleneck_params`; returns (B, H, W, C) contiguous in
    ``dtype`` (float32 or bfloat16), differentiable in x and every
    weight.  CPU tensors take the plain twin; CUDA tensors launch the
    kernel, which needs C and F multiples of 64.  Under a profiler the
    call is a ``scda.k4`` span whose ``call`` (this process's ordinal)
    and ``stage`` (the width F: 64, 128, 256 for ResNet's layer1-3) its
    backward's ``scda.k4.bwd`` carries too."""
    ids = span_ids(call=next(_calls), stage=int(w1.shape[-1]))
    with span("k4", **(ids or {})):
        return _BottleneckChain.apply(dtype, ids, x, w1, b1, w2, b2, w3, b3)


bottleneck_chain.launches = 0
bottleneck_chain_bwd.launches = 0

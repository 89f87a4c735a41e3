"""Rooflines of the kernels the benchmark reads, and the card's peaks.

Frozen copy of ``chip_smoke.py``'s ``roofline`` and ``chain_bound`` at
commit 8b959ad8dec4, on shapes instead of tensors, and of the
``bound_bf16_ms`` form of its ``chain_bwd_bound``: the gradients' own
work (twice the forward's operations) at the bf16 peak, with the bf16
stream and its cotangent read once, its gradient written once, the
weights read once and their gradients written once.  A backward that
recomputes, or that runs its products in several passes, does more than
this work, so its share can only read lower; no legitimate change reads
over 100%.

Peaks: one H100 SXM at its full 700 W (NVIDIA's data sheet), dense, no
sparsity.  Every share here is against the bf16 peak, whatever
precision an implementation uses.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def roofline(flops: float, moved_bytes: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take for the work:
    max(flops / peak_flops, bytes / PEAK_BYTES_PER_S), in ms."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = moved_bytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": float(flops), "bytes": float(moved_bytes)}


def chain_bound(x_shape, w1_shape) -> dict:
    """K4 in bf16: N blocks of 1x1 C->F, 3x3 F->F, 1x1 F->C at every pixel
    of x (B, H, W, C); w1 (N, C, F).  The stream in and out once, each
    block's bf16 weights and f32 biases."""
    c = int(x_shape[-1])
    m = 1
    for d in x_shape[:-1]:
        m *= int(d)
    n, f = int(w1_shape[0]), int(w1_shape[2])
    flops = 2 * m * n * (2 * c * f + 9 * f * f)
    moved = 2 * m * c * 2 + n * ((2 * c * f + 9 * f * f) * 2 + (2 * f + c) * 4)
    return roofline(flops, moved)


def chain_bwd_bound(x_shape, w1_shape) -> dict:
    """The gradients of a chain (data and weights) without a remat, at
    the bf16 peak: ``chip_smoke.py``'s ``bound_bf16_ms``."""
    fwd = chain_bound(x_shape, w1_shape)
    c = int(x_shape[-1])
    m = 1
    for d in x_shape[:-1]:
        m *= int(d)
    bf16_weights = fwd["bytes"] - 2 * m * c * 2
    return roofline(2 * fwd["flops"], 3 * m * c * 2 + 2 * bf16_weights)


def share_pct(bound_ms: float, time_ms: float):
    """A roofline share in %, or None where no time was read."""
    if not time_ms or time_ms <= 0:
        return None
    return 100.0 * bound_ms / time_ms


def mfu_pct(img_per_s: float, flops_per_img: float,
            peak: float = PEAK_BF16_FLOPS):
    """Model FLOP/s over the bf16 peak, in %."""
    if not img_per_s or img_per_s <= 0:
        return None
    return 100.0 * img_per_s * flops_per_img / peak

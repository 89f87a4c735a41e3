"""RoI-Align on per-image grouped rois (port of ``scda_tpu/ops/roi_ops.py``).

RoI-Align is linear in the feature map and its bilinear kernel factorises
per axis, so it is two contractions against per-axis weight matrices:

    out[b, r, p, q, c] = sum_h sum_w wy[b,r,p,h] * wx[b,r,q,w] * feat[b,h,w,c]

The functions that build the weights hold every sampling semantic and
stay plain PyTorch, as the JAX package builds them outside Pallas; the
contraction is kernel K2
(:func:`scda_tpu_torch.ops.kernels.roi_align_kernel.roi_align_contract`).

Two semantics, as in the JAX package:
  * ``align`` — the torchvision spec: ``sampling_ratio`` bilinear samples
    per bin edge, averaged; ``sampling_ratio=0`` is the adaptive per-roi
    count under a static bound;
  * ``align_legacy`` — the reference lineage's crop-and-resize kernel: one
    sample per output at bin corners, +1 roi size, bins of roi/(P-1),
    zero outside the map, floor clamped to size-2.

Feature maps are NHWC (B, H, W, C); rois are grouped (B, R, 4) in image
coordinates.  The flat-roi gather forms and RoI pool / crop are not
ported yet.
"""

from __future__ import annotations

import torch

from scda_tpu_torch.ops.kernels.roi_align_kernel import roi_align_contract


def _axis_weights(coords: torch.Tensor, size: int,
                  sample_mask: torch.Tensor | None = None,
                  denom: torch.Tensor | float | None = None) -> torch.Tensor:
    """Per-sample bilinear weights scattered onto the feature grid.

    coords (..., S) fractional sample coordinates along one axis;
    sample_mask (..., S) {0, 1} drops inactive samples; denom is the
    per-roi sample count to average by (default: S).  Returns (..., size).
    Torchvision border rules: samples outside [-1, size] drop, in-range
    samples clamp.
    """
    s = coords.shape[-1]
    valid = ((coords >= -1.0) & (coords <= float(size))).float()
    if sample_mask is not None:
        valid = valid * sample_mask
    c = torch.clamp(coords, 0.0, size - 1.0)
    c0 = torch.floor(c)
    low = c0.to(torch.int64)
    high = torch.clamp(low + 1, max=size - 1)
    w_high = (c - c0) * valid
    w_low = (1.0 - (c - c0)) * valid

    grid = torch.arange(size, device=coords.device)
    w = (w_low[..., None] * (grid == low[..., None])
         + w_high[..., None] * (grid == high[..., None]))   # (..., S, size)
    if denom is None:
        denom = float(s)
    return torch.sum(w, dim=-2) / denom


def roi_align_axis_weights(
    rois: torch.Tensor,      # (B, R, 4) per-image boxes, image coords
    height: int,
    width: int,
    *,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
    aligned: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-axis RoI-Align weights (wy (B,R,P,H), wx (B,R,P,W)) for the
    torchvision and adaptive modes — the single source of their spec."""
    b, r = rois.shape[:2]
    p = output_size
    adaptive = int(sampling_ratio) <= 0
    s = (max(-(-max(height, width) // p), 1) if adaptive
         else max(int(sampling_ratio), 1))
    dev = rois.device

    boxes = rois.detach().float()
    offset = 0.5 if aligned else 0.0
    x1 = boxes[..., 0] * spatial_scale - offset      # (B, R)
    y1 = boxes[..., 1] * spatial_scale - offset
    x2 = boxes[..., 2] * spatial_scale - offset
    y2 = boxes[..., 3] * spatial_scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_w = roi_w / p
    bin_h = roi_h / p

    ph = torch.arange(p, dtype=torch.float32, device=dev)   # (P,)
    k = torch.arange(s, dtype=torch.float32, device=dev)    # (S,)
    if adaptive:
        sy = torch.clamp(torch.ceil(roi_h / p), 1, s)        # (B, R)
        sx = torch.clamp(torch.ceil(roi_w / p), 1, s)
        fy = (k + 0.5) / sy[..., None]                      # (B, R, S)
        fx = (k + 0.5) / sx[..., None]
        my = (k < sy[..., None]).float()[..., None, :].expand(b, r, p, s)
        mx = (k < sx[..., None]).float()[..., None, :].expand(b, r, p, s)
        dy, dx = sy[..., None, None], sx[..., None, None]
    else:
        fy = fx = ((k + 0.5) / s).expand(b, r, s)
        my = mx = None
        dy = dx = None
    # (B, R, P, S) absolute sample coordinates per axis.
    ys = (y1[..., None, None]
          + (ph[None, None, :, None] + fy[..., None, :]) * bin_h[..., None, None])
    xs = (x1[..., None, None]
          + (ph[None, None, :, None] + fx[..., None, :]) * bin_w[..., None, None])

    wy = _axis_weights(ys, height, my, dy)
    wx = _axis_weights(xs, width, mx, dx)
    return wy, wx


def contract_axis_weights(wy: torch.Tensor, wx: torch.Tensor,
                           features: torch.Tensor) -> torch.Tensor:
    """Both contractions through kernel K2 (f32 accumulation and an f32
    intermediate), cast back to the features' dtype."""
    return roi_align_contract(wy, wx, features.contiguous()).to(features.dtype)


def roi_align_grouped(
    features: torch.Tensor,  # (B, H, W, C)
    rois: torch.Tensor,      # (B, R, 4) per-image boxes, image coords
    *,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
    aligned: bool = False,
) -> torch.Tensor:
    """Torchvision-spec RoI-Align: (B, R, P, P, C) in the features' dtype."""
    _, height, width, _ = features.shape
    wy, wx = roi_align_axis_weights(
        rois, height, width, output_size=output_size,
        spatial_scale=spatial_scale, sampling_ratio=sampling_ratio,
        aligned=aligned,
    )
    return contract_axis_weights(wy, wx, features)


def _legacy_sample_coords(boxes: torch.Tensor, spatial_scale: float, p: int):
    """(ys, xs) bin-corner sample coordinates per axis, legacy rules."""
    x1 = boxes[..., 0] * spatial_scale
    y1 = boxes[..., 1] * spatial_scale
    x2 = boxes[..., 2] * spatial_scale
    y2 = boxes[..., 3] * spatial_scale
    roi_w = torch.clamp(x2 - x1 + 1.0, min=0.0)
    roi_h = torch.clamp(y2 - y1 + 1.0, min=0.0)
    d = float(max(p - 1, 1))
    bin_w = roi_w / d
    bin_h = roi_h / d
    ph = torch.arange(p, dtype=torch.float32, device=boxes.device)
    ys = y1[..., None] + ph * bin_h[..., None]       # (..., P)
    xs = x1[..., None] + ph * bin_w[..., None]
    return ys, xs


def _legacy_axis_weights(coords: torch.Tensor, size: int) -> torch.Tensor:
    """Two-tap legacy bilinear weights on the grid: (..., P) -> (..., P,
    size).  Rows outside [0, size) are zero; in-range rows put (1 - ratio,
    ratio) at (start, start + 1) with start = min(floor(c), size - 2), so
    the last half-cell extrapolates (ratio > 1) as the CUDA kernel does."""
    valid = ((coords >= 0.0) & (coords < float(size))).float()
    start = torch.clamp(torch.floor(coords), max=size - 2).to(torch.int64)
    start = torch.clamp(start, min=0)
    ratio = coords - start.float()
    grid = torch.arange(size, device=coords.device)
    return (((1.0 - ratio) * valid)[..., None] * (grid == start[..., None])
            + (ratio * valid)[..., None] * (grid == (start + 1)[..., None]))


def roi_align_legacy_grouped(
    features: torch.Tensor,  # (B, H, W, C)
    rois: torch.Tensor,      # (B, R, 4)
    *,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
) -> torch.Tensor:
    """Reference-lineage RoI-Align: (B, R, P, P, C) in the features' dtype.
    Separable like the torchvision one: a zero weight row on either axis
    zeroes the product, which is the kernel's out-of-range rule."""
    _, height, width, _ = features.shape
    boxes = rois.detach().float()
    ys, xs = _legacy_sample_coords(boxes, spatial_scale, output_size)
    wy = _legacy_axis_weights(ys, height)
    wx = _legacy_axis_weights(xs, width)
    return contract_axis_weights(wy, wx, features)

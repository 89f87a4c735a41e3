"""RoI pooling (port of ``scda_tpu/ops/roi_ops.py``): RoI-Align on
per-image grouped rois, and the flat-roi gather forms.

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

Feature maps are NHWC (B, H, W, C); the contraction forms take grouped
(B, R, 4) rois in image coordinates.

The flat forms take (R, 4) boxes plus an (R,) batch index, or (R, 5) with
the index in column 0 (the reference's packing), and gather from the
flattened map: :func:`roi_align` and :func:`roi_align_legacy` (the same
two semantics), :func:`roi_pool` (the reference's quantized max pool:
integer bin bounds, empty bins 0) and :func:`roi_crop` (a corner-to-corner
2P x 2P bilinear grid, then a 2x2 max).  They are gathers in the JAX
package too, not Pallas kernels, so plain PyTorch is their port on every
device; each computes in f32 and returns the features' dtype.
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


# ---------------------------------------------------------------------------
# Flat rois: (R, 4) boxes + (R,) batch index, or (R, 5) index first
# ---------------------------------------------------------------------------


def _split_rois(rois: torch.Tensor, batch_indices: torch.Tensor | None):
    """(boxes (R, 4), batch index (R,) int64) from either layout."""
    if rois.shape[-1] == 5 and batch_indices is None:
        return rois[:, 1:5], rois[:, 0].to(torch.int64)
    if batch_indices is None:
        batch_indices = torch.zeros(rois.shape[0], dtype=torch.int64,
                                    device=rois.device)
    return rois, batch_indices.to(torch.int64)


def _bilinear_gather(flat_feat: torch.Tensor, batch_offset: torch.Tensor,
                     y: torch.Tensor, x: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """Bilinear samples at fractional (y, x) from ``flat_feat`` (B*H*W, C),
    torchvision border rules: points outside [-1, size] give zero,
    in-range points clamp.  ``batch_offset``, ``y`` and ``x`` broadcast to
    the sample shape; returns (..., C)."""
    batch_offset, y, x = torch.broadcast_tensors(batch_offset, y, x)
    oob = (y < -1.0) | (y > height) | (x < -1.0) | (x > width)
    y = torch.clamp(y, 0.0, height - 1.0)
    x = torch.clamp(x, 0.0, width - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, max=height - 1)
    x1i = torch.clamp(x0i + 1, max=width - 1)
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    hy, hx = 1.0 - ly, 1.0 - lx

    def g(yy, xx):
        return flat_feat[batch_offset + yy * width + xx]

    val = (hy * hx * g(y0i, x0i) + hy * lx * g(y0i, x1i)
           + ly * hx * g(y1i, x0i) + ly * lx * g(y1i, x1i))
    return torch.where(oob[..., None], torch.zeros_like(val), val)


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    batch_indices: torch.Tensor | None = None,
    *,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
    aligned: bool = False,
) -> torch.Tensor:
    """Torchvision-spec RoI-Align on flat rois: (R, P, P, C).

    ``sampling_ratio`` samples per bin edge, averaged; 0 is the adaptive
    per-roi count ceil(roi_size / P), under the static bound
    ceil(max(H, W) / P) with the extra samples masked."""
    boxes, bidx = _split_rois(rois, batch_indices)
    b, height, width, c = features.shape
    p = output_size
    adaptive = int(sampling_ratio) <= 0
    s = (max(-(-max(height, width) // p), 1) if adaptive
         else max(int(sampling_ratio), 1))
    dev = features.device
    flat = features.reshape(b * height * width, c).float()
    boxes = boxes.detach().float()

    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_w, bin_h = roi_w / p, roi_h / p
    if adaptive:
        sy = torch.clamp(torch.ceil(roi_h / p), 1, s)         # (R,)
        sx = torch.clamp(torch.ceil(roi_w / p), 1, s)
    else:
        sy = sx = torch.full(boxes.shape[:1], float(s), device=dev)

    ph = torch.arange(p, dtype=torch.float32, device=dev)
    k = torch.arange(s, dtype=torch.float32, device=dev)
    iy = (k[None, :] + 0.5) / sy[:, None]                     # (R, S)
    ix = (k[None, :] + 0.5) / sx[:, None]
    my = k[None, :] < sy[:, None]
    mx = k[None, :] < sx[:, None]
    # (R, P, S) coordinates per axis, then the (R, P, S, P, S) lattice.
    ys = y1[:, None, None] + (ph[None, :, None] + iy[:, None, :]) * bin_h[:, None, None]
    xs = x1[:, None, None] + (ph[None, :, None] + ix[:, None, :]) * bin_w[:, None, None]
    batch_offset = (bidx * (height * width))[:, None, None, None, None]
    vals = _bilinear_gather(flat, batch_offset, ys[:, :, :, None, None],
                            xs[:, None, None, :, :], height, width)
    mm = (my[:, None, :, None, None] & mx[:, None, None, None, :])
    r = boxes.shape[0]
    num = (vals * mm[..., None].float()).reshape(r, p, s, p, s, c).sum(dim=(2, 4))
    return (num / (sy * sx)[:, None, None, None]).to(features.dtype)


def roi_align_legacy(
    features: torch.Tensor,
    rois: torch.Tensor,
    batch_indices: torch.Tensor | None = None,
    *,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
) -> torch.Tensor:
    """Reference-lineage RoI-Align on flat rois: (R, P, P, C)."""
    boxes, bidx = _split_rois(rois, batch_indices)
    b, height, width, c = features.shape
    flat = features.reshape(b * height * width, c).float()
    boxes = boxes.detach().float()
    ys, xs = _legacy_sample_coords(boxes, spatial_scale, output_size)  # (R, P)
    valid = (((ys >= 0.0) & (ys < height))[:, :, None]
             & ((xs >= 0.0) & (xs < width))[:, None, :])               # (R, P, P)
    ystart = torch.clamp(torch.floor(ys), 0, height - 2)
    xstart = torch.clamp(torch.floor(xs), 0, width - 2)
    ry = (ys - ystart)[:, :, None, None]
    rx = (xs - xstart)[:, None, :, None]
    y0 = ystart.to(torch.int64)[:, :, None]
    x0 = xstart.to(torch.int64)[:, None, :]
    batch_offset = (bidx * (height * width))[:, None, None]

    def g(yy, xx):
        return flat[batch_offset + yy * width + xx]

    val = ((1 - ry) * (1 - rx) * g(y0, x0) + (1 - ry) * rx * g(y0, x0 + 1)
           + ry * (1 - rx) * g(y0 + 1, x0) + ry * rx * g(y0 + 1, x0 + 1))
    out = torch.where(valid[..., None], val, torch.zeros_like(val))
    return out.to(features.dtype)


def roi_pool(
    features: torch.Tensor,
    rois: torch.Tensor,
    batch_indices: torch.Tensor | None = None,
    *,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
) -> torch.Tensor:
    """Quantized max RoI pooling with the reference's bin arithmetic:
    (R, P, P, C).

    Corners round to cells, roi size is end - start + 1 (at least 1), bin
    ``ph`` spans [floor(ph * rh / P), ceil((ph + 1) * rh / P)) in integer
    division, clamped to the map; a bin is read through a static window
    of ``max_bin`` cells per axis (the JAX bound), and a bin with no
    valid cell gives 0, as does any non-finite maximum.

    The maximum is separable and exact in any order, so each axis is
    taken apart: a sparse table of maxima over runs of 2^j columns (j up
    to log2 ``max_bin``) answers a bin's column range with two lookups,
    then the window's rows are maxed.  That reads (R, P, max_bin, P, C)
    values rather than the (R, P, max_bin, P, max_bin, C) lattice of the
    JAX form, and gives its values bit for bit.  Where several cells tie
    for a bin's maximum, the gradient splits among them differently than
    JAX's (any split is a subgradient; after a ReLU the ties at 0 get
    none either way)."""
    boxes, bidx = _split_rois(rois, batch_indices)
    b, height, width, c = features.shape
    p = output_size
    dev = features.device
    boxes = boxes.detach().float()
    x1 = torch.round(boxes[:, 0] * spatial_scale).to(torch.int64)
    y1 = torch.round(boxes[:, 1] * spatial_scale).to(torch.int64)
    x2 = torch.round(boxes[:, 2] * spatial_scale).to(torch.int64)
    y2 = torch.round(boxes[:, 3] * spatial_scale).to(torch.int64)
    roi_w = torch.clamp(x2 - x1 + 1, min=1)
    roi_h = torch.clamp(y2 - y1 + 1, min=1)
    max_bin = max(-(-max(height, width) // p) + 1, 1)
    ph = torch.arange(p, device=dev)

    def bin_bounds(start, roi_size, limit):
        # Integer floor and ceil, exact where a float quotient such as
        # 21 / 7 may round to 3.0000002 and widen the bin.
        lo = (ph[None, :] * roi_size[:, None]) // p + start[:, None]
        hi = ((ph[None, :] + 1) * roi_size[:, None] + p - 1) // p + start[:, None]
        return torch.clamp(lo, 0, limit), torch.clamp(hi, 0, limit)

    ylo, yhi = bin_bounds(y1, roi_h, height)                   # (R, P)
    xlo, xhi = bin_bounds(x1, roi_w, width)
    xhi = torch.minimum(xhi, xlo + max_bin)     # the window's reach
    span = xhi - xlo                                           # (R, P)

    # tables[j][.., x, :] = max of columns x .. x + 2^j - 1 (where inside).
    levels = max(max_bin.bit_length() - 1, 0)
    tables = [features]
    for j in range(1, levels + 1):
        t, h = tables[-1], 1 << (j - 1)
        tables.append(torch.cat([torch.maximum(t[:, :, :-h], t[:, :, h:]),
                                 t[:, :, width - h:]], dim=2))
    flat = torch.stack(tables).reshape(-1, c)       # ((J+1)*B*H*W, C)
    level = sum((span >= (1 << j)).to(torch.int64) for j in range(1, levels + 1)) \
        if levels else torch.zeros_like(span)
    right = xhi - (1 << level)                                 # (R, P)

    win = torch.arange(max_bin, device=dev)
    ycells = ylo[:, :, None] + win                             # (R, P, max_bin)
    yvalid = (ycells < yhi[:, :, None])[:, :, :, None] & (span > 0)[:, None, None, :]
    ycells = torch.clamp(ycells, max=height - 1)
    row = ((level[:, None, None, :] * b + bidx[:, None, None, None]) * height
           + ycells[:, :, :, None]) * width                    # (R, P, max_bin, P)
    vals = torch.maximum(flat[row + xlo[:, None, None, :].clamp(max=width - 1)],
                         flat[row + right[:, None, None, :].clamp(0, width - 1)])
    vals = torch.where(yvalid[..., None], vals,
                       torch.full_like(vals, float("-inf")))
    out = vals.amax(dim=2)                                     # (R, P, P, C)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def roi_crop(
    features: torch.Tensor,
    rois: torch.Tensor,
    batch_indices: torch.Tensor | None = None,
    *,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
) -> torch.Tensor:
    """RoI crop: a (2P x 2P) grid spanning the roi corner to corner (the
    reference's ``affine_grid`` with aligned corners), bilinearly sampled
    with zero padding, then a 2x2 max: (R, P, P, C)."""
    boxes, bidx = _split_rois(rois, batch_indices)
    b, height, width, c = features.shape
    p = output_size
    g = 2 * p
    flat = features.reshape(b * height * width, c).float()
    boxes = boxes.detach().float()
    x1 = boxes[:, 0] * spatial_scale
    y1 = boxes[:, 1] * spatial_scale
    x2 = boxes[:, 2] * spatial_scale
    y2 = boxes[:, 3] * spatial_scale
    # arange * step, not torch.linspace: this is jnp.linspace's rounding.
    t = torch.arange(g, dtype=torch.float32, device=features.device) * (1.0 / (g - 1))
    ys = y1[:, None] + t[None, :] * (y2 - y1)[:, None]         # (R, G)
    xs = x1[:, None] + t[None, :] * (x2 - x1)[:, None]
    batch_offset = (bidx * (height * width))[:, None, None]
    vals = _bilinear_gather(flat, batch_offset, ys[:, :, None], xs[:, None, :],
                            height, width)                    # (R, G, G, C)
    r = boxes.shape[0]
    return vals.reshape(r, p, 2, p, 2, c).amax(dim=(2, 4)).to(features.dtype)

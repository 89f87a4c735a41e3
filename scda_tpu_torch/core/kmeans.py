"""K-means for SCDA region mining (port of ``scda_tpu/core/kmeans.py``).

A fixed-iteration Lloyd's algorithm with static shapes, batched over
images: points (B, N, D), one clustering per image.  Invalid points are
masked out of the counts and the centre updates (they still get an
assignment; callers gate on the mask).  Nothing here synchronises with
the host: no ``.item()``, no boolean indexing, no Python branch on a
tensor, so on the card mining queues behind the proposals without
stalling the step.

Initialisation is k-means++-style (each centre drawn with probability
proportional to its squared distance to the nearest chosen centre, by the
Gumbel-max trick) when randomness is given, and greedy farthest-point
when not.  Either way a centre cannot repeat an already-chosen point
while distinct valid points remain.  ``init="spread"`` is the older
quantile init: K random valid points, or evenly strided valid points in
stable order; it may pick near-duplicate centres on clustered inputs.

Randomness: a ``torch.Generator`` (noise drawn on its device), or
``draws=`` with the noise itself, so a test can hand in the values JAX
drew (the two packages' random streams differ):

  * ``++``: ``{"g0": (B, N), "gs": (B, K - 1, N)}`` standard Gumbel noise;
  * ``spread``: ``{"u": (B, K)}`` uniforms in [0, 1).

Where two centres are exactly as near to a point, the lower index wins,
as in JAX (``argmin`` / ``argmax`` take the first).  The centre update
sums members in a masked contraction whose summation order may differ
from XLA's, so centres agree with JAX's to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from scda_tpu_torch.core.draws import uniform


def _gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise from ``generator``, moved to ``device``."""
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(generator, shape)
    e = (-torch.log(u.clamp_min(tiny))).clamp_min(tiny)   # exponential, > 0
    return (-torch.log(e)).to(device)


def _take_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, D), idx (B, M) -> (B, M, D)."""
    return torch.gather(points, 1,
                        idx[..., None].expand(-1, -1, points.shape[-1]))


def _init_centers_spread(points, mask, k, u):
    """K valid points: at quantile ``u`` (B, K) of the valid points in
    stable order, or evenly strided when ``u`` is None."""
    b, n, _ = points.shape
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    num_valid = mask.sum(1).clamp_min(1)                       # (B,)
    if u is None:
        u = ((torch.arange(k, dtype=torch.float32, device=points.device)
              + 0.5) / k).expand(b, k)
    pick = (u * num_valid[:, None].float()).to(torch.int64).clamp(0, n - 1)
    return _take_points(points, torch.gather(order, 1, pick))


def _init_centers(points, mask, k, g0, gs):
    """k-means++-style init over valid points.  With noise: the first
    centre is a uniformly random valid point (arg-max of ``g0`` (B, N)),
    each further one drawn by Gumbel-max with ``gs`` (B, K-1, N) on the
    log squared distance to the nearest chosen centre.  Without (both
    None): the first valid point, then greedily the farthest.  Chosen
    points have weight zero; when no point has positive weight (fewer
    distinct valid points than K) any valid point is reused."""
    b, n, _ = points.shape
    neg_inf = torch.full((), -torch.inf, device=points.device)
    if g0 is None:
        first = torch.argmax(mask.to(torch.int8), dim=1)
        gs = torch.zeros((b, max(k - 1, 0), n), device=points.device)
    else:
        first = torch.argmax(torch.where(mask, g0, neg_inf), dim=1)
    c = _take_points(points, first[:, None])                   # (B, 1, D)
    mind2 = torch.sum((points - c) ** 2, dim=-1)               # (B, N)
    centers = [c]
    for j in range(k - 1):
        g = gs[:, j]
        w = torch.where(mask, mind2, torch.zeros_like(mind2))
        score = torch.where(w > 0, torch.log(w.clamp_min(1e-30)) + g, neg_inf)
        fallback = torch.argmax(torch.where(mask, g, neg_inf), dim=1)
        idx = torch.where((w > 0).any(1), torch.argmax(score, dim=1), fallback)
        c = _take_points(points, idx[:, None])
        mind2 = torch.minimum(mind2, torch.sum((points - c) ** 2, dim=-1))
        centers.append(c)
    return torch.cat(centers, dim=1)


def _assign(points, centers):
    d2 = torch.sum((points[:, :, None, :] - centers[:, None, :, :]) ** 2,
                   dim=-1)                                     # (B, N, K)
    return torch.argmin(d2, dim=2)


def _onehot(assign, k, fmask):
    return ((assign[..., None] == torch.arange(k, device=assign.device))
            .float() * fmask[..., None])                       # (B, N, K)


@torch.no_grad()
def kmeans(
    points: torch.Tensor,
    k: int,
    *,
    mask: Optional[torch.Tensor] = None,
    iters: int = 10,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    init: str = "++",
):
    """Lloyd's k-means with static shapes, one clustering per image.

    Args:
      points: (B, N, D) float, or (N, D) for one clustering.
      k: number of clusters.
      mask: optional (B, N) bool validity.
      iters: fixed iteration count.
      generator / draws: randomness of the init (module docstring); with
        neither the init is deterministic.
      init: ``"++"`` (default) or ``"spread"``.

    Returns:
      centers (B, K, D) f32, assign (B, N) int64, counts (B, K) int64 of
      valid members per cluster; without the leading B for (N, D) input.
    """
    if init not in ("++", "spread"):
        raise ValueError(f"unknown kmeans init {init!r}")
    single = points.dim() == 2
    if single:
        points = points[None]
        mask = None if mask is None else mask[None]
        draws = None if draws is None else {n: t[None] for n, t in draws.items()}
    points = points.float()
    b, n, _ = points.shape
    dev = points.device
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    fmask = mask.float()

    if init == "++":
        g0 = gs = None
        if draws is not None:
            g0, gs = draws["g0"], draws["gs"]
        elif generator is not None:
            g0 = _gumbel(generator, (b, n), dev)
            gs = _gumbel(generator, (b, max(k - 1, 0), n), dev)
        centers = _init_centers(points, mask, k, g0, gs)
    else:
        u = None
        if draws is not None:
            u = draws["u"]
        elif generator is not None:
            u = uniform(generator, (b, k)).to(dev)
        centers = _init_centers_spread(points, mask, k, u)

    for _ in range(iters):
        onehot = _onehot(_assign(points, centers), k, fmask)
        counts = onehot.sum(1)                                 # (B, K)
        sums = torch.einsum("bnk,bnd->bkd", onehot, points)
        new = sums / counts.clamp_min(1.0)[..., None]
        # Empty clusters stay where they were.
        centers = torch.where(counts[..., None] > 0, new, centers)
    assign = _assign(points, centers)
    counts = _onehot(assign, k, fmask).sum(1).to(torch.int64)
    if single:
        return centers[0], assign[0], counts[0]
    return centers, assign, counts

"""SCDA region mining (port of ``scda_tpu/adapt/region_mining.py``):
cluster the RPN's proposals into K instance groups.

Take the top ``mining_top_n`` proposals of each image, k-means their
centres into ``num_groups`` groups, and form one region per group: the
tight box around the member proposals ("where to look"), weighted by
the share of proposals that fell into the group ("how to align").

K-means is :mod:`scda_tpu_torch.core.kmeans`, batched over the images
and free of host synchronisation, so mining stays on the device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from scda_tpu_torch.config import AdaptConfig
from scda_tpu_torch.core.kmeans import kmeans


class MinedRegions(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) union box per group
    weights: torch.Tensor  # (B, K) proposal-count weights, sum to 1 per image
    valid: torch.Tensor    # (B, K) bool (non-empty groups)


@torch.no_grad()
def mine_regions(
    prop_boxes: torch.Tensor,  # (B, N, 4), sorted by score (NMS keep order)
    prop_valid: torch.Tensor,  # (B, N)
    cfg: AdaptConfig,
    generator: Optional[torch.Generator] = None,
    *,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> MinedRegions:
    """``generator`` / ``draws`` feed the k-means init
    (:func:`scda_tpu_torch.core.kmeans.kmeans`)."""
    top_n = min(cfg.mining_top_n, prop_boxes.shape[1])
    k = cfg.num_groups
    boxes = prop_boxes[:, :top_n].float()
    mask = prop_valid[:, :top_n]
    centers = torch.stack([0.5 * (boxes[..., 0] + boxes[..., 2]),
                           0.5 * (boxes[..., 1] + boxes[..., 3])], dim=-1)
    _, assign, counts = kmeans(centers, k, mask=mask, iters=cfg.kmeans_iters,
                               generator=generator, draws=draws,
                               init=cfg.kmeans_init)
    member = ((assign[:, None, :] == torch.arange(k, device=boxes.device)
               [None, :, None]) & mask[:, None, :])             # (B, K, N)

    big = 1e9
    lo = torch.where(member[..., None], boxes[:, None, :, :2],
                     torch.full((), big, device=boxes.device)).amin(2)
    hi = torch.where(member[..., None], boxes[:, None, :, 2:],
                     torch.full((), -big, device=boxes.device)).amax(2)
    valid = counts > 0
    group_boxes = torch.where(valid[..., None], torch.cat([lo, hi], dim=-1),
                              torch.zeros((), device=boxes.device))
    weights = counts.float()
    weights = weights / weights.sum(1, keepdim=True).clamp_min(1.0)
    return MinedRegions(boxes=group_boxes, weights=weights, valid=valid)

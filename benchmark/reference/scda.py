"""SCDA's region mining (batched k-means over proposal centres), the patch
discriminator, the gradient reversal and the count-weighted domain loss,
in plain PyTorch.

Frozen arithmetic copied from ``scda_tpu_torch/core/kmeans.py``,
``adapt/region_mining.py``, ``models/discriminator.py``,
``core/grad_reverse.py`` and ``adapt/scda.py`` at commit 8b959ad8dec4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import nets as N
from benchmark.reference.precision import Precision


def _gumbel(generator, shape, device):
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    e = (-torch.log(u.clamp_min(tiny))).clamp_min(tiny)
    return (-torch.log(e)).to(device)


def _take(points, idx):
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def _assign(points, centers):
    d2 = torch.sum((points[:, :, None, :] - centers[:, None, :, :]) ** 2, dim=-1)
    return torch.argmin(d2, dim=2)


def _onehot(assign, k, fmask):
    return ((assign[..., None] == torch.arange(k, device=assign.device))
            .float() * fmask[..., None])


@torch.no_grad()
def kmeans(points, k: int, mask, iters: int, generator):
    """Lloyd's k-means with a k-means++ init by the Gumbel-max trick, one
    clustering an image: points (B, N, D) -> (assign (B, N), counts (B, K))."""
    points = points.float()
    b, n, _ = points.shape
    dev = points.device
    fmask = mask.float()
    g0 = _gumbel(generator, (b, n), dev)
    gs = _gumbel(generator, (b, max(k - 1, 0), n), dev)
    neg_inf = torch.full((), -torch.inf, device=dev)
    first = torch.argmax(torch.where(mask, g0, neg_inf), dim=1)
    c = _take(points, first[:, None])
    mind2 = torch.sum((points - c) ** 2, dim=-1)
    centers = [c]
    for j in range(k - 1):
        g = gs[:, j]
        w = torch.where(mask, mind2, torch.zeros_like(mind2))
        score = torch.where(w > 0, torch.log(w.clamp_min(1e-30)) + g, neg_inf)
        fallback = torch.argmax(torch.where(mask, g, neg_inf), dim=1)
        idx = torch.where((w > 0).any(1), torch.argmax(score, dim=1), fallback)
        c = _take(points, idx[:, None])
        mind2 = torch.minimum(mind2, torch.sum((points - c) ** 2, dim=-1))
        centers.append(c)
    centers = torch.cat(centers, dim=1)
    for _ in range(iters):
        onehot = _onehot(_assign(points, centers), k, fmask)
        counts = onehot.sum(1)
        sums = torch.einsum("bnk,bnd->bkd", onehot, points)
        new = sums / counts.clamp_min(1.0)[..., None]
        centers = torch.where(counts[..., None] > 0, new, centers)
    assign = _assign(points, centers)
    return assign, _onehot(assign, k, fmask).sum(1).to(torch.int64)


@torch.no_grad()
def mine(prop_boxes, prop_valid, ac, generator):
    """Top ``mining_top_n`` proposals k-means'd by centre into
    ``num_groups`` regions: (boxes (B, K, 4), weights (B, K), valid)."""
    top_n = min(ac.mining_top_n, prop_boxes.shape[1])
    k = ac.num_groups
    boxes = prop_boxes[:, :top_n].float()
    mask = prop_valid[:, :top_n]
    centers = torch.stack([0.5 * (boxes[..., 0] + boxes[..., 2]),
                           0.5 * (boxes[..., 1] + boxes[..., 3])], dim=-1)
    assign, counts = kmeans(centers, k, mask, ac.kmeans_iters, generator)
    member = ((assign[:, None, :] == torch.arange(k, device=boxes.device)
               [None, :, None]) & mask[:, None, :])
    big = 1e9
    lo = torch.where(member[..., None], boxes[:, None, :, :2],
                     torch.full((), big, device=boxes.device)).amin(2)
    hi = torch.where(member[..., None], boxes[:, None, :, 2:],
                     torch.full((), -big, device=boxes.device)).amax(2)
    valid = counts > 0
    gb = torch.where(valid[..., None], torch.cat([lo, hi], dim=-1),
                     torch.zeros((), device=boxes.device))
    w = counts.float()
    return gb, w / w.sum(1, keepdim=True).clamp_min(1.0), valid


class GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


def discriminator(D, patches_nhwc, prec: Precision):
    """Region patches (R, P, P, C) -> domain logits (R,)."""
    x = patches_nhwc.float().permute(0, 3, 1, 2)
    x = F.leaky_relu(N.conv(prec, x, D["conv1.weight"], D["conv1.bias"],
                            padding=1), 0.2)
    x = F.leaky_relu(N.conv(prec, x, D["conv2.weight"], D["conv2.bias"],
                            stride=2, padding=1), 0.2)
    x = F.leaky_relu(N.conv(prec, x, D["conv3.weight"], D["conv3.bias"],
                            padding=1), 0.2)
    return N.linear(prec, x.mean(dim=(2, 3)), D["fc.weight"], D["fc.bias"])[..., 0]


def weighted_bce(logits, weights, valid, domain: int):
    labels = torch.full_like(logits, float(domain))
    per = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    w = torch.where(valid, weights, torch.zeros_like(weights))
    return torch.sum(per * w) / w.sum().clamp_min(1e-6)

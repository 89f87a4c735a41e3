"""The detectors' networks in plain float32 PyTorch, over a flat dict of
weights named as the reference lineage names them (``RCNN_base``,
``RCNN_rpn``, ``RCNN_top``, ``RCNN_cls_score``, ``RCNN_bbox_pred``,
``RCNN_c3_proj``).

Frozen arithmetic copied from ``scda_tpu_torch/models`` (``faster_rcnn.py``,
``backbones/vgg.py``, ``backbones/resnet.py``, ``rpn.py``) and
``scda_tpu_torch/ops/roi_ops.py`` at commit 8b959ad8dec4, with every
kernel written out as what it computes: the VGG stem as two
convolutions, ReLUs and a 2x2 max pool; each ResNet identity tail as its
blocks one by one with the batch norms unfolded; RoI-Align as the two
contractions against per-axis weights.  Images and maps are NCHW here;
RoI-Align takes and gives NHWC, as the program's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

VGG16_LAYOUT = (
    (0, 64), (2, 64), "M",
    (5, 128), (7, 128), "M",
    (10, 256), (12, 256), (14, 256), "M",
    (17, 512), (19, 512), (21, 512), "M",
    (24, 512), (26, 512), (28, 512),
)
VGG16_FROZEN = ("RCNN_base.0", "RCNN_base.2", "RCNN_base.5", "RCNN_base.7")
RESNET_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def conv(prec: Precision, x, w, b=None, **kw):
    return prec.product(lambda u, v, c: F.conv2d(u, v, c, **kw), x, w,
                        None if b is None else b.float())


def linear(prec: Precision, x, w, b=None):
    return prec.product(F.linear, x, w, None if b is None else b.float())


class MaxPool2x2(torch.autograd.Function):
    """2x2 max pool whose backward splits the cotangent evenly among tied
    maxima (the program's and the JAX package's rule)."""

    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x, 2, 2)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        up = lambda t: t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        is_max = (x == up(y)).to(g.dtype)
        ties = F.avg_pool2d(is_max, 2, 2) * 4.0
        return is_max * up(g / ties)


# ---- backbones -------------------------------------------------------------

def vgg16_features(P, x, prec: Precision, pyramid: bool = False):
    """(B, 3, H, W) -> conv5_3 (B, 512, H/16, W/16); with ``pyramid``
    (conv4_3 at stride 8, conv5_3)."""
    pools, f8 = 0, None
    for item in VGG16_LAYOUT:
        if item == "M":
            if pools == 3:
                f8 = x
            x = MaxPool2x2.apply(x)
            pools += 1
            continue
        i, _ = item
        x = F.relu(conv(prec, x, P[f"RCNN_base.{i}.weight"],
                        P[f"RCNN_base.{i}.bias"], padding=1))
    return (f8, x) if pyramid else x


def frozen_bn(P, prefix: str, x, eps: float = 1e-5):
    """Batch norm with constant statistics: ``x * mult + add``, both
    worked out in float32 (the root through float64, as the program's)."""
    w, b = P[prefix + ".weight"].float(), P[prefix + ".bias"].float()
    mean, var = P[prefix + ".running_mean"].float(), P[prefix + ".running_var"].float()
    root = torch.sqrt((var + eps).double()).float()
    mult = w / root
    add = b - mean * w / root
    return x * mult.view(1, -1, 1, 1) + add.view(1, -1, 1, 1)


def bottleneck(P, pre: str, x, stride: int, down: bool, prec: Precision):
    out = F.relu(frozen_bn(P, pre + ".bn1",
                           conv(prec, x, P[pre + ".conv1.weight"])))
    out = F.relu(frozen_bn(P, pre + ".bn2",
                           conv(prec, out, P[pre + ".conv2.weight"],
                                stride=stride, padding=1)))
    out = frozen_bn(P, pre + ".bn3", conv(prec, out, P[pre + ".conv3.weight"]))
    res = x
    if down:
        res = frozen_bn(P, pre + ".downsample.1",
                        conv(prec, x, P[pre + ".downsample.0.weight"],
                             stride=stride))
    return F.relu(out + res)


def resnet_features(P, x, depth: int, prec: Precision, pyramid: bool = False):
    """conv1 .. layer3: (B, 3, H, W) -> (B, 1024, H/16, W/16); with
    ``pyramid`` (layer2's stride-8 map, layer3's)."""
    blocks = RESNET_DEPTHS[depth]
    x = conv(prec, x, P["RCNN_base.0.weight"], stride=2, padding=3)
    x = F.max_pool2d(F.relu(frozen_bn(P, "RCNN_base.1", x)), 3, 2, padding=1)
    f8 = None
    for mod, n, stride in ((4, blocks[0], 1), (5, blocks[1], 2),
                           (6, blocks[2], 2)):
        for b in range(n):
            x = bottleneck(P, f"RCNN_base.{mod}.{b}", x,
                           stride if b == 0 else 1, b == 0, prec)
        if mod == 5:
            f8 = x
    return (f8, x) if pyramid else x


def tiny_features(P, x, prec: Precision, pyramid: bool = False):
    """The program's test backbone: four conv, relu, 2x2 max-pool stages."""
    f8 = None
    for i, idx in enumerate((0, 3, 6, 9)):
        x = F.max_pool2d(F.relu(conv(prec, x, P[f"RCNN_base.{idx}.weight"],
                                     P[f"RCNN_base.{idx}.bias"], padding=1)), 2, 2)
        if i == 2:
            f8 = x
    return (f8, x) if pyramid else x


def resnet_frozen(fixed_blocks: int):
    return ("RCNN_base.0", "RCNN_base.1") + tuple(
        f"RCNN_base.{i + 3}" for i in range(1, min(max(fixed_blocks, 0), 3) + 1))


def frozen_prefixes(mc) -> tuple:
    if mc.backbone == "tiny":
        return ()
    return VGG16_FROZEN if mc.backbone == "vgg16" else resnet_frozen(
        mc.resnet_fixed_blocks)


def features(P, image_nhwc, mc, prec: Precision, pyramid: bool = False):
    """Image (B, H, W, 3) -> NHWC features: the stride-16 map, or with
    ``pyramid`` (the stride-8 map projected to the stride-16 channels by
    ``RCNN_c3_proj``, the stride-16 map)."""
    x = image_nhwc.permute(0, 3, 1, 2).float().contiguous()
    if mc.backbone == "vgg16":
        out = vgg16_features(P, x, prec, pyramid)
    elif mc.backbone == "tiny":
        out = tiny_features(P, x, prec, pyramid)
    else:
        out = resnet_features(P, x, int(mc.backbone[len("resnet"):]), prec,
                              pyramid)
    if not pyramid:
        return out.permute(0, 2, 3, 1)
    f8, f16 = (t.permute(0, 2, 3, 1) for t in out)
    w = P["RCNN_c3_proj.weight"]
    f8 = linear(prec, f8, w.reshape(w.shape[0], -1), P["RCNN_c3_proj.bias"])
    return f8, f16


def rpn_out(P, feat_nhwc, prec: Precision, num_anchors: int = 9):
    """NHWC features -> cls logits (B, h, w, A, 2), deltas (B, h, w, A, 4)."""
    a = num_anchors
    x = feat_nhwc.permute(0, 3, 1, 2)
    x = F.relu(conv(prec, x, P["RCNN_rpn.RPN_Conv.weight"],
                    P["RCNN_rpn.RPN_Conv.bias"], padding=1))
    cls = conv(prec, x, P["RCNN_rpn.RPN_cls_score.weight"],
               P["RCNN_rpn.RPN_cls_score.bias"])
    bbox = conv(prec, x, P["RCNN_rpn.RPN_bbox_pred.weight"],
                P["RCNN_rpn.RPN_bbox_pred.bias"])
    b, _, h, w = cls.shape
    cls = cls.permute(0, 2, 3, 1).reshape(b, h, w, 2, a).transpose(3, 4)
    bbox = bbox.permute(0, 2, 3, 1).reshape(b, h, w, a, 4)
    return cls, bbox


# ---- RoI-Align -------------------------------------------------------------

def _axis_weights(coords, size: int):
    """Per-sample bilinear weights on the grid, averaged over the samples:
    (..., S) -> (..., size).  Samples outside [-1, size] drop, in-range
    samples clamp."""
    s = coords.shape[-1]
    valid = ((coords >= -1.0) & (coords <= float(size))).float()
    c = torch.clamp(coords, 0.0, size - 1.0)
    c0 = torch.floor(c)
    low = c0.to(torch.int64)
    high = torch.clamp(low + 1, max=size - 1)
    w_high = (c - c0) * valid
    w_low = (1.0 - (c - c0)) * valid
    grid = torch.arange(size, device=coords.device)
    w = (w_low[..., None] * (grid == low[..., None])
         + w_high[..., None] * (grid == high[..., None]))
    return torch.sum(w, dim=-2) / float(s)


def roi_align(feat_nhwc, rois, *, output_size: int, spatial_scale: float,
              sampling_ratio: int):
    """Torchvision-spec RoI-Align (not ``aligned``) of grouped rois (B, R, 4)
    in image coords: (B, R, P, P, C) in float32."""
    _, height, width, _ = feat_nhwc.shape
    p, s = output_size, max(int(sampling_ratio), 1)
    dev = rois.device
    boxes = rois.detach().float()
    x1, y1 = boxes[..., 0] * spatial_scale, boxes[..., 1] * spatial_scale
    x2, y2 = boxes[..., 2] * spatial_scale, boxes[..., 3] * spatial_scale
    bin_w = torch.clamp(x2 - x1, min=1.0) / p
    bin_h = torch.clamp(y2 - y1, min=1.0) / p
    ph = torch.arange(p, dtype=torch.float32, device=dev)
    f = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    ys = y1[..., None, None] + (ph[:, None] + f[None, :]) * bin_h[..., None, None]
    xs = x1[..., None, None] + (ph[:, None] + f[None, :]) * bin_w[..., None, None]
    wy, wx = _axis_weights(ys, height), _axis_weights(xs, width)
    tmp = torch.einsum("brph,bhwc->brpwc", wy, feat_nhwc.float())
    return torch.einsum("brqw,brpwc->brpqc", wx, tmp)


def pool(feat_nhwc, rois, mc, output_size: int | None = None):
    """Grouped rois (B, R, 4) -> flat (B * R, P, P, C)."""
    out = roi_align(feat_nhwc, rois, output_size=output_size or mc.pooling_size,
                    spatial_scale=1.0 / mc.feat_stride,
                    sampling_ratio=mc.sampling_ratio)
    return out.reshape((-1,) + tuple(out.shape[2:]))


def pool_multiscale(f8, f16, rois, mc):
    """Level-assigned RoI-Align: a roi whose sqrt-area is below
    ``ms_fine_threshold`` pools from the stride-8 level, others from
    stride 16."""
    wh = (torch.clamp(rois[..., 2] - rois[..., 0], min=0.0)
          * torch.clamp(rois[..., 3] - rois[..., 1], min=0.0))
    fine = torch.sqrt(wh) < mc.ms_fine_threshold
    kw = dict(output_size=mc.pooling_size, sampling_ratio=mc.sampling_ratio)
    p16 = roi_align(f16, rois, spatial_scale=1.0 / 16.0, **kw)
    p8 = roi_align(f8, rois, spatial_scale=1.0 / 8.0, **kw)
    out = torch.where(fine[..., None, None, None], p8, p16)
    return out.reshape((-1,) + tuple(out.shape[2:]))


# ---- heads -----------------------------------------------------------------

def dropout(x, rate: float, generator: torch.Generator):
    """Keep with probability 1 - rate, scaled by 1 / (1 - rate); the
    uniforms are drawn from ``generator`` on its device."""
    keep = 1.0 - rate
    u = torch.rand(tuple(x.shape), generator=generator,
                   device=generator.device)
    return torch.where(u.to(x.device) < keep, x / keep, torch.zeros_like(x))


def roi_head(P, pooled_nhwc, mc, prec: Precision, train: bool = False,
             generator=None):
    """Pooled (R, P, P, C) -> (cls logits (R, classes), deltas)."""
    if mc.backbone == "vgg16":
        x = pooled_nhwc.permute(0, 3, 1, 2).reshape(pooled_nhwc.shape[0], -1)
        for i in (0, 3):
            x = F.relu(linear(prec, x, P[f"RCNN_top.{i}.weight"],
                              P[f"RCNN_top.{i}.bias"]))
            if train:
                x = dropout(x, 0.5, generator)
    elif mc.backbone == "tiny":
        x = F.relu(linear(prec, pooled_nhwc.reshape(pooled_nhwc.shape[0], -1),
                          P["RCNN_top.0.weight"], P["RCNN_top.0.bias"]))
    else:
        blocks = RESNET_DEPTHS[int(mc.backbone[len("resnet"):])][3]
        x = pooled_nhwc.permute(0, 3, 1, 2).contiguous()
        for b in range(blocks):
            x = bottleneck(P, f"RCNN_top.0.{b}", x, 2 if b == 0 else 1,
                           b == 0, prec)
        x = x.mean(dim=(2, 3))
    cls = linear(prec, x, P["RCNN_cls_score.weight"], P["RCNN_cls_score.bias"])
    bbox = linear(prec, x, P["RCNN_bbox_pred.weight"], P["RCNN_bbox_pred.bias"])
    return cls, bbox

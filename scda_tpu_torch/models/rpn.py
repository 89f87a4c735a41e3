"""Region Proposal Network: head module and fixed-size proposal layer
(port of ``scda_tpu/models/rpn.py``).

The head keeps the reference's parameters: ``RPN_Conv`` (3x3),
``RPN_cls_score`` (1x1, channels class-major ``[bg x A, fg x A]``) and
``RPN_bbox_pred`` (1x1, channels ``a * 4 + d``).  Its outputs are laid
out as the JAX head's, (B, H, W, A, 2) and (B, H, W, A, 4), whose
flattening matches :func:`scda_tpu_torch.core.boxes.shift_anchors`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from scda_tpu_torch.config import ProposalConfig
from scda_tpu_torch.core import boxes as box_ops
from scda_tpu_torch.ops.nms import batched_nms
from scda_tpu_torch.utils.profile import span


class RPNHead(nn.Module):
    """3x3 conv + relu + twin 1x1 heads on NHWC features."""

    def __init__(self, in_channels: int, channels: int = 512,
                 num_anchors: int = 9, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.RPN_Conv = nn.Conv2d(in_channels, channels, 3, padding=1)
        self.RPN_cls_score = nn.Conv2d(channels, 2 * num_anchors, 1)
        self.RPN_bbox_pred = nn.Conv2d(channels, 4 * num_anchors, 1)
        self.num_anchors = num_anchors
        self.dtype = dtype

    def forward(self, feat: torch.Tensor):
        dt = self.dtype
        a = self.num_anchors
        x = feat.permute(0, 3, 1, 2).to(dt)
        x = F.relu(F.conv2d(x, self.RPN_Conv.weight.to(dt),
                            self.RPN_Conv.bias.to(dt), padding=1))
        cls = F.conv2d(x, self.RPN_cls_score.weight.to(dt),
                       self.RPN_cls_score.bias.to(dt))
        bbox = F.conv2d(x, self.RPN_bbox_pred.weight.to(dt),
                        self.RPN_bbox_pred.bias.to(dt))
        b, _, h, w = cls.shape
        # Class-major channels c * A + a -> (B, H, W, A, 2).
        cls = cls.permute(0, 2, 3, 1).reshape(b, h, w, 2, a).transpose(3, 4)
        bbox = bbox.permute(0, 2, 3, 1).reshape(b, h, w, a, 4)
        return cls.float(), bbox.float()


class Proposals(NamedTuple):
    boxes: torch.Tensor   # (B, N, 4) float32, canvas coords
    scores: torch.Tensor  # (B, N) float32 fg scores
    valid: torch.Tensor   # (B, N) bool


@torch.no_grad()
def propose(
    rpn_cls_logits: torch.Tensor,   # (B, H, W, A, 2)
    rpn_bbox_pred: torch.Tensor,    # (B, H, W, A, 4)
    anchors: torch.Tensor,          # (H*W*A, 4)
    im_info: torch.Tensor,          # (B, 3): valid_h, valid_w, scale
    cfg: ProposalConfig,
) -> Proposals:
    """Fixed-size proposals: softmax fg score -> decode on anchors -> clip
    to the image's valid extent -> mask boxes below ``min_size * scale``
    -> top ``pre_nms_top_n`` -> NMS -> ``post_nms_top_n`` slots with a
    validity mask.  Runs without gradients, as the reference's proposal
    layer does."""
    with span("propose"):
        b = rpn_cls_logits.shape[0]
        k = anchors.shape[0]
        scores = torch.softmax(rpn_cls_logits, dim=-1)[..., 1].reshape(b, k)
        deltas = rpn_bbox_pred.reshape(b, k, 4)

        boxes = box_ops.bbox_transform_inv(anchors[None], deltas)
        boxes = box_ops.clip_boxes(boxes, im_info[:, 0:1], im_info[:, 1:2])
        ws = boxes[..., 2] - boxes[..., 0] + box_ops.LEGACY_PLUS_ONE
        hs = boxes[..., 3] - boxes[..., 1] + box_ops.LEGACY_PLUS_ONE
        min_size = cfg.min_size * im_info[:, 2:3]
        size_ok = (ws >= min_size) & (hs >= min_size)
        scores = torch.where(size_ok, scores, torch.full_like(scores, -1e30))

        pre_n = min(cfg.pre_nms_top_n, k)
        top_scores, top_idx = torch.sort(scores, dim=-1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :pre_n], top_idx[:, :pre_n]
        top_boxes = torch.gather(boxes, 1,
                                 top_idx[..., None].expand(b, pre_n, 4))
        top_valid = top_scores > -1e29

        # The sort already put the rows in descending order, invalid last.
        res = batched_nms(top_boxes, top_scores,
                          iou_threshold=cfg.nms_thresh,
                          max_output=cfg.post_nms_top_n, valid=top_valid,
                          pre_sorted=True)
        out_boxes = torch.gather(top_boxes, 1,
                                 res.indices[..., None].expand(-1, -1, 4))
        out_scores = torch.gather(top_scores, 1, res.indices)
        out_boxes = torch.where(res.valid[..., None], out_boxes,
                                torch.zeros_like(out_boxes))
        out_scores = torch.where(res.valid, out_scores,
                                 torch.zeros_like(out_scores))
        return Proposals(boxes=out_boxes, scores=out_scores, valid=res.valid)

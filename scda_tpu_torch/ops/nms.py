"""Fixed-size greedy NMS (port of ``scda_tpu/ops/nms.py``).

Sort by score, then the keep mask of kernel K1
(:func:`scda_tpu_torch.ops.kernels.nms_kernel.nms_sorted`), then a
fixed-size ``NmsResult``: ``max_output`` indices into the caller's boxes
in score order, plus a validity mask.  Nothing here syncs with the host.

The JAX package picks its lax loop or its Pallas kernel with
``SCDA_NMS_IMPL``; the port has one path, so it reads no such switch.

Ties: ``lax.top_k`` puts the lower index first among equal scores, so the
sort here is ``torch.sort(descending=True, stable=True)``, never
``torch.topk``.  Padded canvas regions give exactly tied RPN scores.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scda_tpu_torch.ops.kernels.nms_kernel import nms_sorted

_NEG_INF = -1e30


class NmsResult(NamedTuple):
    indices: torch.Tensor  # (..., max_output) int64 indices into the input
    valid: torch.Tensor    # (..., max_output) bool


def _keep_mask_to_result(keep: torch.Tensor, order: torch.Tensor,
                         max_output: int) -> NmsResult:
    """(B, N) keep mask over sorted boxes -> (B, max_output) result in the
    caller's index space, in score order.  A cumsum and a scatter instead
    of ``torch.nonzero``, which syncs with the host."""
    b, n = keep.shape
    pos = torch.cumsum(keep, dim=-1) - 1
    slot = torch.where(keep & (pos < max_output), pos,
                       torch.full_like(pos, max_output))
    kept_pos = torch.zeros((b, max_output + 1), dtype=torch.int64,
                           device=keep.device)
    src = torch.arange(n, device=keep.device).expand(b, n)
    # Slot max_output collects everything not kept and is dropped.
    kept_pos.scatter_(1, slot, src)
    kept_pos = kept_pos[:, :max_output]
    count = keep.sum(dim=-1, keepdim=True)
    out_valid = torch.arange(max_output, device=keep.device)[None] < count
    out_idx = torch.where(out_valid, torch.gather(order, 1, kept_pos),
                          torch.zeros_like(kept_pos))
    return NmsResult(indices=out_idx, valid=out_valid)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    *,
    iou_threshold: float,
    max_output: int,
    valid: torch.Tensor | None = None,
    pre_sorted: bool = False,
) -> NmsResult:
    """Greedy NMS over a leading batch (or class) dimension.

    boxes (B, N, 4), scores (B, N), valid (B, N) bool or None.
    ``pre_sorted``: the caller guarantees each row is already in
    descending score order with invalid slots last (true straight out of
    the proposal top-k), so the sort is skipped.
    Returns NmsResult with (B, max_output) fields; invalid slots hold
    index 0 — always gate on the mask.
    """
    b, n = scores.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=scores.device)
    boxes = boxes.float()
    if pre_sorted:
        order = torch.arange(n, device=scores.device).expand(b, n)
        sboxes, svalid = boxes, valid
    else:
        masked = torch.where(valid, scores.float(),
                             torch.full_like(scores, _NEG_INF,
                                             dtype=torch.float32))
        sorted_scores, order = torch.sort(masked, dim=-1, descending=True,
                                          stable=True)
        sboxes = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
        svalid = sorted_scores > _NEG_INF * 0.5
    keep = nms_sorted(sboxes.contiguous(), svalid.contiguous(),
                      iou_threshold=iou_threshold, max_output=max_output)
    return _keep_mask_to_result(keep, order, max_output)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    *,
    iou_threshold: float,
    max_output: int,
    valid: torch.Tensor | None = None,
    pre_sorted: bool = False,
) -> NmsResult:
    """Greedy NMS of one set: boxes (N, 4), scores (N,) -> NmsResult with
    (max_output,) fields.  See :func:`batched_nms`."""
    res = batched_nms(
        boxes[None], scores[None], iou_threshold=iou_threshold,
        max_output=max_output,
        valid=None if valid is None else valid[None], pre_sorted=pre_sorted,
    )
    return NmsResult(indices=res.indices[0], valid=res.valid[0])

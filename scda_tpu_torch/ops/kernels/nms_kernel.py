"""Greedy NMS over score-sorted boxes: CUDA kernel K1 and its plain twin.

Replaces ``scda_tpu/ops/pallas/nms_kernel.py:nms_sorted_pallas`` (used by
both NMS call sites of the inference path: proposals, (B, 6000) boxes at
IoU 0.7 down to 300; per-class test NMS, (B*8, 300) boxes at 0.3 down
to 100; and by the training proposals, (B, 12000) down to 2000).  The
kernel is ``csrc/nms.cu``, two launches, neither syncing with the host:

* a parallel pass builds the 64-bit suppression bitmask of each row
  (bit k of ``mask[i][w]``: box i suppresses box 64 w + k).  It is
  arithmetic over N^2/2 pairs, so the correctly rounded division of the
  test below decides only the pairs within 2^-20 of the threshold; a
  division-free screen settles the rest, and 64-box blocks with no valid
  box are skipped;
* one 512-thread block per row scans it greedily, one step per 64-box
  word: the word's diagonal and the next two columns are prefetched into
  shared memory (their addresses depend on no data), one warp resolves
  the word's keeps from shared memory, then all kept boxes OR their rows
  into ``removed`` at once, with the loads of the far columns started
  three steps before they are needed.  It stops at ``max_output`` keeps.

On the H100 the mask pass is bound by arithmetic and the scan by a serial
chain of one shared-memory round trip per word walked.

The keep mask equals the plain twin's bit for bit: both follow
``_iou_matrix``'s operation order (the kernel with non-contracting _rn
intrinsics), suppress on ``IoU > thr``, and keep greedily in row order.
"""

from __future__ import annotations

import ctypes

import torch

from scda_tpu_torch.ops.kernels import _build

# The scan keeps three 64-bit words per 64 boxes of a row in static shared
# memory: ``kMaxWords`` = 1024 words in ``csrc/nms.cu``.
_MAX_BOXES = 1024 * 64


def _iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., N, 4) x (..., M, 4) -> (..., N, M), +1 sizes,
    in the operation order of the TPU kernel's ``_iou_matrix``."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, k] for k in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, k] for k in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + 1.0,
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + 1.0,
                     min=0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def nms_sorted_plain(sboxes: torch.Tensor, svalid: torch.Tensor, *,
                     iou_threshold: float, max_output: int) -> torch.Tensor:
    """Plain PyTorch twin of :func:`nms_sorted`: the full IoU matrix, then
    the greedy walk over the sorted boxes, one box per step."""
    squeeze = sboxes.dim() == 2
    if squeeze:
        sboxes, svalid = sboxes[None], svalid[None]
    n = sboxes.shape[1]
    iou = _iou_matrix(sboxes.float(), sboxes.float())
    later = torch.ones(n, n, dtype=torch.bool, device=sboxes.device).triu(1)
    suppresses = (iou > iou_threshold) & later
    alive = svalid.clone()
    for i in range(n):
        # alive[:, i] is final here: every earlier keep has been applied.
        alive &= ~(suppresses[:, i, :] & alive[:, i:i + 1])
    keep = alive & (torch.cumsum(alive, dim=-1) <= max_output)
    return keep[0] if squeeze else keep


def nms_sorted(sboxes: torch.Tensor, svalid: torch.Tensor, *,
               iou_threshold: float, max_output: int) -> torch.Tensor:
    """Batched greedy NMS over per-row score-sorted boxes.

    sboxes (B, N, 4) float32 and svalid (B, N) bool, or (N, 4) and (N,).
    Returns the keep mask of svalid's shape: per row, the kept boxes in
    order are the NMS output, at most ``max_output`` of them.  CPU tensors
    take the plain twin; CUDA tensors launch the kernel.  A keep mask has
    no gradient: raises if grad mode is on and the boxes require grad
    (the proposal layer runs under ``no_grad``, as JAX's stops it).
    """
    _build.refuse_grad("nms_sorted", (sboxes,),
                       "a keep mask passes no gradient back: detach the "
                       "boxes or run under torch.no_grad()")
    if sboxes.device.type == "cpu":
        return nms_sorted_plain(sboxes, svalid, iou_threshold=iou_threshold,
                                max_output=max_output)
    squeeze = sboxes.dim() == 2
    if squeeze:
        sboxes, svalid = sboxes[None], svalid[None]
    if sboxes.device.type != "cuda" or svalid.device != sboxes.device:
        raise ValueError(f"nms_sorted: boxes on {sboxes.device}, valid on "
                         f"{svalid.device}; both must be on one CUDA device")
    if sboxes.dtype != torch.float32 or svalid.dtype != torch.bool:
        raise TypeError(f"nms_sorted: needs float32 boxes and bool valid, "
                        f"got {sboxes.dtype} and {svalid.dtype}")
    b, n = svalid.shape
    if sboxes.shape != (b, n, 4):
        raise ValueError(f"nms_sorted: boxes {tuple(sboxes.shape)} do not "
                         f"match valid {tuple(svalid.shape)}")
    if not (sboxes.is_contiguous() and svalid.is_contiguous()):
        raise ValueError("nms_sorted: inputs must be contiguous")
    if n > _MAX_BOXES:
        raise ValueError(f"nms_sorted: at most {_MAX_BOXES} boxes a row")
    if sboxes.data_ptr() % 16:
        raise ValueError("nms_sorted: the boxes must start on a 16-byte "
                         "boundary (the kernel loads a box as one float4)")

    words = (n + 63) // 64
    mask = torch.empty((b, n, words), dtype=torch.int64, device=sboxes.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=sboxes.device)
    fn = _build.function("scda_nms_keep", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ])
    with torch.cuda.device(sboxes.device):
        rc = fn(sboxes.data_ptr(), svalid.data_ptr(), mask.data_ptr(),
                keep.data_ptr(), b, n, float(iou_threshold), int(max_output),
                _build.stream_ptr(sboxes.device))
    _build.check(rc, "scda_nms_keep")
    nms_sorted.launches += 1
    return keep[0] if squeeze else keep


nms_sorted.launches = 0

"""NMS of the port against the JAX package, on the CPU: the K1 plain twin
against ``nms_sorted_pallas`` in interpret mode, and the port's
``nms``/``batched_nms`` against the lax versions.  Keep masks, indices
and validity must be exactly equal (same IoU arithmetic, same greedy
order, ties broken toward the lower index)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scda_tpu.ops import nms as jnms
from scda_tpu.ops.pallas.nms_kernel import nms_sorted_pallas
from scda_tpu_torch.ops import nms as tnms
from scda_tpu_torch.ops.kernels import nms_kernel


def _boxes(rng, shape, spread=120.0):
    xy = rng.rand(*shape, 2) * spread
    wh = rng.rand(*shape, 2) * 50 + 4
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _tied_scores(rng, shape, levels=4):
    """Few distinct values: many exact ties, as padded canvas regions give."""
    return (rng.randint(0, levels, shape) / levels).astype(np.float32)


@pytest.mark.parametrize("b,n,thr,max_out,tile", [
    (2, 200, 0.5, 40, 64),
    (3, 96, 0.7, 96, 256),
    (1, 130, 0.3, 10, 64),
])
def test_plain_twin_matches_pallas_kernel(rng, b, n, thr, max_out, tile):
    boxes = _boxes(rng, (b, n))
    valid = rng.rand(b, n) < 0.8
    ref = np.asarray(nms_sorted_pallas(
        jnp.asarray(boxes), jnp.asarray(valid), iou_threshold=thr,
        max_output=max_out, tile_size=tile, interpret=True))
    out = nms_kernel.nms_sorted(torch.from_numpy(boxes),
                                torch.from_numpy(valid), iou_threshold=thr,
                                max_output=max_out)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_plain_twin_unbatched_and_duplicates():
    """(N, 4) input; exact duplicate boxes (IoU 1) and a zero cap."""
    boxes = np.tile(np.array([[0, 0, 9, 9], [40, 40, 60, 50]], np.float32),
                    (20, 1))
    valid = np.ones(40, bool)
    for max_out in (0, 1, 5):
        ref = np.asarray(nms_sorted_pallas(
            jnp.asarray(boxes), jnp.asarray(valid), iou_threshold=0.5,
            max_output=max_out, interpret=True))
        out = nms_kernel.nms_sorted(torch.from_numpy(boxes),
                                    torch.from_numpy(valid),
                                    iou_threshold=0.5, max_output=max_out)
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("pre_sorted", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_nms_matches_lax(rng, pre_sorted, with_valid, tied):
    n = 150
    boxes = _boxes(rng, (n,))
    scores = _tied_scores(rng, (n,)) if tied else rng.rand(n).astype(np.float32)
    valid = (rng.rand(n) < 0.7) if with_valid else None
    if pre_sorted:
        # Descending scores with invalid slots last, as the proposal top-k
        # hands them over.
        key = np.where(valid, scores, -1.0) if with_valid else scores
        order = np.argsort(-key, kind="stable")
        boxes, scores = boxes[order], scores[order]
        valid = valid[order] if with_valid else None
    kw = dict(iou_threshold=0.6, max_output=40, pre_sorted=pre_sorted)
    ref = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores),
                   valid=None if valid is None else jnp.asarray(valid),
                   impl="lax", **kw)
    out = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                   valid=None if valid is None else torch.from_numpy(valid),
                   **kw)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))


@pytest.mark.parametrize("tied", [False, True])
def test_batched_nms_matches_lax(rng, tied):
    """Per-class shape: (B*C, N) rows with a score-threshold valid mask."""
    bc, n = 6, 100
    boxes = _boxes(rng, (bc, n), spread=60.0)
    scores = (_tied_scores(rng, (bc, n)) if tied
              else rng.rand(bc, n).astype(np.float32))
    valid = scores > 0.3
    kw = dict(iou_threshold=0.3, max_output=25)
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           valid=jnp.asarray(valid), impl="lax", **kw)
    out = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           valid=torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))


def test_keep_mask_to_result_matches_jax(rng):
    keep = rng.rand(3, 50) < 0.3
    order = np.stack([rng.permutation(50) for _ in range(3)]).astype(np.int32)
    out = tnms._keep_mask_to_result(torch.from_numpy(keep),
                                    torch.from_numpy(order.astype(np.int64)), 8)
    for i in range(3):
        ref = jnms._keep_mask_to_result(jnp.asarray(keep[i]),
                                        jnp.asarray(order[i]), 8)
        np.testing.assert_array_equal(out.indices[i].numpy(),
                                      np.asarray(ref.indices))
        np.testing.assert_array_equal(out.valid[i].numpy(),
                                      np.asarray(ref.valid))

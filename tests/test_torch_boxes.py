"""scda_tpu_torch.core.boxes against scda_tpu.core.boxes on the same numpy
inputs (f32, CPU).  Anchors are numpy in both and must be equal; decode,
clip and IoU are elementwise f32 math, held at rtol=1e-6 (the exp of the
decode differs by an ulp between XLA's and PyTorch's CPU kernels)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scda_tpu.core import boxes as jb
from scda_tpu_torch.core import boxes as tb


def _boxes(rng, n, spread=300.0):
    xy = rng.rand(n, 2) * spread
    wh = rng.rand(n, 2) * 120 - 10   # some degenerate (negative) sizes
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("base,ratios,scales,hw,stride", [
    (16, (0.5, 1.0, 2.0), (8.0, 16.0, 32.0), (4, 6), 16),
    (16, (0.5, 1.0, 2.0), (2.0, 4.0, 8.0), (8, 12), 16),
    (8, (1.0, 3.0), (1.0, 5.0, 7.0, 9.0), (3, 5), 8),
])
def test_anchors_exact(base, ratios, scales, hw, stride):
    a_j = jb.generate_base_anchors(base, ratios, scales)
    a_t = tb.generate_base_anchors(base, ratios, scales)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(tb.shift_anchors(a_t, *hw, stride),
                                  jb.shift_anchors(a_j, *hw, stride))


def test_decode_matches_jax(rng):
    boxes = _boxes(rng, 500)
    deltas = (rng.randn(500, 4) * 2).astype(np.float32)  # hits clip_exp
    ref = np.asarray(jb.bbox_transform_inv(jnp.asarray(boxes), jnp.asarray(deltas)))
    out = tb.bbox_transform_inv(torch.from_numpy(boxes), torch.from_numpy(deltas))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-4)


def test_decode_broadcast_matches_jax(rng):
    """(N, 1, 4) rois x (N, C, 4) deltas, as the per-class decode uses it."""
    rois = _boxes(rng, 40)[:, None, :]
    deltas = (rng.randn(40, 5, 4) * 0.5).astype(np.float32)
    ref = np.asarray(jb.bbox_transform_inv(jnp.asarray(rois), jnp.asarray(deltas)))
    out = tb.bbox_transform_inv(torch.from_numpy(rois), torch.from_numpy(deltas))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("h,w", [(128.0, 192.0), (500.0, 1000.0)])
def test_clip_exact(rng, h, w):
    boxes = (rng.randn(300, 4) * 400 + 200).astype(np.float32)
    ref = np.asarray(jb.clip_boxes(jnp.asarray(boxes), h, w))
    out = tb.clip_boxes(torch.from_numpy(boxes), h, w)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_clip_per_image_extent(rng):
    boxes = (rng.randn(2, 50, 4) * 300 + 150).astype(np.float32)
    info = np.array([[100.0, 150.0], [300.0, 200.0]], np.float32)
    ref = np.stack([np.asarray(jb.clip_boxes(jnp.asarray(boxes[i]), *info[i]))
                    for i in range(2)])
    out = tb.clip_boxes(torch.from_numpy(boxes),
                        torch.from_numpy(info[:, 0:1]),
                        torch.from_numpy(info[:, 1:2]))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_iou_exact(rng):
    a, b = _boxes(rng, 120), _boxes(rng, 80)
    ref = np.asarray(jb.bbox_overlaps(jnp.asarray(a), jnp.asarray(b)))
    out = tb.bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(out.numpy(), ref)

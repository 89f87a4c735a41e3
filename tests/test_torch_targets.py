"""Training targets of the port against the JAX package, on the CPU:
``_masked_rank``, ``anchor_targets`` and ``proposal_targets`` on the same
numpy inputs, the port handed the uniforms JAX drew (the two random
streams differ), and the training half of ``core/boxes.py``.

Tolerances: labels, sampled rois, weights and masks exactly equal;
regression targets (a log and divisions, whose last ulp differs between
XLA's and PyTorch's kernels) at rtol=1e-6, atol=1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scda_tpu.config import ROITargetConfig, RPNTargetConfig
from scda_tpu.core import boxes as jbox
from scda_tpu.models import targets as jtg
from scda_tpu_torch.core import boxes as tbox
from scda_tpu_torch.models import targets as ttg


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_draws(key, b, n):
    """The uniforms JAX's target functions draw: per image a key split
    in two, (fg, bg) -> (B, 2, n)."""
    out = []
    for k in jax.random.split(key, b):
        kf, kb = jax.random.split(k)
        out.append([np.asarray(jax.random.uniform(kf, (n,))),
                    np.asarray(jax.random.uniform(kb, (n,)))])
    return torch.from_numpy(np.asarray(out, np.float32))


def _gt(rng, b, g, h, w, nums, classes=4):
    gt = np.zeros((b, g, 5), np.float32)
    for i in range(b):
        for j in range(nums[i]):
            x1, y1 = rng.uniform(0, w - 40), rng.uniform(0, h - 40)
            gt[i, j] = [x1, y1, x1 + rng.uniform(16, 80), y1 + rng.uniform(16, 60),
                        rng.randint(1, classes + 1)]
    return gt


def _anchor_inputs(seed, nums=(3, 5), fh=8, fw=12):
    rng = np.random.RandomState(seed)
    base = jbox.generate_base_anchors(16, (0.5, 1, 2), (2, 4, 8))
    anchors = jbox.shift_anchors(base, fh, fw, 16)
    h, w = fh * 16, fw * 16
    gt = _gt(rng, len(nums), 8, h, w, nums)
    info = np.array([[h, w, 1.0], [h - 20, w - 36, 0.8]], np.float32)[:len(nums)]
    return anchors, gt, np.asarray(nums, np.int32), info


@pytest.mark.parametrize("n,p", [(20, 0.3), (257, 0.7), (64, 0.0), (5, 1.0)])
def test_masked_rank_matches_jax(n, p):
    key = jax.random.key(n)
    mask = np.random.RandomState(n).rand(n) < p
    rank_j, order_j = jtg._masked_rank(key, jnp.asarray(mask))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    rank_t, order_t = ttg._masked_rank(u, torch.from_numpy(mask))
    np.testing.assert_array_equal(rank_t.numpy(), np.asarray(rank_j))
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))


_RPN_CFGS = {
    "default": RPNTargetConfig(batch_size=64),
    "clobber": RPNTargetConfig(batch_size=64, clobber_positives=True),
    "positive_weight": RPNTargetConfig(batch_size=48, positive_weight=0.3),
    "small_quota": RPNTargetConfig(batch_size=8, fg_fraction=0.25),
}


@pytest.mark.parametrize("name", list(_RPN_CFGS))
def test_anchor_targets_match_jax(name):
    cfg = _RPN_CFGS[name]
    anchors, gt, num, info = _anchor_inputs(1)
    key = jax.random.key(7)
    ref = jtg.anchor_targets(jnp.asarray(anchors), jnp.asarray(gt),
                             jnp.asarray(num), jnp.asarray(info), cfg, key)
    out = ttg.anchor_targets(_t(anchors), _t(gt), _t(num), _t(info), cfg,
                             torch.Generator(),
                             draws=jax_draws(key, 2, anchors.shape[0]))
    labels = out.labels.numpy()
    np.testing.assert_array_equal(labels, np.asarray(ref.labels))
    assert (labels == 1).sum() > 0 and (labels == 0).sum() > 0
    np.testing.assert_array_equal(out.bbox_inside_w.numpy(),
                                  np.asarray(ref.bbox_inside_w))
    np.testing.assert_array_equal(out.bbox_outside_w.numpy(),
                                  np.asarray(ref.bbox_outside_w))
    np.testing.assert_allclose(out.bbox_targets.numpy(),
                               np.asarray(ref.bbox_targets),
                               rtol=1e-6, atol=1e-6)


def test_anchor_targets_draw_from_the_generator():
    """Without ``draws`` the uniforms come from the generator: the same
    seed gives the same labels, and the draw is (B, 2, K)."""
    anchors, gt, num, info = map(_t, _anchor_inputs(2))
    cfg = _RPN_CFGS["small_quota"]
    a, b = (ttg.anchor_targets(anchors, gt, num, info, cfg,
                               torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a.labels, b.labels)
    u = torch.rand((2, 2, anchors.shape[0]),
                   generator=torch.Generator().manual_seed(5))
    c = ttg.anchor_targets(anchors, gt, num, info, cfg, torch.Generator(),
                           draws=u)
    assert torch.equal(a.labels, c.labels)


def _proposal_inputs(seed, nums, n=48, h=128, w=192, valid_p=0.8):
    rng = np.random.RandomState(seed)
    gt = _gt(rng, len(nums), 8, h, w, nums)
    props = np.zeros((len(nums), n, 4), np.float32)
    for i in range(len(nums)):
        for j in range(n):
            if nums[i] and j % 3 == 0:      # near a gt box: foregrounds
                g = gt[i, j % nums[i], :4]
                props[i, j] = g + rng.uniform(-6, 6, 4)
            else:
                x1, y1 = rng.uniform(0, w - 30), rng.uniform(0, h - 30)
                props[i, j] = [x1, y1, x1 + rng.uniform(8, 90),
                               y1 + rng.uniform(8, 70)]
    valid = rng.rand(len(nums), n) < valid_p
    return props, valid, gt, np.asarray(nums, np.int32)


_ROI_CASES = {
    "fg_and_bg": ((3, 5), ROITargetConfig(batch_size=32)),
    "fg_only": ((4, 2), ROITargetConfig(batch_size=32, bg_thresh_lo=0.45)),
    "one_image_empty": ((3, 0), ROITargetConfig(batch_size=16)),
    "class_quota": ((2, 6), ROITargetConfig(batch_size=64, fg_fraction=0.5)),
}


@pytest.mark.parametrize("name", list(_ROI_CASES))
def test_proposal_targets_match_jax(name):
    nums, cfg = _ROI_CASES[name]
    props, valid, gt, num = _proposal_inputs(3, nums)
    if name == "one_image_empty":
        valid[1] = False           # no gt and no proposal: dead slots
    key = jax.random.key(11)
    ref = jtg.proposal_targets(jnp.asarray(props), jnp.asarray(valid),
                               jnp.asarray(gt), jnp.asarray(num), cfg, key)
    out = ttg.proposal_targets(_t(props), _t(valid), _t(gt), _t(num), cfg,
                               torch.Generator(),
                               draws=jax_draws(key, len(nums),
                                               props.shape[1] + gt.shape[1]))
    np.testing.assert_array_equal(out.rois.numpy(), np.asarray(ref.rois))
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(out.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(out.bbox_inside_w.numpy(),
                                  np.asarray(ref.bbox_inside_w))
    np.testing.assert_allclose(out.bbox_targets.numpy(),
                               np.asarray(ref.bbox_targets),
                               rtol=1e-6, atol=1e-6)
    assert out.fg_mask.any()      # not vacuous: foregrounds were drawn


def test_bbox_transform_and_overlaps_batch_match_jax(rng):
    a = rng.rand(2, 30, 4).astype(np.float32) * 100
    a[..., 2:] += a[..., :2]
    b = rng.rand(2, 7, 4).astype(np.float32) * 100
    b[..., 2:] += b[..., :2] * 0.5
    np.testing.assert_allclose(
        tbox.bbox_transform(_t(a[:, :7]), _t(b)).numpy(),
        np.asarray(jbox.bbox_transform(jnp.asarray(a[:, :7]), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tbox.bbox_overlaps_batch(_t(a), _t(b)).numpy(),
        np.asarray(jbox.bbox_overlaps_batch(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_smooth_l1_loss_and_grad_match_jax(rng, sigma):
    pred, target = (rng.randn(3, 20, 4).astype(np.float32) * 0.5
                    for _ in range(2))
    inside = (rng.rand(3, 20, 4) < 0.6).astype(np.float32)
    outside = rng.rand(3, 20, 4).astype(np.float32)
    ref, ref_g = jax.value_and_grad(
        lambda p: jbox.smooth_l1_loss(p, target, inside, outside, sigma))(
            jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    out = tbox.smooth_l1_loss(p, _t(target), _t(inside), _t(outside), sigma)
    out.backward()
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g),
                               rtol=1e-6, atol=1e-7)

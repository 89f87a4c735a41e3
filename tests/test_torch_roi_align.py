"""RoI-Align of the port against the JAX package, on the CPU (f32): the
axis-weight functions, the K2 plain twin against ``roi_align_contract``
in interpret mode, and the grouped ops in the ``align``, adaptive
(``sampling_ratio=0``) and ``align_legacy`` modes.

Tolerances: the weights are elementwise f32 math, held at rtol=atol=1e-6;
contractions sum in another order than XLA's, held at rtol=atol=1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scda_tpu.ops import roi_ops as jro
from scda_tpu.ops.pallas.roi_align_kernel import roi_align_contract
from scda_tpu_torch.ops import roi_ops as tro
from scda_tpu_torch.ops.kernels import roi_align_kernel

H, W = 6, 10     # feature map (stride 16 -> a 96 x 160 canvas)


def _rois(rng, b, r):
    """Interior, border-crossing, tiny and out-of-map boxes."""
    xy = rng.rand(b, r, 2) * np.array([W * 16, H * 16]) - 20
    wh = rng.rand(b, r, 2) * 120 + 1
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [0.0, 0.0, W * 16 - 1, H * 16 - 1]    # whole canvas
    rois[:, 1] = [200.0, 120.0, 260.0, 150.0]           # off the map
    return rois


_MODES = [
    dict(sampling_ratio=2, aligned=False),
    dict(sampling_ratio=0, aligned=False),
    dict(sampling_ratio=1, aligned=True),
]


@pytest.mark.parametrize("kw", _MODES)
def test_axis_weights_match_jax(rng, kw):
    rois = _rois(rng, 2, 12)
    wy_j, wx_j = jro.roi_align_axis_weights(jnp.asarray(rois), H, W,
                                            output_size=7, **kw)
    wy_t, wx_t = tro.roi_align_axis_weights(torch.from_numpy(rois), H, W,
                                            output_size=7, **kw)
    np.testing.assert_allclose(wy_t.numpy(), np.asarray(wy_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(wx_t.numpy(), np.asarray(wx_j), rtol=1e-6, atol=1e-6)


def test_legacy_axis_weights_match_jax(rng):
    rois = _rois(rng, 2, 12)
    ys_j, xs_j = jro._legacy_sample_coords(jnp.asarray(rois), 1 / 16, 7)
    ys_t, xs_t = tro._legacy_sample_coords(torch.from_numpy(rois), 1 / 16, 7)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-6, atol=1e-6)
    for coords, size in ((ys_j, H), (xs_j, W)):
        ref = np.asarray(jro._legacy_axis_weights(coords, size))
        out = tro._legacy_axis_weights(torch.from_numpy(np.array(coords)), size)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dense", [False, True])
def test_contract_twin_matches_pallas_kernel(rng, dense):
    b, r, p, c = 2, 9, 7, 16
    if dense:
        wy = rng.rand(b, r, p, H).astype(np.float32)
        wx = rng.rand(b, r, p, W).astype(np.float32)
    else:
        wy_j, wx_j = jro.roi_align_axis_weights(
            jnp.asarray(_rois(rng, b, r)), H, W, output_size=p)
        wy, wx = np.array(wy_j), np.array(wx_j)
    feat = rng.randn(b, H, W, c).astype(np.float32)
    ref = np.asarray(roi_align_contract(jnp.asarray(wy), jnp.asarray(wx),
                                        jnp.asarray(feat), interpret=True))
    out = roi_align_kernel.roi_align_contract(
        torch.from_numpy(wy), torch.from_numpy(wx), torch.from_numpy(feat))
    assert out.dtype == torch.float32 and out.shape == (b, r, p, p, c)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", _MODES)
def test_roi_align_grouped_matches_jax(rng, kw):
    feat = rng.randn(2, H, W, 8).astype(np.float32)
    rois = _rois(rng, 2, 10)
    ref = np.asarray(jro.roi_align_grouped(jnp.asarray(feat), jnp.asarray(rois),
                                           output_size=7, **kw))
    out = tro.roi_align_grouped(torch.from_numpy(feat), torch.from_numpy(rois),
                                output_size=7, **kw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_roi_align_legacy_grouped_matches_jax(rng):
    feat = rng.randn(2, H, W, 8).astype(np.float32)
    rois = _rois(rng, 2, 10)
    ref = np.asarray(jro.roi_align_legacy_grouped(
        jnp.asarray(feat), jnp.asarray(rois), output_size=7))
    out = tro.roi_align_legacy_grouped(torch.from_numpy(feat),
                                       torch.from_numpy(rois), output_size=7)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_grouped_matches_gather_form(rng):
    """Cross-check against the JAX gather form (``roi_align``), which the
    JAX tests pin to a per-element numpy oracle."""
    feat = rng.randn(1, H, W, 4).astype(np.float32)
    rois = _rois(rng, 1, 8)
    ref = np.asarray(jro.roi_align(jnp.asarray(feat), jnp.asarray(rois[0]),
                                   output_size=7, sampling_ratio=2))
    out = tro.roi_align_grouped(torch.from_numpy(feat), torch.from_numpy(rois),
                                output_size=7, sampling_ratio=2)[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

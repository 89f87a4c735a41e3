"""RoI-Align of the port against the JAX package, on the CPU (f32): the
axis-weight functions, the K2 plain twin against ``roi_align_contract``
in interpret mode, and the grouped ops in the ``align``, adaptive
(``sampling_ratio=0``) and ``align_legacy`` modes; the backward: its twin
``roi_align_contract_bwd_plain`` against ``jax.vjp``, the autograd.Function
on the CPU, and the gradients of the grouped and multiscale ops.

Tolerances: the weights are elementwise f32 math, held at rtol=atol=1e-6;
contractions sum in another order than XLA's, held at rtol=atol=1e-5."""

import numpy as np
import jax
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


# ---- the backward ------------------------------------------------------

def _mode_weights(rng, mode, b, r, p):
    """Axis weights of one mode for random rois: ``align``
    (sampling_ratio=2), ``adaptive`` (sampling_ratio=0, rows can be dense)
    and ``legacy`` (the reference lineage's resize grid)."""
    rois = jnp.asarray(_rois(rng, b, r))
    if mode == "legacy":
        ys, xs = jro._legacy_sample_coords(rois, 1 / 16, p)
        wy, wx = jro._legacy_axis_weights(ys, H), jro._legacy_axis_weights(xs, W)
    else:
        wy, wx = jro.roi_align_axis_weights(
            rois, H, W, output_size=p,
            sampling_ratio={"align": 2, "adaptive": 0}[mode])
    return np.array(wy), np.array(wx)


@pytest.mark.parametrize("mode", ["align", "adaptive", "legacy"])
def test_contract_bwd_twin_matches_jax_vjp(rng, mode):
    """``roi_align_contract_bwd_plain`` against ``jax.vjp`` of the Pallas
    kernel (interpret mode; its custom vjp is ``_contract_bwd``) and of
    the einsum path, f32 at rtol=atol=1e-5; the port's autograd.Function
    gives the twin's value exactly on the CPU."""
    b, r, p, c = 2, 9, 7, 16
    wy, wx = _mode_weights(rng, mode, b, r, p)
    feat = rng.randn(b, H, W, c).astype(np.float32)
    g = rng.randn(b, r, p, p, c).astype(np.float32)
    jwy, jwx, jg = map(jnp.asarray, (wy, wx, g))
    refs = []
    for fn in (lambda f: roi_align_contract(jwy, jwx, f, interpret=True),
               lambda f: jro._contract_axis_weights(jwy, jwx, f)):
        _, vjp = jax.vjp(fn, jnp.asarray(feat))
        refs.append(np.asarray(vjp(jg)[0]))

    twy, twx, tg = map(torch.from_numpy, (wy, wx, g))
    out = roi_align_kernel.roi_align_contract_bwd_plain(twy, twx, tg)
    assert out.dtype == torch.float32 and out.shape == feat.shape
    for ref in refs:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

    f = torch.from_numpy(feat).requires_grad_()
    roi_align_kernel.roi_align_contract(twy, twx, f).backward(tg)
    assert torch.equal(f.grad, out)


def test_contract_bwd_bf16_features(rng):
    """bf16 features: dfeat is summed in f32 and cast once, as
    ``_contract_bwd`` casts it: within one bf16 ulp of JAX's."""
    wy, wx = _mode_weights(rng, "align", 1, 6, 7)
    feat = rng.randn(1, H, W, 16).astype(np.float32)
    g = rng.randn(1, 6, 7, 7, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda f: roi_align_contract(
        jnp.asarray(wy), jnp.asarray(wx), f, interpret=True),
        jnp.asarray(feat, jnp.bfloat16))
    ref = np.asarray(vjp(jnp.asarray(g))[0], np.float32)
    f = torch.from_numpy(feat).to(torch.bfloat16).requires_grad_()
    roi_align_kernel.roi_align_contract(
        torch.from_numpy(wy), torch.from_numpy(wx), f).backward(
            torch.from_numpy(g))
    assert f.grad.dtype == torch.bfloat16
    _, e = np.frexp(np.maximum(np.abs(ref), 2.0 ** -10))
    assert np.all(np.abs(f.grad.float().numpy() - ref) <= np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("kw", _MODES + [None])
def test_grouped_ops_differentiate_as_jax(rng, kw):
    """The grouped ops reach the backward through ``roi_align_contract``
    with no change of their own: their feature gradients equal
    ``jax.vjp`` of the JAX ops (``None``: ``align_legacy``), f32 at
    rtol=atol=1e-5."""
    feat = rng.randn(2, H, W, 8).astype(np.float32)
    rois = _rois(rng, 2, 10)
    if kw is None:
        jfn = lambda f: jro.roi_align_legacy_grouped(f, jnp.asarray(rois))
        tfn = lambda f: tro.roi_align_legacy_grouped(f, torch.from_numpy(rois))
    else:
        jfn = lambda f: jro.roi_align_grouped(f, jnp.asarray(rois), **kw)
        tfn = lambda f: tro.roi_align_grouped(f, torch.from_numpy(rois), **kw)
    out, vjp = jax.vjp(jfn, jnp.asarray(feat))
    g = rng.randn(*out.shape).astype(np.float32)
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    f = torch.from_numpy(feat).requires_grad_()
    tfn(f).backward(torch.from_numpy(g))
    np.testing.assert_allclose(f.grad.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_multiscale_pool_differentiates_as_jax(rng):
    """``pool_rois_multiscale``: both pyramid levels get JAX's gradient
    (small rois pool from stride 8, the others from stride 16)."""
    from scda_tpu.config import ModelConfig
    from scda_tpu.models.faster_rcnn import pool_rois_multiscale as jpool
    from scda_tpu_torch.models.faster_rcnn import pool_rois_multiscale as tpool

    cfg = ModelConfig(multiscale_roi=True, ms_fine_threshold=48.0)
    f8 = rng.randn(2, 2 * H, 2 * W, 8).astype(np.float32)
    f16 = rng.randn(2, H, W, 8).astype(np.float32)
    rois = _rois(rng, 2, 12)
    rois[:, 2:6, 2:] = rois[:, 2:6, :2] + 20.0      # small: the fine level
    out, vjp = jax.vjp(lambda a, b: jpool(a, b, jnp.asarray(rois), cfg),
                       jnp.asarray(f8), jnp.asarray(f16))
    g = rng.randn(*out.shape).astype(np.float32)
    ref8, ref16 = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    t8, t16 = (torch.from_numpy(x).requires_grad_() for x in (f8, f16))
    tpool(t8, t16, torch.from_numpy(rois), cfg).backward(torch.from_numpy(g))
    assert np.abs(ref8).max() > 0 and np.abs(ref16).max() > 0
    np.testing.assert_allclose(t8.grad.numpy(), ref8, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t16.grad.numpy(), ref16, rtol=1e-5, atol=1e-5)


# ---- a model of the CUDA kernel's tap compaction (csrc/roi_align.cu) ----
#
# The kernel runs only on a card.  Its algorithm is modelled here in
# numpy and held to the plain twins: per roi, the nonzero taps of the 2*P
# weight rows are compacted once, in index order; a roi whose longest row
# has at most _TAPS taps takes loops of fixed length _TAPS guarded by the
# counts, any other roi the general loops over the same lists.  The
# backward lists, per roi, the bins that reach each map row and column
# and the rectangle the roi touches; then every dfeat pixel is summed by
# one thread over the rois whose rectangle meets its tile, r, p, q in
# index order, and stored once.

_TAPS = 4     # kTaps in csrc/roi_align.cu


def _compact(rows):
    """Per row: (indices, values) of the nonzero entries, in order."""
    return [(np.flatnonzero(r), r[np.flatnonzero(r)]) for r in rows]


def _contract_model(wy, wx, feat):
    b, r, p, _ = wy.shape
    out = np.zeros((b, r, p, p, feat.shape[-1]), np.float32)
    unrolled = 0
    for bi in range(b):
        for ri in range(r):
            hs, ws = _compact(wy[bi, ri]), _compact(wx[bi, ri])
            sparse = max(len(i) for i, _ in hs + ws) <= _TAPS
            unrolled += sparse
            for pi, (hi, hv) in enumerate(hs):
                for qi, (wi, wv) in enumerate(ws):
                    acc = np.zeros(feat.shape[-1], np.float32)
                    w_taps = range(_TAPS) if sparse else range(len(wi))
                    h_taps = range(_TAPS) if sparse else range(len(hi))
                    for k in w_taps:
                        if k >= len(wi):
                            continue
                        s = np.zeros_like(acc)
                        for m in h_taps:
                            if m < len(hi):
                                s += hv[m] * feat[bi, hi[m], wi[k]]
                        acc += wv[k] * s
                    out[bi, ri, pi, qi] = acc
    return out, unrolled


_TILE = (2, 8)   # kTileH, kTileW in csrc/roi_align.cu


def _entry_lists(weights):
    """``list_entries`` of the kernel: for every column i of a (P, len)
    weight matrix, the rows p with a nonzero, in order, as (p, weight),
    and the first and last column with an entry (len, -1 if none)."""
    lists = [[(p, weights[p, i]) for p in range(weights.shape[0])
              if weights[p, i] != 0] for i in range(weights.shape[1])]
    touched = [i for i, e in enumerate(lists) if e]
    span = (touched[0], touched[-1]) if touched else (weights.shape[1], -1)
    return lists, span


def _contract_bwd_model(wy, wx, g, h, w):
    """The backward kernel's gather: per tile of _TILE pixels, the rois
    whose rectangle meets it, in r order; per pixel, over those rois,
    sum_{p at h} wy[p, h] * sum_{q at w} wx[q, w] * g[p, q]; every pixel
    stored once.  Returns dfeat and the stores made."""
    b, r = wy.shape[:2]
    dfeat = np.full((b, h, w, g.shape[-1]), np.nan, np.float32)
    stores = 0
    for bi in range(b):
        rows = [_entry_lists(wy[bi, ri]) for ri in range(r)]
        cols = [_entry_lists(wx[bi, ri]) for ri in range(r)]
        for h0 in range(0, h, _TILE[0]):
            for w0 in range(0, w, _TILE[1]):
                h1, w1 = min(h0 + _TILE[0], h) - 1, min(w0 + _TILE[1], w) - 1
                cand = [ri for ri in range(r)
                        if rows[ri][1][0] <= h1 and rows[ri][1][1] >= h0
                        and cols[ri][1][0] <= w1 and cols[ri][1][1] >= w0]
                for hi in range(h0, h1 + 1):
                    for wi in range(w0, w1 + 1):
                        acc = np.zeros(g.shape[-1], np.float32)
                        for ri in cand:
                            for p, a in rows[ri][0][hi]:
                                t = np.zeros_like(acc)
                                for q, bq in cols[ri][0][wi]:
                                    t += bq * g[bi, ri, p, q]
                                acc += a * t
                        dfeat[bi, hi, wi] = acc
                        stores += 1
    return dfeat, stores


@pytest.mark.parametrize("case", ["sparse", "long_row", "dense",
                                  "zero_row", "adaptive"])
def test_tap_compaction_model_matches_plain_twins(rng, case):
    """``sparse``: every row within the capacity (all rois unrolled);
    ``long_row``: one row of 6 taps sends its roi, and only it, to the
    general loops; ``dense``: every row overflows; ``zero_row``: rows with
    no tap at all (a roi off the map) give zeros; ``adaptive``: the
    sampling mode whose rows can be dense.  f32 at rtol=atol=1e-5."""
    b, r, p, c = 2, 5, 7, 6
    if case == "dense":
        wy = rng.rand(b, r, p, H).astype(np.float32)
        wx = rng.rand(b, r, p, W).astype(np.float32)
    else:
        wy, wx = _mode_weights(rng, "adaptive" if case == "adaptive"
                               else "align", b, r, p)
    if case == "long_row":
        wx[1, 2, 3, 2:8] = 0.25
    if case == "zero_row":
        wy[0, 3] = 0.0
        wx[1, 4, 2] = 0.0
    feat = rng.randn(b, H, W, c).astype(np.float32)
    g = rng.randn(b, r, p, p, c).astype(np.float32)
    twy, twx = torch.from_numpy(wy), torch.from_numpy(wx)

    out, unrolled = _contract_model(wy, wx, feat)
    ref = roi_align_kernel.roi_align_contract_plain(
        twy, twx, torch.from_numpy(feat)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert unrolled == {"sparse": b * r, "zero_row": b * r,
                        "long_row": b * r - 1, "dense": 0}.get(case, unrolled)
    if case == "zero_row":
        assert not out[0, 3].any() and not out[1, 4, :, 2].any()

    back, stores = _contract_bwd_model(wy, wx, g, H, W)
    ref = roi_align_kernel.roi_align_contract_bwd_plain(
        twy, twx, torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(back, ref, rtol=1e-5, atol=1e-5)
    # One store per pixel of the map, touched or not: no memset, no adds.
    assert stores == b * H * W
    if case == "zero_row":   # roi (0, 3) reaches no row: it adds nothing
        keep = np.ones(r, bool)
        keep[3] = False
        part, _ = _contract_bwd_model(wy[:1, keep], wx[:1, keep],
                                      g[:1, keep], H, W)
        np.testing.assert_array_equal(part, back[:1])

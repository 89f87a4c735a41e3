"""CUDA kernels of scda_tpu_torch against their plain PyTorch twins, on
the card, at small and ragged shapes (chip_smoke.py covers the main
path's shapes).  Marked ``gpu``; each test skips without a CUDA device.
This file imports no JAX, so on a machine with a GPU and no JAX run it
without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from scda_tpu_torch.ops.kernels import (
    bottleneck_kernel, nms_kernel, roi_align_kernel, stem_kernel,
)
from scda_tpu_torch.utils.numerics import set_card_numerics

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_card_numerics()
    return torch.device("cuda", 0)


def _boxes(rng, b, n, spread=200.0):
    xy = rng.rand(b, n, 2) * spread
    wh = rng.rand(b, n, 2) * 60 + 4
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("b,n,thr,max_out", [
    (1, 1, 0.5, 4), (2, 63, 0.5, 10), (3, 64, 0.3, 64), (2, 65, 0.7, 7),
    (1, 1000, 0.7, 300), (4, 300, 0.3, 0),
])
def test_nms_kernel_matches_twin(cuda, b, n, thr, max_out):
    rng = np.random.RandomState(n)
    boxes = torch.from_numpy(_boxes(rng, b, n, spread=100.0)).to(cuda)
    valid = torch.from_numpy(rng.rand(b, n) < 0.8).to(cuda)
    keep = nms_kernel.nms_sorted(boxes, valid, iou_threshold=thr,
                                 max_output=max_out)
    plain = nms_kernel.nms_sorted_plain(boxes, valid, iou_threshold=thr,
                                        max_output=max_out)
    assert torch.equal(keep, plain)


def test_nms_kernel_identical_boxes(cuda):
    """Exact duplicates (IoU 1) and tied scores: keep the first of each."""
    base = torch.tensor([[0., 0., 10., 10.], [50., 50., 70., 60.]])
    boxes = base.repeat(100, 1)[None].contiguous().to(cuda)
    valid = torch.ones(1, 200, dtype=torch.bool, device=cuda)
    keep = nms_kernel.nms_sorted(boxes, valid, iou_threshold=0.5,
                                 max_output=50)
    assert keep[0, :2].all() and int(keep.sum()) == 2


@pytest.mark.parametrize("b,n,max_out,clustered", [
    (1, 1, 1, False), (8, 63, 5, True), (1, 64, 64, False), (8, 65, 2, True),
    (1, 6000, 300, False), (1, 6000, 300, True), (8, 6000, 6000, True),
    (1, 12000, 2000, False), (8, 12000, 2000, True), (1, 12000, 3, False),
    (2, 16000, 16000, True),    # more columns than a lane's registers hold
])
def test_nms_kernel_ragged_rows_and_caps(cuda, b, n, max_out, clustered):
    """The word-at-a-time scan at ragged sizes (N below, at and past a
    64-box word; the serving and training sizes) with ``max_output``
    reached inside the first word, deep in the row, and never; spread
    boxes (many keeps a word) and clustered ones (most boxes suppressed,
    so every word is walked); B of 1 and 8; the last row of a batch with
    no valid box at all."""
    from scda_tpu_torch.utils.kernel_probe import proposal_boxes

    g = torch.Generator().manual_seed(n + b)
    boxes = proposal_boxes(g, b, n, clustered).to(cuda)
    valid = (torch.rand((b, n), generator=g) < 0.9).to(cuda)
    if b > 1:
        valid[-1] = False
    kw = dict(iou_threshold=0.7, max_output=max_out)
    keep = nms_kernel.nms_sorted(boxes, valid, **kw)
    assert torch.equal(keep, nms_kernel.nms_sorted_plain(boxes, valid, **kw))
    assert int(keep.sum(1).max()) <= max_out and not keep[~valid].any()


def test_nms_kernel_threshold_ties(cuda):
    """Pairs whose IoU lies within a few ulps of the threshold, on both
    sides: the division-free screen must hand them to the exact test.
    Boxes [0, 0, 9, h] and [0, 0, 9, 9] overlap by (h + 1) / 10; the
    threshold is set to those very quotients."""
    hs = torch.arange(0.0, 9.0, 0.25)
    boxes = torch.zeros(1, 2 * len(hs), 4)
    boxes[0, 0::2, 2:] = 9.0
    boxes[0, 1::2, 2] = 9.0
    boxes[0, 1::2, 3] = hs
    boxes[0, :, 0::2] += 40.0 * torch.arange(len(hs)).repeat_interleave(2)[:, None]
    boxes = boxes.to(cuda)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=cuda)
    for h in hs.tolist():
        thr = float(torch.tensor((h + 1.0) * 10.0) / torch.tensor(100.0))
        for t in (thr, float(torch.nextafter(torch.tensor(thr), torch.tensor(0.0))),
                  float(torch.nextafter(torch.tensor(thr), torch.tensor(1.0)))):
            kw = dict(iou_threshold=t, max_output=1000)
            assert torch.equal(nms_kernel.nms_sorted(boxes, valid, **kw),
                               nms_kernel.nms_sorted_plain(boxes, valid, **kw))


@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 96, 100, 512, 1024])
@pytest.mark.parametrize("kind", ["sparse", "long_row", "dense"])
def test_roi_align_kernels_channel_widths_and_tap_capacity(cuda, feat_dtype,
                                                            c, kind):
    """One roi (R=1) and seven, forward and backward, at channel counts
    that are and are not multiples of the 16-byte vector (100 is none for
    bf16), with rows of at most 4 taps (the unrolled path), one row of 9
    taps among sparse ones, and dense weights (the general loops).  f32
    features: rtol=atol=1e-5; bf16: rtol=1e-2, atol=1e-3; the backward
    f32 at atol 1e-5 of the largest |dfeat|, bf16 within 2 ulps."""
    from scda_tpu_torch.ops import roi_ops
    from scda_tpu_torch.utils.kernel_probe import proposal_boxes

    h, w = 32, 64
    g = torch.Generator().manual_seed(c)
    for r in (1, 7):
        if kind == "dense":
            wy, wx = (torch.rand((2, r, 7, n), generator=g).to(cuda)
                      for n in (h, w))
        else:
            wy, wx = roi_ops.roi_align_axis_weights(
                proposal_boxes(g, 2, r, False).to(cuda), h, w)
            if kind == "long_row":
                wx[1, r - 1, 3, 5:14] = 0.125
        feat = torch.randn((2, h, w, c), generator=g).to(cuda, feat_dtype)
        out = roi_align_kernel.roi_align_contract(wy, wx, feat)
        ref = roi_align_kernel.roi_align_contract_plain(wy, wx, feat)
        tol = (1e-5, 1e-5) if feat_dtype == torch.float32 else (1e-2, 1e-3)
        torch.testing.assert_close(out, ref, rtol=tol[0], atol=tol[1])
        cot = torch.randn((2, r, 7, 7, c), generator=g).to(cuda)
        back = roi_align_kernel.roi_align_contract_bwd(wy, wx, cot, h, w,
                                                       feat_dtype)
        ref = roi_align_kernel.roi_align_contract_bwd_plain(wy, wx, cot,
                                                            feat_dtype)
        if feat_dtype == torch.float32:
            torch.testing.assert_close(back, ref, rtol=1e-5,
                                       atol=1e-5 * ref.abs().max().item())
        else:
            ref = ref.float()
            assert bool(((back.float() - ref).abs() <= 2 * _bf16_ulp(ref)).all())


@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,r,p,h,w,c", [
    (1, 3, 7, 5, 9, 33), (2, 17, 5, 32, 64, 512), (1, 4, 7, 64, 160, 130),
])
def test_roi_align_kernel_matches_twin(cuda, feat_dtype, b, r, p, h, w, c):
    g = torch.Generator(device=cuda).manual_seed(0)
    wy = torch.rand((b, r, p, h), generator=g, device=cuda)
    wx = torch.rand((b, r, p, w), generator=g, device=cuda)
    wy = wy * (wy > 0.7)            # sparse rows, some all zero
    wx = wx * (wx > 0.7)
    feat = torch.rand((b, h, w, c), generator=g, device=cuda).to(feat_dtype)
    out = roi_align_kernel.roi_align_contract(wy, wx, feat)
    ref = roi_align_kernel.roi_align_contract_plain(wy, wx, feat)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 18, 10), (1, 34, 50),
                                   (1, 64, 128)])
def test_stem_kernel_matches_twin_f32(cuda, shape):
    b, h, w = shape
    rng = np.random.RandomState(h * w)
    x = torch.from_numpy(rng.randn(b, h, w, 3).astype(np.float32)).to(cuda)
    k1 = torch.from_numpy(rng.randn(3, 3, 3, 64).astype(np.float32) * 0.1).to(cuda)
    b1 = torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1).to(cuda)
    k2 = torch.from_numpy(rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05).to(cuda)
    b2 = torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1).to(cuda)
    out = stem_kernel.vgg_stem_fused(x, k1, b1, k2, b2, dtype=torch.float32)
    ref = stem_kernel.vgg_stem_plain(x, k1, b1, k2, b2, dtype=torch.float32)
    assert out.shape == (b, h // 2, w // 2, 64)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_stem_kernel_bf16_y1_exact(cuda):
    """bf16: y1 matches the twin bit for bit, so the pooled outputs differ
    only by conv1_2's f32 summation order: at most one bf16 ulp."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 40, 24, 3).astype(np.float32)).to(cuda)
    k1 = torch.from_numpy(rng.randn(3, 3, 3, 64).astype(np.float32) * 0.3).to(cuda)
    b1 = torch.zeros(64, device=cuda)
    k2 = torch.from_numpy(rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05).to(cuda)
    b2 = torch.zeros(64, device=cuda)
    out = stem_kernel.vgg_stem_fused(x, k1, b1, k2, b2).float()
    ref = stem_kernel.vgg_stem_plain(x, k1, b1, k2, b2).float()
    _, e = torch.frexp(torch.clamp(ref.abs(), min=2.0 ** -10))
    ulp = torch.ldexp(torch.ones_like(ref), e - 8)
    assert bool(((out - ref).abs() <= ulp).all())


@pytest.mark.parametrize("shape", [
    (1, 2, 2), (2, 18, 10), (1, 34, 50), (3, 22, 70), (1, 64, 128),
    (8, 40, 56), (8, 512, 1024), (16, 512, 1024),
])
def test_stem_kernel_matches_twin_bf16(cuda, shape):
    """bf16, where conv1_2 runs on the tensor cores: ragged even sizes
    (tiles cut at the right and bottom edges), a batch of 8, and the
    training path's shapes at bs 8 and 16 (``bench_torch.py`` train_bs16).  conv1_2's f32 sums are taken in another order
    than the twin's, so a rounding may flip: within 2 bf16 ulps."""
    b, h, w = shape
    rng = np.random.RandomState(h * w + b)
    x = torch.from_numpy(rng.randn(b, h, w, 3).astype(np.float32) * 50).to(cuda)
    k1 = torch.from_numpy(rng.randn(3, 3, 3, 64).astype(np.float32)
                          * (2 / 27) ** 0.5 / 64).to(cuda)
    b1 = torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1).to(cuda)
    k2 = torch.from_numpy(rng.randn(3, 3, 64, 64).astype(np.float32)
                          * (2 / 576) ** 0.5).to(cuda)
    b2 = torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1).to(cuda)
    before = stem_kernel.vgg_stem_fused.launches
    out = stem_kernel.vgg_stem_fused(x, k1, b1, k2, b2)
    assert stem_kernel.vgg_stem_fused.launches == before + 1
    assert out.shape == (b, h // 2, w // 2, 64) and out.dtype == torch.bfloat16
    ref = stem_kernel.vgg_stem_plain(x, k1, b1, k2, b2).float()
    assert ref.abs().max() > 1
    assert bool(((out.float() - ref).abs() <= 2 * _bf16_ulp(ref)).all())


def _chain_weights(g, n, c, f, device, damp=1.0):
    """Folded-weight stacks at He scale; ``damp`` scales the expand."""
    def r(*shape, std):
        return (torch.randn(shape, generator=g) * std).to(device)
    return (r(n, c, f, std=(2.0 / c) ** 0.5), r(n, 1, f, std=0.05),
            r(n, 9, f, f, std=(2.0 / (9 * f)) ** 0.5), r(n, 1, f, std=0.05),
            r(n, f, c, std=damp * (2.0 / f) ** 0.5), r(n, 1, c, std=0.05))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,f,n", [
    (2, 7, 9, 64, 3), (2, 5, 11, 128, 1), (1, 9, 5, 256, 1),
    (2, 3, 3, 64, 1), (1, 33, 17, 128, 3), (2, 1, 1, 64, 1),
])
def test_bottleneck_chain_kernel_matches_twin(cuda, dtype, b, h, w, f, n):
    """Ragged maps (M not a multiple of the 64-row tile, borders on every
    side).  f32: rtol=atol=1e-4.  bf16: both round after each stage from
    f32 sums taken in different orders, so a rounding may flip by one
    ulp and propagate: max error <= 2^-6 * max|twin| (about 2 bf16 ulps
    at the largest outputs)."""
    c = 4 * f
    g = torch.Generator().manual_seed(h * w + f + n)
    x = torch.relu(torch.randn((b, h, w, c), generator=g)).to(cuda)
    ws = _chain_weights(g, n, c, f, cuda)
    out = bottleneck_kernel.bottleneck_chain(x, *ws, dtype=dtype)
    ref = bottleneck_kernel.bottleneck_chain_plain(x, *ws, dtype=dtype)
    assert out.shape == (b, h, w, c) and out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2.0 ** -6 * ref.float().abs().max().item()


@pytest.mark.parametrize("b,h,w,f,n,damp", [
    (1, 128, 256, 64, 2, 0.3), (1, 64, 128, 128, 3, 0.3),
    (1, 32, 64, 256, 22, 0.1),      # the ResNet-101 stages at 512x1024
    (8, 128, 256, 64, 2, 0.3), (8, 64, 128, 128, 3, 0.3),
    (8, 32, 64, 256, 22, 0.1),      # ... served at bs 8 (res101_bs8)
    (2, 32, 64, 512, 2, 0.3),       # layer4 of ResNet-101-FPN, 1024x2048, bs 2
    (1, 31, 33, 256, 2, 0.3),       # M = 1023: a cut tile under a 128-wide expand
    (1, 75, 101, 128, 1, 1.0),      # M = 7575: a cut tile, 128-wide throughout
])
def test_bottleneck_chain_kernel_bf16_at_the_path_shapes(cuda, b, h, w, f, n,
                                                         damp):
    """bf16 on the tensor cores at each stage shape of the ResNet-101
    path (the expand damped as a trained net's is, so that 22 blocks stay
    in range), and with M not a multiple of the 64-row tile under both
    tile widths.  Max error <= 2^-5 * max|twin| for a chain (a one-ulp
    flip propagates through the blocks), 2^-6 for one undamped block."""
    c = 4 * f
    g = torch.Generator().manual_seed(h + w + f + n)
    x = torch.relu(torch.randn((b, h, w, c), generator=g)).to(cuda)
    ws = _chain_weights(g, n, c, f, cuda, damp)
    out = bottleneck_kernel.bottleneck_chain(x, *ws, dtype=torch.bfloat16)
    ref = bottleneck_kernel.bottleneck_chain_plain(x, *ws, dtype=torch.bfloat16)
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** (-6 if n == 1 else -5) * ref.float().abs().max().item()


def test_bottleneck_chain_kernel_input_untouched(cuda):
    """The kernel updates a copy of the residual stream, never x."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 4, 6, 256), generator=g).to(cuda, torch.bfloat16)
    keep = x.clone()
    ws = _chain_weights(g, 2, 256, 64, cuda)
    bottleneck_kernel.bottleneck_chain(x, *ws, dtype=torch.bfloat16)
    assert torch.equal(x, keep)


@pytest.mark.parametrize("backbone,hw", [("tiny", (128, 192)),
                                         ("vgg16", (96, 160)),
                                         ("resnet50", (96, 160))])
def test_slice_on_card_matches_cpu(cuda, backbone, hw):
    """Batch of 2 through the whole f32 slice: card (kernels) against
    CPU (plain twins), same weights; detections match by class, IoU >=
    0.99 and |score| <= 1e-3 for at least 90% of them."""
    from scda_tpu_torch.config import get_config, replace_path
    from scda_tpu_torch.evals.detect import detection_match_rate
    from scda_tpu_torch.models.detector import forward_inference
    from scda_tpu_torch.models.faster_rcnn import build_model, init_weights

    cfg = replace_path(get_config("vgg16"), "model.backbone", backbone)
    cfg = replace_path(cfg, "model.compute_dtype", "float32")
    cfg = replace_path(cfg, "model.multiscale_roi", backbone == "resnet50")
    cfg = replace_path(cfg, "anchors.scales", (2.0, 4.0, 8.0))
    cpu = build_model(cfg.model, cfg.anchors.num_anchors)
    init_weights(cpu, torch.Generator().manual_seed(0), input_scale=1 / 64,
                 he_heads=True)
    gpu = build_model(cfg.model, cfg.anchors.num_anchors, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    h, w = hw
    image = torch.from_numpy(rng.randn(2, h, w, 3).astype(np.float32) * 50)
    info = torch.tensor([[h, w, 1.0], [h - 16, w - 32, 0.5]])
    d_cpu = forward_inference(cpu, image, info, cfg)
    d_gpu = forward_inference(gpu, image.to(cuda), info.to(cuda), cfg)
    rate, n_cpu, _ = detection_match_rate(d_cpu, d_gpu)
    assert n_cpu > 0 and rate >= 0.9


def test_wrappers_reject_bad_inputs(cuda):
    boxes = torch.zeros(1, 8, 4, device=cuda)
    with pytest.raises(TypeError):
        nms_kernel.nms_sorted(boxes.double(), torch.ones(1, 8, dtype=torch.bool,
                                                         device=cuda),
                              iou_threshold=0.5, max_output=2)
    with pytest.raises(ValueError):
        stem_kernel.vgg_stem_fused(torch.zeros(1, 3, 4, 3, device=cuda),
                                   torch.zeros(3, 3, 3, 64, device=cuda),
                                   torch.zeros(64, device=cuda),
                                   torch.zeros(3, 3, 64, 64, device=cuda),
                                   torch.zeros(64, device=cuda))
    feat = torch.zeros(1, 4, 4, 8, device=cuda).permute(0, 2, 1, 3)
    with pytest.raises(ValueError):
        roi_align_kernel.roi_align_contract(torch.zeros(1, 2, 3, 4, device=cuda),
                                            torch.zeros(1, 2, 3, 4, device=cuda),
                                            feat)
    ws = _chain_weights(torch.Generator().manual_seed(0), 1, 96, 24, cuda)
    with pytest.raises(ValueError):   # C and F not multiples of 64
        bottleneck_kernel.bottleneck_chain(torch.zeros(1, 4, 4, 96, device=cuda),
                                           *ws)
    with pytest.raises(TypeError):
        bottleneck_kernel.bottleneck_chain(torch.zeros(1, 4, 4, 96, device=cuda),
                                           *ws, dtype=torch.float16)


# ---- training: K1 at the proposal shape, the K2 backward, autograd -----

def test_nms_kernel_matches_twin_at_the_training_shape(cuda):
    """``train.proposal``: 12000 candidates per image -> 2000 at 0.7."""
    rng = np.random.RandomState(12)
    boxes = torch.from_numpy(_boxes(rng, 2, 12000, spread=900.0)).to(cuda)
    valid = torch.from_numpy(rng.rand(2, 12000) < 0.95).to(cuda)
    kw = dict(iou_threshold=0.7, max_output=2000)
    keep = nms_kernel.nms_sorted(boxes, valid, **kw)
    assert torch.equal(keep, nms_kernel.nms_sorted_plain(boxes, valid, **kw))
    assert int(keep.sum()) == 4000


@pytest.mark.parametrize("b,n,max_out", [(8, 6000, 300), (16, 12000, 2000)])
def test_nms_kernel_matches_twin_at_the_bench_batch_shapes(cuda, b, n,
                                                           max_out):
    """The proposal NMS of ``bench_torch.py``'s inference_bs8 (8 rows of
    6000 -> 300) and train_bs16 (16 rows of 12000 -> 2000, 188 words a
    row in the mask pass), at 0.7 on proposal-like boxes."""
    rng = np.random.RandomState(b * n)
    boxes = torch.from_numpy(_boxes(rng, b, n, spread=900.0)).to(cuda)
    valid = torch.from_numpy(rng.rand(b, n) < 0.95).to(cuda)
    kw = dict(iou_threshold=0.7, max_output=max_out)
    keep = nms_kernel.nms_sorted(boxes, valid, **kw)
    assert torch.equal(keep, nms_kernel.nms_sorted_plain(boxes, valid, **kw))
    assert int(keep.sum()) == b * max_out


def _bf16_ulp(v):
    _, e = torch.frexp(torch.clamp(v.abs(), min=2.0 ** -10))
    return torch.ldexp(torch.ones_like(v), e - 8)


@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,r,p,h,w,c,dense", [
    (1, 3, 7, 5, 9, 64, False), (2, 17, 7, 32, 64, 512, False),
    (1, 5, 7, 64, 128, 1024, False), (2, 9, 7, 16, 24, 64, True),
])
def test_roi_align_bwd_kernel_matches_twin(cuda, feat_dtype, b, r, p, h, w,
                                           c, dense):
    """dfeat from the gather kernel against the einsum twin: f32 at
    rtol=1e-5 and atol=1e-5 of the largest |dfeat| (the two sum in other
    orders, and an element that cancels keeps the rounding of its
    largest terms); bf16 within 2 ulps.  ``dense``: every tap nonzero,
    as adaptive rows can be."""
    g = torch.Generator(device=cuda).manual_seed(r * c)
    wy = torch.rand((b, r, p, h), generator=g, device=cuda)
    wx = torch.rand((b, r, p, w), generator=g, device=cuda)
    if not dense:
        wy, wx = wy * (wy > 0.7), wx * (wx > 0.7)
    cot = torch.randn((b, r, p, p, c), generator=g, device=cuda)
    before = roi_align_kernel.roi_align_contract_bwd.launches
    out = roi_align_kernel.roi_align_contract_bwd(wy, wx, cot, h, w,
                                                  feat_dtype)
    assert roi_align_kernel.roi_align_contract_bwd.launches == before + 1
    ref = roi_align_kernel.roi_align_contract_bwd_plain(wy, wx, cot,
                                                        feat_dtype)
    assert out.dtype == feat_dtype and out.shape == (b, h, w, c)
    if feat_dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5,
                                   atol=1e-5 * ref.abs().max().item())
    else:
        ref = ref.float()
        assert bool(((out.float() - ref).abs() <= 2 * _bf16_ulp(ref)).all())


@pytest.mark.parametrize("b,r,c,stride", [
    (8, 128, 512, 16),      # VGG16 train bs 8: g (8, 128, 7, 7, 512)
    (1, 128, 1024, 8),      # res101-ms train: both levels
    (1, 128, 1024, 16),
])
@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_repeats_bit_for_bit(cuda, b, r, c, stride,
                                                  feat_dtype):
    """Two launches of the K2 backward on the same inputs, at the training
    paths' shapes (proposal-like rois, two samples per bin edge), give
    equal bits, and both stay within the twin's tolerances: f32 rtol
    1e-5, atol 1e-5 of the largest |dfeat|; bf16 within 2 ulps."""
    from scda_tpu_torch.ops import roi_ops
    from scda_tpu_torch.utils.kernel_probe import proposal_boxes

    h, w = 512 // stride, 1024 // stride
    gen = torch.Generator().manual_seed(stride)
    wy, wx = roi_ops.roi_align_axis_weights(
        proposal_boxes(gen, b, r, False).to(cuda), h, w, output_size=7,
        spatial_scale=1.0 / stride, sampling_ratio=2)
    cot = torch.randn((b, r, 7, 7, c), generator=gen).to(cuda)
    first = roi_align_kernel.roi_align_contract_bwd(wy, wx, cot, h, w,
                                                    feat_dtype)
    second = roi_align_kernel.roi_align_contract_bwd(wy, wx, cot, h, w,
                                                     feat_dtype)
    assert torch.equal(first, second)
    ref = roi_align_kernel.roi_align_contract_bwd_plain(wy, wx, cot,
                                                        feat_dtype)
    if feat_dtype == torch.float32:
        torch.testing.assert_close(first, ref, rtol=1e-5,
                                   atol=1e-5 * ref.abs().max().item())
    else:
        ref = ref.float()
        assert bool(((first.float() - ref).abs()
                     <= 2 * _bf16_ulp(ref)).all())


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_roi_align_autograd_on_card(cuda, sampling_ratio):
    """Rois on both images of a batch of 2 through ``roi_align_grouped``:
    the feature gradient (K2 backward) against the twin's under
    autograd, f32 at rtol=atol=1e-5."""
    from scda_tpu_torch.ops import roi_ops

    rng = np.random.RandomState(sampling_ratio)
    feat = torch.from_numpy(rng.randn(2, 12, 20, 64).astype(np.float32))
    rois = torch.from_numpy(_boxes(rng, 2, 13, spread=250.0)).to(cuda)
    kw = dict(output_size=7, sampling_ratio=sampling_ratio)
    f_k = feat.to(cuda).requires_grad_()
    out = roi_ops.roi_align_grouped(f_k, rois, **kw)
    cot = torch.randn(out.shape, device=cuda)
    before = roi_align_kernel.roi_align_contract_bwd.launches
    out.backward(cot)
    assert roi_align_kernel.roi_align_contract_bwd.launches == before + 1
    wy, wx = roi_ops.roi_align_axis_weights(rois, 12, 20, **kw)
    f_p = feat.to(cuda).requires_grad_()
    roi_align_kernel.roi_align_contract_plain(wy, wx, f_p).backward(cot)
    assert f_k.grad.abs().max() > 0
    torch.testing.assert_close(f_k.grad, f_p.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bottleneck_chain_autograd_on_card(cuda, dtype):
    """K4 forward, K4 backward kernel: every input's gradient against the
    twin's own under autograd (f32 on the inputs rounded to ``dtype``),
    at rtol=atol=1e-4; the backward kernel launched once."""
    g = torch.Generator().manual_seed(5)
    x = torch.relu(torch.randn((1, 5, 7, 256), generator=g)).to(cuda)
    ws = _chain_weights(g, 2, 256, 64, cuda)
    cot = torch.randn((1, 5, 7, 256), generator=g).to(cuda, dtype)
    ins = [t.clone().requires_grad_() for t in (x, *ws)]
    before = bottleneck_kernel.bottleneck_chain.launches
    before_bwd = bottleneck_kernel.bottleneck_chain_bwd.launches
    bottleneck_kernel.bottleneck_chain(*ins, dtype=dtype).backward(cot)
    assert bottleneck_kernel.bottleneck_chain.launches == before + 1
    assert bottleneck_kernel.bottleneck_chain_bwd.launches == before_bwd + 1
    refs = [t.to(dtype).float().requires_grad_() for t in (x, *ws)]
    bottleneck_kernel.bottleneck_chain_plain(
        *refs, dtype=torch.float32).backward(cot.float())
    for t, ref in zip(ins, refs):
        assert t.grad.abs().max() > 0
        torch.testing.assert_close(t.grad, ref.grad, rtol=1e-4, atol=1e-4)


# chip_smoke.py's remat gate: per map, max |d| over the map's largest
# magnitude at most max(REMAT_FLOOR, PERTURB_FACTOR x the twin's own
# remat's gap from the f32 forward kernel's chain).
REMAT_FLOOR = 1e-5
PERTURB_FACTOR = 4.0


def _chain_bwd_gap(args, cot, dtype, needs=bottleneck_kernel.ALL_GRADS):
    """K4's backward kernel, its twin linearised at the kernel's own remat
    (the launcher's views of its workspace), and that remat against the
    f32 forward kernel's chain: (kernel grads, per-gradient ||k - p|| /
    ||p||, per-map remat gaps, their bounds)."""
    bk = bottleneck_kernel
    launch = bk.chain_bwd_launcher(*args, cot, dtype=dtype, needs=needs)
    out = launch()
    rounded = bk.chain_bwd_operands(args[0], args[1:], dtype)[:7]
    ref = bk.bottleneck_chain_bwd_plain(*rounded, cot, dtype=torch.float32,
                                        needs=needs, remat=launch.remat)
    gaps = [None if o is None else float((o - r).norm() / r.norm())
            for o, r in zip(out, ref)]
    fwd = bk.chain_remat_kernel(*rounded)
    remat_gaps, _ = bk.remat_gaps(launch.remat, fwd)
    twin_gaps, _ = bk.remat_gaps(bk.chain_remat_plain(*rounded), fwd)
    bounds = [max(REMAT_FLOOR, PERTURB_FACTOR * v) for v in twin_gaps]
    return out, gaps, remat_gaps, bounds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,f,n", [
    (1, 3, 2, 64, 2), (2, 7, 9, 64, 3), (1, 5, 11, 128, 1),
    (2, 1, 1, 64, 1), (1, 33, 17, 128, 3),
])
def test_bottleneck_chain_bwd_kernel_matches_twin(cuda, dtype, b, h, w, f,
                                                  n):
    """Ragged maps (M not a multiple of the 64-row tile; every 3x3 tap at
    the padding where H or W <= 3): all seven gradients against the twin
    linearised at the kernel's own remat (both see the same relu gates),
    ||k - p|| <= 1e-4 ||p||; the remat within the remat gate of the f32
    forward kernel's chain."""
    c = 4 * f
    g = torch.Generator().manual_seed(h * w + f + n)
    x = torch.relu(torch.randn((b, h, w, c), generator=g)).to(cuda)
    ws = _chain_weights(g, n, c, f, cuda)
    cot = torch.randn((b, h, w, c), generator=g).to(cuda, dtype)
    out, gaps, remat_gaps, bounds = _chain_bwd_gap((x, *ws), cot, dtype)
    assert all(o.dtype == torch.float32 and o.shape == t.shape
               for o, t in zip(out, (x, *ws)))
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert max(gaps) <= 1e-4, gaps
    assert all(a <= b for a, b in zip(remat_gaps, bounds)), (remat_gaps,
                                                              bounds)


@pytest.mark.parametrize("b,h,w,f,n,damp", [
    (1, 64, 128, 128, 3, 0.3), (1, 32, 64, 256, 22, 0.1),
    (8, 64, 128, 128, 3, 0.3), (8, 32, 64, 256, 22, 0.1),
    (2, 32, 64, 512, 2, 0.3),
])
def test_bottleneck_chain_bwd_kernel_at_the_path_shapes(cuda, b, h, w, f, n,
                                                        damp):
    """layer2 and layer3 of ResNet-101 at 512x1024, bs 1 and 8, and
    layer4 of ResNet-101-FPN at 1024x2048, bs 2, bf16
    forward, the gradients the model asks for (x, w1, w2, w3): within
    1e-4 of each norm of the twin at the kernel's own remat, the remat
    within the remat gate, and two launches bit-equal."""
    c = 4 * f
    g = torch.Generator().manual_seed(b + f + n)
    x = torch.relu(torch.randn((b, h, w, c), generator=g)).to(
        cuda, torch.bfloat16)
    ws = _chain_weights(g, n, c, f, cuda, damp)
    cot = torch.randn((b, h, w, c), generator=g).to(cuda, torch.bfloat16)
    needs = (True, True, False, True, False, True, False)
    out, gaps, remat_gaps, bounds = _chain_bwd_gap((x, *ws), cot,
                                                   torch.bfloat16, needs)
    assert [o is None for o in out] == [not v for v in needs]
    assert max(v for v in gaps if v is not None) <= 1e-4, gaps
    assert all(a <= b for a, b in zip(remat_gaps, bounds)), (remat_gaps,
                                                              bounds)
    again = bottleneck_kernel.bottleneck_chain_bwd(
        x, *ws, cot, dtype=torch.bfloat16, needs=needs)
    assert all(torch.equal(a, o) for a, o in zip(again, out) if o is not None)


def test_bottleneck_chain_bwd_kernel_repeats_bit_for_bit(cuda):
    """Two launches on the same inputs, all seven gradients, split
    partial sums included: the same bits."""
    g = torch.Generator().manual_seed(3)
    x = torch.relu(torch.randn((2, 9, 13, 256), generator=g)).to(cuda)
    ws = _chain_weights(g, 3, 256, 64, cuda)
    cot = torch.randn((2, 9, 13, 256), generator=g).to(cuda)
    first = bottleneck_kernel.bottleneck_chain_bwd(x, *ws, cot,
                                                   dtype=torch.float32)
    second = bottleneck_kernel.bottleneck_chain_bwd(x, *ws, cot,
                                                    dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_bottleneck_chain_backward_on_card_is_the_kernel(cuda, monkeypatch):
    """Under autograd on CUDA the chain's backward launches the kernel
    once and never runs the twin: the twin's backward and remat raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("the twin ran on CUDA tensors")

    monkeypatch.setattr(bottleneck_kernel, "bottleneck_chain_bwd_plain",
                        refuse)
    monkeypatch.setattr(bottleneck_kernel, "chain_remat_plain", refuse)
    monkeypatch.setattr(bottleneck_kernel, "bottleneck_chain_plain", refuse)
    g = torch.Generator().manual_seed(7)
    x = torch.relu(torch.randn((1, 6, 5, 256), generator=g)).to(cuda)
    ws = _chain_weights(g, 2, 256, 64, cuda)
    ins = [x.requires_grad_()] + [w.requires_grad_() for w in ws]
    before = bottleneck_kernel.bottleneck_chain_bwd.launches
    bottleneck_kernel.bottleneck_chain(*ins, dtype=torch.bfloat16).sum(
        ).backward()
    assert bottleneck_kernel.bottleneck_chain_bwd.launches == before + 1
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in ins)


def test_bottleneck_chain_bwd_rejects_bad_inputs(cuda):
    """Bad shapes, devices and dtypes raise before any launch."""
    bk = bottleneck_kernel
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 4, 4, 256), generator=g).to(cuda)
    ws = _chain_weights(g, 1, 256, 64, cuda)
    cot = torch.randn((1, 4, 4, 256), generator=g).to(cuda)
    before = bk.bottleneck_chain_bwd.launches
    with pytest.raises(ValueError):     # g not shaped as x
        bk.bottleneck_chain_bwd(x, *ws, cot[:, :2])
    with pytest.raises(ValueError):     # g on another device
        bk.bottleneck_chain_bwd(x, *ws, cot.cpu())
    with pytest.raises(ValueError):     # weights on another device
        bk.bottleneck_chain_bwd(x, ws[0].cpu(), *ws[1:], cot)
    with pytest.raises(ValueError):     # w2 of the wrong width
        bk.bottleneck_chain_bwd(x, ws[0], ws[1], ws[2][:, :, :32], *ws[3:],
                                cot)
    with pytest.raises(TypeError):
        bk.bottleneck_chain_bwd(x, *ws, cot, dtype=torch.float16)
    with pytest.raises(TypeError):
        bk.bottleneck_chain_bwd(x, *ws, cot.long())
    with pytest.raises(ValueError):     # needs: seven bools
        bk.bottleneck_chain_bwd(x, *ws, cot, needs=(True,) * 6)
    ws96 = _chain_weights(g, 1, 96, 24, cuda)
    with pytest.raises(ValueError):     # C and F not multiples of 64
        bk.bottleneck_chain_bwd(torch.zeros(1, 4, 4, 96, device=cuda), *ws96,
                                torch.zeros(1, 4, 4, 96, device=cuda))
    assert bk.bottleneck_chain_bwd.launches == before


def _refusal_cases(cuda):
    z = lambda *s: torch.zeros(s, device=cuda)
    req = lambda t: t.requires_grad_()
    ws = _chain_weights(torch.Generator().manual_seed(0), 1, 64, 64, cuda)
    return {
        "nms_sorted": lambda: nms_kernel.nms_sorted(
            req(z(1, 8, 4)), torch.ones(1, 8, dtype=torch.bool, device=cuda),
            iou_threshold=0.5, max_output=4),
        "vgg_stem_fused": lambda: stem_kernel.vgg_stem_fused(
            z(1, 4, 4, 3), req(z(3, 3, 3, 64)), z(64), z(3, 3, 64, 64), z(64)),
        "roi_align_contract_fwd": lambda: roi_align_kernel.roi_align_contract_fwd(
            z(1, 2, 3, 4), z(1, 2, 3, 6), req(z(1, 4, 6, 8))),
        "roi_align_contract_bwd": lambda: roi_align_kernel.roi_align_contract_bwd(
            z(1, 2, 3, 4), z(1, 2, 3, 6), req(z(1, 2, 3, 3, 8)), 4, 6),
        "bottleneck_chain_fwd": lambda: bottleneck_kernel.bottleneck_chain_fwd(
            req(z(1, 2, 3, 64)), *ws),
        "bottleneck_chain_bwd": lambda: bottleneck_kernel.bottleneck_chain_bwd(
            z(1, 2, 3, 64), *ws, req(z(1, 2, 3, 64))),
    }


@pytest.mark.parametrize("wrapper", [
    "nms_sorted", "vgg_stem_fused", "roi_align_contract_fwd",
    "roi_align_contract_bwd", "bottleneck_chain_fwd", "bottleneck_chain_bwd",
])
def test_wrapper_refuses_to_drop_a_gradient_on_card(cuda, wrapper):
    """A ctypes wrapper called with grad mode on and an input that
    requires grad raises instead of returning a detached tensor; under
    ``no_grad`` it runs."""
    call = _refusal_cases(cuda)[wrapper]
    with pytest.raises(RuntimeError, match="grad|backward"):
        call()
    with torch.no_grad():
        call()


def _mined_rois(r, kind, h=32, w=64, stride=16.0):
    """(2, r, 4) rois in image coordinates on an (h, w) stride-16 map:
    ``map_sized`` regions spanning a third to all of the map, ``zeroed``
    ones (an invalid group's box), or both."""
    rng = np.random.RandomState(r)
    x1 = rng.rand(2, r) * 0.3 * w * stride
    y1 = rng.rand(2, r) * 0.3 * h * stride
    x2 = x1 + (0.35 + 0.65 * rng.rand(2, r)) * (w * stride - x1)
    y2 = y1 + (0.35 + 0.65 * rng.rand(2, r)) * (h * stride - y1)
    rois = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    if kind == "zeroed":
        rois[:] = 0.0
    elif kind == "mixed":
        rois[:, ::2] = 0.0
    return torch.from_numpy(rois)


@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["map_sized", "zeroed", "mixed"])
@pytest.mark.parametrize("r", [9, 1])
def test_roi_align_kernels_on_mined_regions(cuda, feat_dtype, kind, r):
    """K2 forward and backward on what SCDA's mining gives them: few
    (R = 9 or 1) map-sized rois per image, whose bins are many pixels
    wide, and the zeroed boxes of invalid groups (a 1x1 roi at the map's
    origin).  P = 7, C = 512 on a (2, 32, 64) map; forward f32 at 1e-5,
    bf16 rtol 1e-2 atol 1e-3; backward f32 at 1e-5 of the largest
    |dfeat|, bf16 within 2 ulps.  No row has more than 4 taps
    (``sampling_ratio`` 2), so the unrolled path runs."""
    from scda_tpu_torch.ops import roi_ops

    h, w, c, p = 32, 64, 512, 7
    g = torch.Generator(device=cuda).manual_seed(r)
    feat = torch.randn((2, h, w, c), generator=g, device=cuda).to(feat_dtype)
    rois = _mined_rois(r, kind).to(cuda)
    wy, wx = roi_ops.roi_align_axis_weights(rois, h, w, output_size=p)
    assert int((wy != 0).sum(-1).max()) <= 4 >= int((wx != 0).sum(-1).max())
    out = roi_align_kernel.roi_align_contract(wy, wx, feat)
    ref = roi_align_kernel.roi_align_contract_plain(wy, wx, feat)
    rtol, atol = (1e-5, 1e-5) if feat_dtype == torch.float32 else (1e-2, 1e-3)
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    assert bool(torch.isfinite(out).all())

    cot = torch.randn((2, r, p, p, c), generator=g, device=cuda)
    d = roi_align_kernel.roi_align_contract_bwd(wy, wx, cot, h, w, feat_dtype)
    d_ref = roi_align_kernel.roi_align_contract_bwd_plain(wy, wx, cot,
                                                          feat_dtype)
    assert bool(torch.isfinite(d).all())
    if feat_dtype == torch.float32:
        torch.testing.assert_close(d, d_ref, rtol=1e-5,
                                   atol=1e-5 * d_ref.abs().max().item())
    else:
        d_ref = d_ref.float()
        assert bool(((d.float() - d_ref).abs() <= 2 * _bf16_ulp(d_ref)).all())
    if kind == "zeroed":   # only the pixels around the origin are touched
        assert float(d[:, 2:].abs().max()) == 0.0
        assert float(d[:, :, 2:].abs().max()) == 0.0


def test_three_roi_align_backwards_accumulate_into_two_maps(cuda):
    """The SCDA step's shape: two poolings differentiate one map (the
    sampled rois and the source regions), a third another map.  Each
    backward launches once with its own zeroed buffer and autograd adds
    the two; a zero-weight region contributes exactly 0."""
    from scda_tpu_torch.ops import roi_ops

    h, w, c = 32, 64, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    src = torch.randn((2, h, w, c), generator=g, device=cuda).requires_grad_()
    tgt = torch.randn((2, h, w, c), generator=g, device=cuda).requires_grad_()
    rois = torch.from_numpy(_boxes(np.random.RandomState(1), 2, 16,
                                   spread=700.0)).to(cuda)
    regions = _mined_rois(9, "mixed").to(cuda)
    weight = (regions[..., 2] > 0).float()              # zeroed boxes: 0
    before = roi_align_kernel.roi_align_contract_bwd.launches

    def loss(pool, f_src, f_tgt):
        a = pool(f_src, rois).square().sum()
        b = (pool(f_src, regions).square().sum((2, 3, 4)) * weight).sum()
        c_ = (pool(f_tgt, regions).sum((2, 3, 4)) * weight).sum()
        return a + b + c_

    loss(lambda f, r: roi_ops.roi_align_grouped(f, r, output_size=7),
         src, tgt).backward()
    assert roi_align_kernel.roi_align_contract_bwd.launches == before + 3

    def plain(f, r):
        wy, wx = roi_ops.roi_align_axis_weights(r, h, w, output_size=7)
        return roi_align_kernel.roi_align_contract_plain(wy, wx, f)

    src_p = src.detach().clone().requires_grad_()
    tgt_p = tgt.detach().clone().requires_grad_()
    loss(plain, src_p, tgt_p).backward()
    for got, want in ((src.grad, src_p.grad), (tgt.grad, tgt_p.grad)):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
    # The target map is reached by the valid regions alone: its origin
    # pixel, which only zeroed boxes pool, has no gradient at all.
    valid_x1 = regions[..., 0][weight > 0].min() / 16.0
    if float(valid_x1) > 2.0:
        assert float(tgt.grad[:, :, 0].abs().max()) == 0.0


@pytest.mark.parametrize("d_update", ["joint", "alternating"])
def test_scda_step_on_card_matches_cpu(cuda, d_update):
    """One f32 SCDA step on ``tiny`` on the card (kernels) against the
    same step on the CPU (twins), same seeds: metrics at rtol 1e-4, and
    the launches of one step: K1 2, K2 3 forward and 3 backward."""
    from scda_tpu_torch.adapt import scda
    from scda_tpu_torch.config import get_config, replace_path
    from scda_tpu_torch.models.faster_rcnn import build_model
    from scda_tpu_torch.train.state import create_train_state

    cfg = get_config("vgg16")
    for path, value in (("model.backbone", "tiny"), ("model.num_classes", 5),
                        ("model.compute_dtype", "float32"),
                        ("model.rpn_channels", 64),
                        ("data.image_size", (128, 192)),
                        ("anchors.scales", (2.0, 4.0, 8.0)),
                        ("train.proposal.pre_nms_top_n", 256),
                        ("train.proposal.post_nms_top_n", 64),
                        ("train.rpn_target.batch_size", 64),
                        ("train.roi_target.batch_size", 32),
                        ("adapt.enabled", True), ("adapt.num_groups", 4),
                        ("adapt.mining_top_n", 32), ("adapt.d_channels", 16),
                        ("adapt.d_update", d_update)):
        cfg = replace_path(cfg, path, value)
    rng = np.random.RandomState(0)
    gt = np.zeros((2, 8, 5), np.float32)
    gt[:, 0] = [20.0, 30.0, 90.0, 100.0, 2.0]
    gt[:, 1] = [100.0, 20.0, 170.0, 90.0, 1.0]
    info = np.tile(np.array([[128, 192, 1.0]], np.float32), (2, 1))
    batch = [rng.randn(2, 128, 192, 3).astype(np.float32), info, gt,
             np.full(2, 2, np.int32), rng.randn(2, 128, 192, 3).astype(
                 np.float32) + 0.5, info]

    wrappers = (nms_kernel.nms_sorted, roi_align_kernel.roi_align_contract,
                roi_align_kernel.roi_align_contract_bwd)
    metrics = {}
    for device in ("cpu", cuda):
        model = build_model(cfg.model, cfg.anchors.num_anchors,
                            generator=torch.Generator().manual_seed(1),
                            device=device)
        d_model = scda.init_discriminator(
            cfg, torch.Generator().manual_seed(2), device)
        state = scda.create_scda_state(cfg, create_train_state(cfg, model),
                                       d_model)
        step = scda.make_scda_train_step(model, d_model, cfg)
        before = [w.launches for w in wrappers]
        # Uniforms and Gumbel noise drawn on the CPU for both devices:
        # the two devices' generators give different streams.
        torch.manual_seed(3)
        draws = {"anchor": torch.rand(2, 2, 8 * 12 * 9).to(device),
                 "roi": torch.rand(2, 2, 64 + 8).to(device)}
        for name in ("mine_src", "mine_tgt"):
            e = -torch.log(torch.rand(2, 3 + 1, 32).clamp_min(1e-20))
            gum = (-torch.log(e)).to(device)
            draws[name] = {"g0": gum[:, 0], "gs": gum[:, 1:]}
        _, m = step(state, *(torch.from_numpy(a).to(device) for a in batch),
                    draws=draws)
        metrics[str(device)] = {k: float(v) for k, v in m.items()}
        if device != "cpu":
            assert [w.launches - b for w, b in zip(wrappers, before)] == [
                2, 3, 3]
        assert state.step == 1
    cpu, card = metrics["cpu"], metrics[str(cuda)]
    assert set(cpu) == set(card) and "adv" in cpu
    for k, v in cpu.items():
        np.testing.assert_allclose(card[k], v, rtol=1e-4, err_msg=k)


# ---- the shapes of the protocols path (KITTI geometry, fidelity smoke,
# align_legacy serving) -----------------------------------------------------

def test_roi_align_kernel_on_legacy_weights(cuda):
    """K2 fed the reference lineage's RoI-Align weights (``align_legacy``:
    two taps a row at bin corners, the last half-cell extrapolating, rows
    outside the map zero) at VGG16's stride-16 map, R=300: f32 within
    1e-5, bf16 features within rtol 1e-2, atol 1e-3, as on the path."""
    from scda_tpu_torch.ops import roi_ops

    g = torch.Generator().manual_seed(14)
    h, w, c, r = 32, 64, 512, 300
    xy = torch.rand((1, r, 2), generator=g) * torch.tensor([w * 16., h * 16.])
    wh = torch.rand((1, r, 2), generator=g) * 400 + 2
    # Some boxes reach past the map's right and bottom edges.
    rois = torch.cat([xy - 40, xy + wh], -1).to(cuda)
    ys, xs = roi_ops._legacy_sample_coords(rois, 1.0 / 16, 7)
    wy, wx = (roi_ops._legacy_axis_weights(ys, h),
              roi_ops._legacy_axis_weights(xs, w))
    assert bool((wy < 0).any() or (wx < 0).any())   # extrapolated taps
    feat = torch.randn((1, h, w, c), generator=g).to(cuda)
    for f, rtol, atol in ((feat, 1e-5, 1e-5),
                          (feat.to(torch.bfloat16), 1e-2, 1e-3)):
        out = roi_align_kernel.roi_align_contract(wy, wx, f)
        ref = roi_align_kernel.roi_align_contract_plain(wy, wx, f)
        torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 256, 640), (1, 64, 96)])
def test_stem_kernel_at_the_protocol_canvases(cuda, dtype, shape):
    """K3 on the KITTI canvas (256x640) and the fidelity smoke's (64x96):
    f32 within 1e-4, bf16 within 2 ulps."""
    from scda_tpu_torch.utils.kernel_probe import stem_inputs

    b, h, w = shape
    x, k1, b1, k2, b2 = stem_inputs(torch.Generator().manual_seed(h), b,
                                    "cpu")
    x = x[:, :h, :w].contiguous().to(cuda)
    k1, b1, k2, b2 = (t.to(cuda) for t in (k1, b1, k2, b2))
    out = stem_kernel.vgg_stem_fused(x, k1, b1, k2, b2, dtype=dtype).float()
    ref = stem_kernel.vgg_stem_plain(x, k1, b1, k2, b2, dtype=dtype).float()
    assert out.shape == (b, h // 2, w // 2, 64)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        assert bool(((out - ref).abs() <= 2 * _bf16_ulp(ref)).all())


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("max_out", [300, 2000])
def test_nms_kernel_at_the_kitti_canvas(cuda, clustered, max_out):
    """K1 over every anchor of the 256x640 canvas (16 x 40 x 9 = 5760,
    under the 6000 and 12000 top-N), to the serving and training
    budgets."""
    from scda_tpu_torch.utils.kernel_probe import proposal_boxes

    n = 16 * 40 * 9
    g = torch.Generator().manual_seed(max_out)
    boxes = proposal_boxes(g, 1, n, clustered).to(cuda)
    valid = (torch.rand((1, n), generator=g) < 0.95).to(cuda)
    keep = nms_kernel.nms_sorted(boxes, valid, iou_threshold=0.7,
                                 max_output=max_out)
    plain = nms_kernel.nms_sorted_plain(boxes, valid, iou_threshold=0.7,
                                        max_output=max_out)
    assert torch.equal(keep, plain)

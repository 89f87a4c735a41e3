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

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    (8, 40, 56), (8, 512, 1024),
])
def test_stem_kernel_matches_twin_bf16(cuda, shape):
    """bf16, where conv1_2 runs on the tensor cores: ragged even sizes
    (tiles cut at the right and bottom edges), a batch of 8, and the
    training path's shape.  conv1_2's f32 sums are taken in another order
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
    """dfeat from the atomicAdd kernel against the einsum twin: f32 at
    rtol=1e-5 and atol=1e-5 of the largest |dfeat| (the order of the
    adds varies, and an element that cancels keeps the rounding of its
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
    """K4 forward, twin remat backward: every input's gradient against
    the twin's own under autograd (f32 on the inputs rounded to
    ``dtype``), at rtol=atol=1e-4."""
    g = torch.Generator().manual_seed(5)
    x = torch.relu(torch.randn((1, 5, 7, 256), generator=g)).to(cuda)
    ws = _chain_weights(g, 2, 256, 64, cuda)
    cot = torch.randn((1, 5, 7, 256), generator=g).to(cuda, dtype)
    ins = [t.clone().requires_grad_() for t in (x, *ws)]
    before = bottleneck_kernel.bottleneck_chain.launches
    bottleneck_kernel.bottleneck_chain(*ins, dtype=dtype).backward(cot)
    assert bottleneck_kernel.bottleneck_chain.launches == before + 1
    refs = [t.to(dtype).float().requires_grad_() for t in (x, *ws)]
    bottleneck_kernel.bottleneck_chain_plain(
        *refs, dtype=torch.float32).backward(cot.float())
    for t, ref in zip(ins, refs):
        assert t.grad.abs().max() > 0
        torch.testing.assert_close(t.grad, ref.grad, rtol=1e-4, atol=1e-4)


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
    }


@pytest.mark.parametrize("wrapper", [
    "nms_sorted", "vgg_stem_fused", "roi_align_contract_fwd",
    "roi_align_contract_bwd", "bottleneck_chain_fwd",
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

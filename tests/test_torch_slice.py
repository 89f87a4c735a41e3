"""The inference slice of the port against the JAX package, on the CPU
(f32): the weight bridge, then the whole slice for the ``tiny`` backbone
(tests/helpers.py:tiny_config), and at full width on a 64x96 canvas for
VGG16, ResNet-50, and ResNet-50 with multiscale RoI pooling (the lateral
projection before and after pooling; ``ms_fine_threshold`` lowered to 32
so that both pyramid levels serve rois on this canvas).

Both sides get the same weights, built with numpy and bridged.  Stage by
stage, each stage is fed the JAX side's inputs, so a mismatch points at
one stage:
  * features and RPN logits: rtol=atol=1e-4 (conv summation order);
  * ``propose`` on the same logits: the same valid slots, in the same
    order, boxes and scores at rtol=1e-6 — XLA's and PyTorch's exp differ
    by an ulp, so the decoded boxes may too;
  * pooled rois on the same features and boxes: rtol=atol=1e-5;
  * the RoI head: rtol=atol=1e-4;
  * the postprocess on the same logits: equal classes and validity,
    boxes and scores at rtol=1e-5.
End to end, detections match by class, IoU >= 0.99 and |score| within
1e-3 for at least 90% of them (near-tied scores may reorder).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import tiny_config
from scda_tpu.config import replace_path
from scda_tpu.models import detector as jdet
from scda_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from scda_tpu.models.faster_rcnn import build_model as jax_build_model
from scda_tpu.models.faster_rcnn import pool_rois as jax_pool_rois
from scda_tpu.models.rpn import propose as jax_propose
from scda_tpu.train.torch_convert import export_reference_detector
from scda_tpu_torch import bridge
from scda_tpu_torch.evals.detect import detection_match_rate
from scda_tpu_torch.models import detector as tdet
from scda_tpu_torch.models.backbones.vgg import VGG16_LAYOUT
from scda_tpu_torch.models.faster_rcnn import build_model, pool_rois
from scda_tpu_torch.models.rpn import propose
from test_torch_resnet import resnet_trees

import torch_numerics_state


@pytest.fixture(autouse=True, scope="module")
def _kept_numerics():
    """The CLIs' ``main`` sets the process-wide numerics
    (``scda_tpu_torch/utils/numerics.py``); they go back to what they
    were once this module is done."""
    with torch_numerics_state.kept():
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conv(rng, k, cin, cout, gain=1.0):
    w = rng.standard_normal((k, k, cin, cout), dtype=np.float32)
    return {"kernel": w * np.float32(gain * np.sqrt(2.0 / (k * k * cin))),
            "bias": rng.standard_normal(cout, dtype=np.float32) * np.float32(0.05)}


def _dense(rng, cin, cout):
    w = rng.standard_normal((cin, cout), dtype=np.float32)
    return {"kernel": w * np.float32(np.sqrt(2.0 / cin)),
            "bias": rng.standard_normal(cout, dtype=np.float32) * np.float32(0.05)}


def jax_params(backbone, cfg, seed=0):
    """A full JAX params tree from numpy, He-scaled so that activations
    stay O(1) and scores spread out."""
    rng = np.random.default_rng(seed)
    mc, a = cfg.model, cfg.anchors.num_anchors
    if backbone.startswith("resnet"):
        convs, head = resnet_trees(rng, int(backbone[len("resnet"):]))
        f8_ch, feat_ch, hid = 512, 1024, 2048
    elif backbone == "vgg16":
        convs, cin = {}, 3
        for item in VGG16_LAYOUT:
            if item != "M":
                idx, ch = item
                convs[f"conv{idx}"] = _conv(rng, 3, cin, ch)
                cin = ch
        head = {"fc6": _dense(rng, 512 * 49, 4096), "fc7": _dense(rng, 4096, 4096)}
        f8_ch, feat_ch, hid = 512, 512, 4096
    else:
        chans = (3, 16, 32, 48, 64)
        convs = {f"conv{i}": _conv(rng, 3, chans[i], chans[i + 1])
                 for i in range(4)}
        head = {"fc": _dense(rng, 64 * 49, 128)}
        f8_ch, feat_ch, hid = 48, 64, 128
    extra = ({"c3_proj": _conv(rng, 1, f8_ch, feat_ch)}
             if mc.multiscale_roi else {})
    return {
        "backbone": convs, "head": head,
        "rpn": {"conv": _conv(rng, 3, feat_ch, mc.rpn_channels),
                "cls_score": _conv(rng, 1, mc.rpn_channels, 2 * a),
                "bbox_pred": _conv(rng, 1, mc.rpn_channels, 4 * a, gain=0.3)},
        "cls_score": _dense(rng, hid, mc.num_classes),
        "bbox_pred": _dense(rng, hid, 4 * mc.num_classes),
        **extra,
    }


SLICES = {  # name: (backbone, multiscale_roi, ms_proj_after_pool)
    "tiny": ("tiny", False, False),
    "tiny_ms": ("tiny", True, False),
    "vgg16": ("vgg16", False, False),
    "resnet50": ("resnet50", False, False),
    "resnet50_ms": ("resnet50", True, False),
    "resnet50_ms_after_pool": ("resnet50", True, True),
}


def slice_config(name):
    backbone, ms, after = SLICES[name]
    if backbone == "tiny":
        cfg = replace_path(tiny_config(), "model.multiscale_roi", ms)
        return replace_path(cfg, "model.ms_fine_threshold", 48.0)
    cfg = tiny_config(num_classes=9, backbone=backbone)
    cfg = replace_path(cfg, "model.rpn_channels", 512)
    cfg = replace_path(cfg, "model.multiscale_roi", ms)
    cfg = replace_path(cfg, "model.ms_proj_after_pool", after)
    cfg = replace_path(cfg, "model.ms_fine_threshold", 32.0)
    return replace_path(cfg, "data.image_size", (64, 96))


class _FedJax:
    """Stands in for the flax module: returns given stage outputs."""

    def __init__(self, feat, rpn, head, f8=None, pooled=None):
        self.out = {JaxFasterRCNN.features: feat, JaxFasterRCNN.rpn_out: rpn,
                    JaxFasterRCNN.roi_head: head,
                    JaxFasterRCNN.features_pyramid: (f8, feat),
                    JaxFasterRCNN.pool_multiscale: pooled}

    def apply(self, variables, *args, method=None, **kw):
        return self.out[method]


class _FedTorch:
    def __init__(self, feat, rpn, head, f8=None, pooled=None):
        self.feat, self.rpn, self.head = feat, rpn, head
        self.f8, self.pooled = f8, pooled

    def features(self, image):
        return self.feat

    def features_pyramid(self, image):
        return self.f8, self.feat

    def pool_multiscale(self, f8, feat, rois):
        return self.pooled

    def rpn_out(self, feat):
        return self.rpn

    def roi_head(self, pooled, train=False):
        return self.head


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", params=list(SLICES))
def run(request):
    """Both packages on the same weights and images, stage by stage."""
    name = request.param
    backbone = SLICES[name][0]
    cfg = slice_config(name)
    mc = cfg.model
    params = jax_params(backbone, cfg)
    h, w = cfg.data.image_size
    rng = np.random.RandomState(1)
    image = rng.randn(2, h, w, 3).astype(np.float32)
    im_info = np.array([[h, w, 1.0], [h - 16, w - 32, 0.8]], np.float32)

    jm = jax_build_model(mc, num_anchors=cfg.anchors.num_anchors)
    var = {"params": params}
    x, info = jnp.asarray(image), jnp.asarray(im_info)
    # Each stage jitted: one XLA compile each beats op-by-op dispatch.
    if mc.multiscale_roi:
        f8, feat = jax.jit(lambda v, x: jm.apply(
            v, x, method=JaxFasterRCNN.features_pyramid))(var, x)
    else:
        f8 = None
        feat = jax.jit(lambda v, x: jm.apply(
            v, x, method=JaxFasterRCNN.features))(var, x)
    rpn = jax.jit(lambda v, f: jm.apply(v, f, method=JaxFasterRCNN.rpn_out))(var, feat)
    anchors = jdet.make_anchors(cfg, (feat.shape[1], feat.shape[2]))
    props = jax.jit(lambda c, b, a, i: jax_propose(c, b, a, i, cfg.test.proposal))(
        *rpn, anchors, info)
    if mc.multiscale_roi:
        pooled = jax.jit(lambda v, f8, f, r: jdet._pool_ms(
            jm, v["params"], f8, f, r, mc))(var, f8, feat, props.boxes)
    else:
        pooled = jax.jit(lambda f, r: jax_pool_rois(f, r, None, mc))(
            feat, props.boxes)
    head = jax.jit(lambda v, p: jm.apply(v, p, False, method=JaxFasterRCNN.roi_head))(
        var, pooled)
    fed = jax.jit(lambda x, i: jdet.forward_inference(
        _FedJax(feat, rpn, head, f8, pooled), params, x, i, cfg))(x, info)
    dets = jax.jit(lambda v, x, i: jdet.forward_inference(jm, v["params"], x, i, cfg))(
        var, x, info)

    sd = bridge.state_dict_from_jax(params, backbone)
    tm = build_model(mc, cfg.anchors.num_anchors)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return dict(backbone=backbone, cfg=cfg, params=params, sd=sd,
                image=image, im_info=im_info, model=tm, f8=f8, feat=feat,
                rpn=rpn, anchors=anchors, props=props, pooled=pooled,
                head=head, fed=fed, dets=dets)


def test_features_and_rpn_logits(run):
    with torch.no_grad():
        if run["cfg"].model.multiscale_roi:
            f8, feat = run["model"].features_pyramid(_t(run["image"]))
            np.testing.assert_allclose(_np(f8), np.asarray(run["f8"]),
                                       rtol=1e-4, atol=1e-4)
        else:
            feat = run["model"].features(_t(run["image"]))
        cls, bbox = run["model"].rpn_out(feat)
    np.testing.assert_allclose(_np(feat), np.asarray(run["feat"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(cls), np.asarray(run["rpn"][0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(bbox), np.asarray(run["rpn"][1]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backbone", ["tiny", "vgg16"])
def test_backbone_pyramid_matches_jax(backbone):
    """``return_pyramid``: the stride-8 and stride-16 maps against the
    flax backbone's, f32, rtol=atol=1e-4."""
    from scda_tpu.models.backbones.tiny import TinyBackbone
    from scda_tpu.models.backbones.vgg import VGG16Backbone

    cfg = slice_config(backbone)
    params = jax_params(backbone, cfg, seed=5)
    jax_backbone = (TinyBackbone(dtype=jnp.float32) if backbone == "tiny"
                    else VGG16Backbone(dtype=jnp.float32))
    x = np.random.RandomState(2).randn(1, 32, 48, 3).astype(np.float32)
    ref = jax_backbone.apply({"params": params["backbone"]}, jnp.asarray(x),
                             return_pyramid=True)
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           bridge.state_dict_from_jax(params, backbone).items()})
    with torch.no_grad():
        out = model.RCNN_base(_t(x).permute(0, 3, 1, 2), return_pyramid=True)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(_np(o.permute(0, 2, 3, 1)), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


def test_propose_same_logits(run):
    ref = run["props"]
    out = propose(_t(run["rpn"][0]), _t(run["rpn"][1]), _t(run["anchors"]),
                  _t(run["im_info"]), run["cfg"].test.proposal)
    np.testing.assert_array_equal(_np(out.valid), np.asarray(ref.valid))
    assert int(out.valid.sum()) > 0
    np.testing.assert_allclose(_np(out.boxes), np.asarray(ref.boxes),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(_np(out.scores), np.asarray(ref.scores),
                               rtol=1e-6, atol=1e-7)


def test_pooled_rois_same_inputs(run):
    mc = run["cfg"].model
    boxes = _t(run["props"].boxes)
    if mc.multiscale_roi:
        # Both pyramid levels must serve some rois, or the test is vacuous.
        area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
                * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
        fine = (area.sqrt() < mc.ms_fine_threshold)[_t(run["props"].valid)]
        assert 0 < int(fine.sum()) < fine.numel()
        with torch.no_grad():
            out = tdet._pool_ms(run["model"], _t(run["f8"]), _t(run["feat"]),
                                boxes, mc)
    else:
        out = pool_rois(_t(run["feat"]), boxes, None, mc)
    np.testing.assert_allclose(_np(out), np.asarray(run["pooled"]),
                               rtol=1e-5, atol=1e-5)


def test_pooled_rois_legacy_mode(run):
    mc = replace_path(run["cfg"].model, "pooling_mode", "align_legacy")
    ref = jax_pool_rois(run["feat"], run["props"].boxes, None, mc)
    out = pool_rois(_t(run["feat"]), _t(run["props"].boxes), None, mc)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_roi_head_same_pooled(run):
    with torch.no_grad():
        cls, bbox = run["model"].roi_head(_t(run["pooled"]))
    np.testing.assert_allclose(_np(cls), np.asarray(run["head"][0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(bbox), np.asarray(run["head"][1]),
                               rtol=1e-4, atol=1e-4)


def test_postprocess_same_logits(run):
    f8 = None if run["f8"] is None else _t(run["f8"])
    fed = _FedTorch(_t(run["feat"]), tuple(map(_t, run["rpn"])),
                    tuple(map(_t, run["head"])), f8, _t(run["pooled"]))
    out = tdet.forward_inference(fed, _t(run["image"]), _t(run["im_info"]),
                                 run["cfg"])
    ref = run["fed"]
    np.testing.assert_array_equal(_np(out.valid), np.asarray(ref.valid))
    assert int(out.valid.sum()) > 0
    np.testing.assert_array_equal(_np(out.classes)[_np(out.valid)],
                                  np.asarray(ref.classes)[np.asarray(ref.valid)])
    np.testing.assert_allclose(_np(out.scores), np.asarray(ref.scores),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(out.boxes), np.asarray(ref.boxes),
                               rtol=1e-5, atol=1e-3)


def test_end_to_end_match_rate(run):
    out = tdet.forward_inference(run["model"], _t(run["image"]),
                                 _t(run["im_info"]), run["cfg"])
    ref = run["dets"]
    rate, n_torch, n_jax = detection_match_rate(
        out, (ref.boxes, ref.scores, ref.classes, ref.valid))
    assert n_jax > 0 and rate >= 0.9, (rate, n_torch, n_jax)


def test_bridge_matches_exporter_and_model(run):
    """The bridge equals the JAX exporter key for key and value for
    value; the exporter leaves out ``c3_proj``, which the reference
    lineage does not have."""
    sd = run["sd"]
    assert set(sd) == set(run["model"].state_dict())
    if run["backbone"] != "tiny":
        ref = export_reference_detector(run["params"], run["backbone"])
        extra = ({"RCNN_c3_proj.weight", "RCNN_c3_proj.bias"}
                 if run["cfg"].model.multiscale_roi else set())
        assert set(sd) == set(ref) | extra
        for k in ref:
            np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)


def test_reference_checkpoint_loads(tmp_path):
    """A reference-layout ``{'model': sd}`` .pth with DataParallel
    prefixes loads into a fresh model, every tensor equal."""
    cfg = tiny_config()
    sd = bridge.state_dict_from_jax(jax_params("tiny", cfg, seed=2), "tiny")
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v)
                          for k, v in sd.items()}, "session": 1}, path)
    fresh = build_model(cfg.model, cfg.anchors.num_anchors,
                        generator=torch.Generator().manual_seed(5))
    bridge.load_reference_checkpoint(fresh, path)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(_np(v), sd[k], err_msg=k)


def test_unported_modes_raise():
    """The modes that once raised here now run: RoI pool and crop build
    and serve, and flat (R, 4) rois with batch indices pool as the same
    rois grouped do, in every mode; an unknown mode still raises."""
    cfg = tiny_config()
    image = torch.randn(1, 128, 192, 3) * 30
    info = torch.tensor([[128.0, 192.0, 1.0]])
    for mode in ("pool", "crop"):
        c = replace_path(cfg, "model.pooling_mode", mode)
        model = build_model(c.model, c.anchors.num_anchors)
        d = tdet.forward_inference(model, image, info, c)
        assert d.boxes.shape == (1, 16, 4)
        assert bool(torch.isfinite(d.boxes).all())
    feat = torch.randn(2, 4, 6, 64)
    rois = torch.tensor([[[0.0, 0.0, 40.0, 30.0], [8.0, 4.0, 90.0, 60.0]],
                         [[16.0, 8.0, 50.0, 50.0], [-8.0, 0.0, 20.0, 70.0]]])
    for mode in ("align", "align_legacy", "pool", "crop"):
        mc = replace_path(cfg.model, "pooling_mode", mode)
        grouped = pool_rois(feat, rois, None, mc)
        flat = pool_rois(feat, rois.reshape(4, 4),
                         torch.tensor([0, 0, 1, 1]), mc)
        torch.testing.assert_close(flat, grouped, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="pooling_mode"):
        build_model(replace_path(cfg.model, "pooling_mode", "warp"))


@pytest.mark.parametrize("ms_proj_after_pool", [False, True])
def test_resnet101_multiscale_builds(ms_proj_after_pool):
    """BASELINE config #5's model (cfgs/res101_ms.yml) builds with the
    reference lineage's layout plus ``RCNN_c3_proj``."""
    from scda_tpu.config import get_config

    mc = replace_path(get_config("res101").model, "multiscale_roi", True)
    mc = replace_path(mc, "ms_proj_after_pool", ms_proj_after_pool)
    model = build_model(mc)
    sd = model.state_dict()
    assert sd["RCNN_c3_proj.weight"].shape == (1024, 512, 1, 1)
    assert "RCNN_base.6.22.bn3.running_var" in sd
    assert "RCNN_top.0.2.conv3.weight" in sd
    assert not any(k.endswith("num_batches_tracked") for k in sd)


def test_cli_evaluates_torch_checkpoint(tmp_path):
    """test_net on the CPU: tiny net, synthetic set, a reference-layout
    checkpoint written here, detections JSON out."""
    from scda_tpu.config import get_config
    from scda_tpu_torch.cli import test_net

    cfg = replace_path(get_config("vgg16"), "model.backbone", "tiny")
    cfg = replace_path(cfg, "model.num_classes", 5)
    sd = bridge.state_dict_from_jax(jax_params("tiny", cfg, seed=3), "tiny")
    pth = str(tmp_path / "tiny.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    dets = str(tmp_path / "dets.json")
    rc = test_net.main([
        "--net", "tiny", "--device", "cpu", "--synth_images", "2",
        "--synth_size", "128", "192", "--torch_checkpoint", pth,
        "--dets_out", dets, "--set", "test.proposal.pre_nms_top_n=200",
        "test.proposal.post_nms_top_n=50",
    ])
    assert rc == 0 and os.path.exists(dets)


def test_cli_evaluates_resnet_checkpoint(tmp_path):
    """test_net --net res50 on the CPU: the res50 preset, a bridged
    reference-layout checkpoint, a 2-image synthetic set."""
    from scda_tpu.config import get_config
    from scda_tpu_torch.cli import test_net

    cfg = replace_path(get_config("res50"), "model.num_classes", 5)
    sd = bridge.state_dict_from_jax(jax_params("resnet50", cfg, seed=4),
                                    "resnet50")
    pth = str(tmp_path / "res50.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    dets = str(tmp_path / "dets.json")
    rc = test_net.main([
        "--net", "res50", "--device", "cpu", "--synth_images", "2",
        "--synth_size", "64", "96", "--torch_checkpoint", pth,
        "--dets_out", dets, "--set", "test.proposal.pre_nms_top_n=100",
        "test.proposal.post_nms_top_n=16",
    ])
    assert rc == 0 and os.path.exists(dets)


def test_match_rate_is_a_maximum_matching():
    """Two equal boxes: a's 0.5 is within 1e-3 of both of b's scores,
    a's 0.4994 only of b's 0.4994.  A greedy pass pairs 0.5 with 0.4994
    and strands the rest; the maximum matching pairs all.  A degenerate
    box (x2 < x1 - 1, no area) matches its equal."""
    box = [0.0, 0.0, 10.0, 10.0]
    boxes = np.array([[box, box, [30.0, 30.0, 27.0, 40.0]]], np.float32)
    classes = np.ones((1, 3), np.int64)
    valid = np.ones((1, 3), bool)
    a = (boxes, np.array([[0.5, 0.4994, 0.3]], np.float32), classes, valid)
    b = (boxes, np.array([[0.4994, 0.5006, 0.3]], np.float32), classes, valid)
    assert detection_match_rate(a, a) == (1.0, 3, 3)
    assert detection_match_rate(a, b) == (1.0, 3, 3)
    shifted = (boxes + 5.0, a[1], classes, valid)
    assert detection_match_rate(a, shifted)[0] == 0.0


def test_evaluate_model_through_shared_voc_eval(tmp_path):
    """evaluate_model: the port's DataLoader, inference and VOC
    evaluator; bf16 weights when the config asks for them."""
    from scda_tpu_torch.data.synthetic import make_memory_dataset
    from scda_tpu_torch.evals.detect import evaluate_model

    cfg = replace_path(tiny_config(), "test.bf16_weights", True)
    ds = make_memory_dataset(num_images=3, image_size=(128, 192),
                             tmpdir=str(tmp_path))
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    res = evaluate_model(model, ds, cfg, device="cpu", batch_size=2)
    assert set(ds.classes) <= set(res) and 0.0 <= res["mAP"] <= 1.0
    assert res["images_per_sec"] > 0
    assert model.RCNN_top[0].weight.dtype == torch.bfloat16
    assert model.RCNN_top[0].bias.dtype == torch.float32


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    from scda_tpu_torch.cli import test_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert test_net.main(["--net", "tiny", "--device", "cuda"]) == 2


# The tiny config of tests/helpers.py, built from the port's own config
# classes: helpers.py imports the JAX package's.
TINY_CONFIG_CODE = (
    "from scda_tpu_torch.config import (\n"
    "    AnchorConfig, Config, DataConfig, ModelConfig, ProposalConfig,\n"
    "    ROITargetConfig, RPNTargetConfig, TestConfig, TrainConfig,\n"
    "    replace_path)\n"
    "def tiny_config():\n"
    "    return Config(\n"
    "        model=ModelConfig(backbone='tiny', num_classes=5,\n"
    "                          compute_dtype='float32', rpn_channels=64),\n"
    "        train=TrainConfig(\n"
    "            batch_size=2,\n"
    "            proposal=ProposalConfig(pre_nms_top_n=256, post_nms_top_n=64,\n"
    "                                    nms_thresh=0.7, min_size=4.0),\n"
    "            rpn_target=RPNTargetConfig(batch_size=64),\n"
    "            roi_target=ROITargetConfig(batch_size=32)),\n"
    "        test=TestConfig(\n"
    "            proposal=ProposalConfig(pre_nms_top_n=128, post_nms_top_n=32,\n"
    "                                    nms_thresh=0.7, min_size=4.0),\n"
    "            max_dets_per_class=8, max_per_image=16),\n"
    "        data=DataConfig(scale=128, max_size=224, image_size=(128, 192),\n"
    "                        max_gt_boxes=8),\n"
    "        anchors=AnchorConfig(scales=(2.0, 4.0, 8.0)))\n"
)
# No module of JAX, flax or the JAX package (top-level name exactly) loaded.
NO_JAX_CODE = (
    "bad = sorted(k for k in sys.modules\n"
    "             if k.split('.')[0] in ('jax', 'flax', 'scda_tpu'))\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)


def test_port_imports_no_jax(tmp_path):
    """Importing the port, running its CPU slice and the evaluation CLI
    on ``tiny`` loads neither jax nor flax nor anything of the JAX
    package (a fresh interpreter: this one has them loaded)."""
    code = (
        "import sys, torch\n"
        + TINY_CONFIG_CODE +
        "import scda_tpu_torch, scda_tpu_torch.bridge, scda_tpu_torch.cli.test_net\n"
        "import scda_tpu_torch.evals.detect\n"
        "from scda_tpu_torch.models.faster_rcnn import build_model\n"
        "from scda_tpu_torch.models.detector import forward_inference\n"
        "cfg = tiny_config()\n"
        "m = build_model(cfg.model, cfg.anchors.num_anchors)\n"
        "d = forward_inference(m, torch.randn(1, 128, 192, 3) * 30,\n"
        "                      torch.tensor([[128.0, 192.0, 1.0]]), cfg)\n"
        "assert d.boxes.shape == (1, 16, 4)\n"
        "mc = replace_path(cfg.model, 'backbone', 'resnet50')\n"
        "mc = replace_path(mc, 'multiscale_roi', True)\n"
        "cfg = replace_path(cfg, 'model', mc)\n"
        "m = build_model(cfg.model, cfg.anchors.num_anchors)\n"
        "d = forward_inference(m, torch.randn(1, 64, 96, 3) * 30,\n"
        "                      torch.tensor([[64.0, 96.0, 1.0]]), cfg)\n"
        "assert bool(torch.isfinite(d.boxes).all())\n"
        "rc = scda_tpu_torch.cli.test_net.main([\n"
        "    '--net', 'tiny', '--device', 'cpu', '--synth_images', '2',\n"
        "    '--synth_size', '128', '192', '--set',\n"
        "    'test.proposal.pre_nms_top_n=200',\n"
        "    'test.proposal.post_nms_top_n=50', 'anchors.scales=2,4,8'])\n"
        "assert rc == 0, rc\n"
        + NO_JAX_CODE
    )
    env = {k: v for k, v in os.environ.items() if k != "SCDA_PLATFORM"}
    env["TMPDIR"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_port_sources_name_no_jax_package():
    """No file of the port, of its runbooks and tools (``scripts_torch/``),
    and neither ``chip_smoke.py`` nor ``bench_torch.py``, imports the JAX
    package: no ``import scda_tpu`` or ``from scda_tpu`` followed by a
    dot, a space or the end of the line, and no ``python -m scda_tpu.``;
    nor does a file of ``scripts_torch/`` import JAX or flax."""
    import re

    pattern = re.compile(r"\b(?:import|from)\s+scda_tpu(?:[.\s]|$)"
                         r"|-m\s+scda_tpu\.", re.M)
    jax = re.compile(r"\b(?:import|from)\s+(?:jax|flax)\b")
    paths = [os.path.join(REPO, f) for f in ("chip_smoke.py", "bench_torch.py")]
    for root, _, files in os.walk(os.path.join(REPO, "scda_tpu_torch")):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh", ".cc"))]
    scripts = [os.path.join(REPO, "scripts_torch", f)
               for f in sorted(os.listdir(os.path.join(REPO, "scripts_torch")))
               if f.endswith((".py", ".sh"))]
    assert len(paths) > 30 and len(scripts) == 11
    bad = []
    for path in paths + scripts:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pattern.search(line) or (path in scripts
                                            and jax.search(line)):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert not bad, bad

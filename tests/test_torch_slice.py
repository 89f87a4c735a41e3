"""The inference slice of the port against the JAX package, on the CPU
(f32): the weight bridge, then the whole slice for the ``tiny`` backbone
(tests/helpers.py:tiny_config) and VGG16 at full width on a 64x96 canvas.

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
    if backbone == "vgg16":
        convs, cin = {}, 3
        for item in VGG16_LAYOUT:
            if item != "M":
                idx, ch = item
                convs[f"conv{idx}"] = _conv(rng, 3, cin, ch)
                cin = ch
        head = {"fc6": _dense(rng, 512 * 49, 4096), "fc7": _dense(rng, 4096, 4096)}
        feat_ch, hid = 512, 4096
    else:
        chans = (3, 16, 32, 48, 64)
        convs = {f"conv{i}": _conv(rng, 3, chans[i], chans[i + 1])
                 for i in range(4)}
        head = {"fc": _dense(rng, 64 * 49, 128)}
        feat_ch, hid = 64, 128
    return {
        "backbone": convs, "head": head,
        "rpn": {"conv": _conv(rng, 3, feat_ch, mc.rpn_channels),
                "cls_score": _conv(rng, 1, mc.rpn_channels, 2 * a),
                "bbox_pred": _conv(rng, 1, mc.rpn_channels, 4 * a, gain=0.3)},
        "cls_score": _dense(rng, hid, mc.num_classes),
        "bbox_pred": _dense(rng, hid, 4 * mc.num_classes),
    }


def slice_config(backbone):
    if backbone == "tiny":
        return tiny_config()
    cfg = tiny_config(num_classes=9, backbone="vgg16")
    cfg = replace_path(cfg, "model.rpn_channels", 512)
    return replace_path(cfg, "data.image_size", (64, 96))


class _FedJax:
    """Stands in for the flax module: returns given stage outputs."""

    def __init__(self, feat, rpn, head):
        self.out = {JaxFasterRCNN.features: feat, JaxFasterRCNN.rpn_out: rpn,
                    JaxFasterRCNN.roi_head: head}

    def apply(self, variables, *args, method=None, **kw):
        return self.out[method]


class _FedTorch:
    def __init__(self, feat, rpn, head):
        self.feat, self.rpn, self.head = feat, rpn, head

    def features(self, image):
        return self.feat

    def rpn_out(self, feat):
        return self.rpn

    def roi_head(self, pooled, train=False):
        return self.head


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", params=["tiny", "vgg16"])
def run(request):
    """Both packages on the same weights and images, stage by stage."""
    backbone = request.param
    cfg = slice_config(backbone)
    params = jax_params(backbone, cfg)
    h, w = cfg.data.image_size
    rng = np.random.RandomState(1)
    image = rng.randn(2, h, w, 3).astype(np.float32)
    im_info = np.array([[h, w, 1.0], [h - 16, w - 32, 0.8]], np.float32)

    jm = jax_build_model(cfg.model, num_anchors=cfg.anchors.num_anchors)
    var = {"params": params}
    x, info = jnp.asarray(image), jnp.asarray(im_info)
    # Each stage jitted: one XLA compile each beats op-by-op dispatch.
    feat = jax.jit(lambda v, x: jm.apply(v, x, method=JaxFasterRCNN.features))(var, x)
    rpn = jax.jit(lambda v, f: jm.apply(v, f, method=JaxFasterRCNN.rpn_out))(var, feat)
    anchors = jdet.make_anchors(cfg, (feat.shape[1], feat.shape[2]))
    props = jax.jit(lambda c, b, a, i: jax_propose(c, b, a, i, cfg.test.proposal))(
        *rpn, anchors, info)
    pooled = jax.jit(lambda f, r: jax_pool_rois(f, r, None, cfg.model))(
        feat, props.boxes)
    head = jax.jit(lambda v, p: jm.apply(v, p, False, method=JaxFasterRCNN.roi_head))(
        var, pooled)
    fed = jax.jit(lambda x, i: jdet.forward_inference(
        _FedJax(feat, rpn, head), params, x, i, cfg))(x, info)
    dets = jax.jit(lambda v, x, i: jdet.forward_inference(jm, v["params"], x, i, cfg))(
        var, x, info)

    sd = bridge.state_dict_from_jax(params, backbone)
    tm = build_model(cfg.model, cfg.anchors.num_anchors)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return dict(backbone=backbone, cfg=cfg, params=params, sd=sd, image=image,
                im_info=im_info, model=tm, feat=feat, rpn=rpn, anchors=anchors,
                props=props, pooled=pooled, head=head, fed=fed, dets=dets)


def test_features_and_rpn_logits(run):
    with torch.no_grad():
        feat = run["model"].features(_t(run["image"]))
        cls, bbox = run["model"].rpn_out(feat)
    np.testing.assert_allclose(_np(feat), np.asarray(run["feat"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(cls), np.asarray(run["rpn"][0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(bbox), np.asarray(run["rpn"][1]),
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
    out = pool_rois(_t(run["feat"]), _t(run["props"].boxes), None,
                    run["cfg"].model)
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
    fed = _FedTorch(_t(run["feat"]), tuple(map(_t, run["rpn"])),
                    tuple(map(_t, run["head"])))
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
    sd = run["sd"]
    assert set(sd) == set(run["model"].state_dict())
    if run["backbone"] == "vgg16":
        ref = export_reference_detector(run["params"], "vgg16")
        assert set(sd) == set(ref)
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
    cfg = tiny_config()
    for key, value in (("backbone", "resnet101"), ("multiscale_roi", True),
                       ("pooling_mode", "pool"), ("pooling_mode", "crop")):
        with pytest.raises(NotImplementedError):
            build_model(replace_path(cfg.model, key, value))


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


def test_evaluate_model_through_shared_voc_eval(tmp_path):
    """evaluate_model: the shared DataLoader, the port's inference, the
    shared VOC evaluator; bf16 weights when the config asks for them."""
    from scda_tpu.data.synthetic import make_memory_dataset
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


def test_port_imports_no_jax():
    """Importing the port and running its CPU slice loads neither jax nor
    flax (a fresh interpreter: this one has them loaded)."""
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "from helpers import tiny_config\n"
        "import scda_tpu_torch, scda_tpu_torch.bridge, scda_tpu_torch.cli.test_net\n"
        "import scda_tpu_torch.evals.detect\n"
        "from scda_tpu_torch.models.faster_rcnn import build_model\n"
        "from scda_tpu_torch.models.detector import forward_inference\n"
        "cfg = tiny_config()\n"
        "m = build_model(cfg.model, cfg.anchors.num_anchors)\n"
        "d = forward_inference(m, torch.randn(1, 128, 192, 3) * 30,\n"
        "                      torch.tensor([[128.0, 192.0, 1.0]]), cfg)\n"
        "assert d.boxes.shape == (1, 16, 4)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "SCDA_PLATFORM"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr

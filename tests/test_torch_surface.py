"""The rest of the JAX package's surface in the port, against the JAX
package on the CPU (f32), on the same numpy-seeded inputs:

  * the flat-roi pooling forms (``roi_ops``): ``roi_pool`` exactly, and
    ``roi_crop``, ``roi_align`` (fixed and adaptive sampling,
    ``aligned``) and ``roi_align_legacy`` at rtol=atol=1e-5 (XLA fuses
    the bilinear sums into other roundings), with rois off the map,
    sub-cell rois and the 21/7 bin whose float ceil would widen it;
    their gradients (scatter-adds of the gathers) at rtol 1e-5, atol 1e-6;
  * a ``tiny`` detector per ``pooling_mode``: pooled rois on the same
    proposals at 1e-5, and the end-to-end detections (>= 90% matched, as
    the slice tests hold them); ``make_eval_step`` the same way;
  * ``train/torch_convert.py`` against JAX's ``load_pretrained_backbone``
    through ``bridge.state_dict_from_jax``: exactly equal weights, for a
    VGG16 features + classifier file (fc6 cut to a 1x1 pool, so the
    test stays small) and a torchvision ResNet-50 file; the
    ``weights_only`` refusal and ``allow_unsafe_pickle``;
  * ``utils/flops.py`` equal to JAX's for every preset and every
    ``cfgs/*.yml``; ``draw_detections`` bit-equal to JAX's;
  * the CLIs end to end on ``tiny``: ``demo``, ``test_net`` with each new
    flag (its ``--use_07_metric``, ``--iou_sweep`` and
    ``--coco_protocol`` numbers equal the JAX evaluators' on the same
    detections), ``trainval --pretrained --use_tfb
    --allow_unsafe_pickle`` (ResNet-50 at 64x96, one step).
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from scda_tpu.config import replace_path
from scda_tpu.models import detector as jdet
from scda_tpu.models.faster_rcnn import build_model as jax_build_model
from scda_tpu.models.faster_rcnn import pool_rois as jax_pool_rois
from scda_tpu.ops import roi_ops as jroi
from scda_tpu_torch import bridge
from scda_tpu_torch.evals.detect import detection_match_rate
from scda_tpu_torch.models import detector as tdet
from scda_tpu_torch.models.faster_rcnn import build_model, pool_rois
from scda_tpu_torch.ops import roi_ops as troi
from test_torch_slice import _conv, _dense, jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ RoI forms

def roi_inputs(seed=0):
    """Features (2, 9, 13, 5) and 48 rois in image coordinates: random
    ones reaching off the map, sub-cell ones, a whole-map one and the
    21-cell roi whose bins are 21/7 = 3 cells."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(2, 9, 13, 5).astype(np.float32)
    r = 40
    x1, y1 = rng.uniform(-60, 220, r), rng.uniform(-50, 150, r)
    w, h = rng.uniform(20, 160, r), rng.uniform(20, 130, r)
    boxes = [np.stack([x1, y1, x1 + w, y1 + h], 1)]
    sub = rng.uniform(0, 120, (4, 2))          # smaller than a cell
    boxes.append(np.concatenate([sub, sub + rng.uniform(0.5, 6, (4, 2))], 1))
    boxes.append(np.array([[0.0, 0.0, 320.0, 320.0],    # x2 - x1 + 1 = 21
                           [-100.0, -100.0, 400.0, 300.0],
                           [16.0, 16.0, 16.0, 16.0],
                           [500.0, 500.0, 600.0, 560.0]]))
    boxes = np.concatenate(boxes).astype(np.float32)
    bidx = rng.randint(0, 2, len(boxes)).astype(np.int32)
    return feat, boxes, bidx


FLAT_CASES = {
    "pool": ("roi_pool", {}),
    "crop": ("roi_crop", {}),
    "align_s2": ("roi_align", {"sampling_ratio": 2}),
    "align_adaptive": ("roi_align", {"sampling_ratio": 0}),
    "align_adaptive_aligned": ("roi_align", {"sampling_ratio": 0,
                                             "aligned": True}),
    "align_legacy": ("roi_align_legacy", {}),
}


@pytest.mark.parametrize("scale", [1 / 16, 1 / 8])
@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_flat_roi_forms_match_jax(case, scale):
    """Each form against JAX's, batch indices given apart and packed as
    column 0 of (R, 5) rois; ``roi_pool`` bit for bit."""
    name, kw = FLAT_CASES[case]
    feat, boxes, bidx = roi_inputs()
    ref = np.asarray(jax.jit(lambda f, b, i: getattr(jroi, name)(
        f, b, i, spatial_scale=scale, **kw))(feat, boxes, bidx))
    out = getattr(troi, name)(_t(feat), _t(boxes), _t(bidx),
                              spatial_scale=scale, **kw).numpy()
    packed = np.concatenate([bidx[:, None].astype(np.float32), boxes], 1)
    out5 = getattr(troi, name)(_t(feat), _t(packed), None,
                               spatial_scale=scale, **kw).numpy()
    assert out.shape == ref.shape == (len(boxes), 7, 7, 5)
    np.testing.assert_array_equal(out5, out)
    if name == "roi_pool":
        np.testing.assert_array_equal(out, ref)
        assert (out == 0).any() and (out != 0).any()
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_roi_pool_integer_bins():
    """The 21-cell roi at scale 1/16: bin p covers cells 3p .. 3p + 2,
    so each bin is the max of exactly those 3 x 3 cells (a float ceil of
    21/7 = 3.0000002 would widen it to 4)."""
    feat = np.arange(1 * 21 * 21 * 1, dtype=np.float32).reshape(1, 21, 21, 1)
    feat = feat[:, ::-1, ::-1].copy()           # maxima at the low corner
    out = troi.roi_pool(_t(feat), _t(np.array([[0, 0, 320, 320]], np.float32)),
                        None, spatial_scale=1 / 16).numpy()[0, ..., 0]
    want = feat[0, ::3, ::3, 0]
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("case", ["pool", "crop", "align_adaptive",
                                  "align_legacy"])
def test_flat_roi_gradients_match_jax(case):
    """d(sum(w * out)) / d(features) against ``jax.grad``."""
    name, kw = FLAT_CASES[case]
    feat, boxes, bidx = roi_inputs(seed=1)
    w = np.random.RandomState(2).randn(len(boxes), 7, 7, 5).astype(np.float32)
    ref = jax.grad(lambda f: jnp.sum(getattr(jroi, name)(
        f, boxes, bidx, **kw) * w))(jnp.asarray(feat))
    ft = _t(feat).requires_grad_()
    (getattr(troi, name)(ft, _t(boxes), _t(bidx), **kw) * _t(w)).sum().backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------- detector per mode

MODES = ("align", "align_legacy", "pool", "crop")


@pytest.fixture(scope="module")
def tiny_run():
    """The tiny detector's features and proposals in JAX, and the bridged
    port model, on two seeded images."""
    cfg = tiny_config()
    params = jax_params("tiny", cfg, seed=7)
    h, w = cfg.data.image_size
    image = np.random.RandomState(3).randn(2, h, w, 3).astype(np.float32)
    info = np.array([[h, w, 1.0], [h - 16, w - 32, 0.8]], np.float32)
    sd = bridge.state_dict_from_jax(params, "tiny")
    return dict(cfg=cfg, params=params, image=image, info=info, sd=sd)


def _port_model(cfg, sd):
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


@pytest.mark.parametrize("mode", MODES)
def test_tiny_detector_per_pooling_mode(tiny_run, mode):
    """Pooled rois of the same proposals (grouped in the port, as the
    detector passes them) at 1e-5, and the detections end to end."""
    cfg = replace_path(tiny_run["cfg"], "model.pooling_mode", mode)
    params = tiny_run["params"]
    jm = jax_build_model(cfg.model, num_anchors=cfg.anchors.num_anchors)
    x, info = jnp.asarray(tiny_run["image"]), jnp.asarray(tiny_run["info"])
    from scda_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
    feat = jm.apply({"params": params}, x, method=JaxFasterRCNN.features)
    rois = jnp.asarray(np.random.RandomState(4).uniform(
        -20, 150, (2, 24, 2)).astype(np.float32))
    rois = jnp.concatenate([rois, rois + 8 + 90 * jnp.abs(jnp.sin(rois))], -1)
    ref = jax_pool_rois(feat, rois, None, cfg.model)
    out = pool_rois(_t(feat), _t(rois), None, cfg.model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    dets = jax.jit(lambda p, x, i: jdet.forward_inference(jm, p, x, i, cfg))(
        params, x, info)
    model = _port_model(cfg, tiny_run["sd"])
    got = tdet.forward_inference(model, _t(tiny_run["image"]),
                                 _t(tiny_run["info"]), cfg)
    rate, n_port, n_jax = detection_match_rate(
        got, (dets.boxes, dets.scores, dets.classes, dets.valid))
    assert n_jax > 0 and rate >= 0.9, (mode, rate, n_port, n_jax)


def test_make_eval_step_matches_jax(tiny_run):
    from scda_tpu.train.steps import make_eval_step as jax_make_eval_step
    from scda_tpu_torch.train.steps import make_eval_step

    cfg = tiny_run["cfg"]
    jm = jax_build_model(cfg.model, num_anchors=cfg.anchors.num_anchors)
    ref = jax_make_eval_step(jm, cfg)(tiny_run["params"],
                                      jnp.asarray(tiny_run["image"]),
                                      jnp.asarray(tiny_run["info"]))
    step = make_eval_step(_port_model(cfg, tiny_run["sd"]), cfg)
    got = step(_t(tiny_run["image"]), _t(tiny_run["info"]))
    assert got.boxes.shape == (2, cfg.test.max_per_image, 4)
    assert not got.boxes.requires_grad and torch.is_inference(got.boxes)
    rate, n_port, n_jax = detection_match_rate(
        got, (ref.boxes, ref.scores, ref.classes, ref.valid))
    assert n_jax > 0 and rate >= 0.9, (rate, n_port, n_jax)


# ------------------------------------------------- pretrained backbones

def vgg16_file_and_tree(seed=0):
    """A torchvision-layout VGG16 state dict (features, classifier with
    fc6 on a 1x1 pool, and classifier.6, which the converter ignores)
    and a JAX params tree of the same shapes, as numpy."""
    from scda_tpu_torch.models.backbones.vgg import VGG16_LAYOUT

    rng = np.random.default_rng(seed)
    sd, convs, cin = {}, {}, 3
    for item in VGG16_LAYOUT:
        if item == "M":
            continue
        idx, cout = item
        sd[f"features.{idx}.weight"] = rng.standard_normal(
            (cout, cin, 3, 3), dtype=np.float32) * 0.05
        sd[f"features.{idx}.bias"] = rng.standard_normal(cout, dtype=np.float32)
        convs[f"conv{idx}"] = _conv(rng, 3, cin, cout)
        cin = cout
    for i, (o, n) in {0: (4096, 512), 3: (4096, 4096), 6: (10, 4096)}.items():
        sd[f"classifier.{i}.weight"] = rng.standard_normal(
            (o, n), dtype=np.float32) * 0.01
        sd[f"classifier.{i}.bias"] = rng.standard_normal(o, dtype=np.float32)
    tree = {"backbone": convs,
            "head": {"fc6": _dense(rng, 512, 4096), "fc7": _dense(rng, 4096, 4096)},
            "rpn": {"conv": _conv(rng, 3, 512, 64),
                    "cls_score": _conv(rng, 1, 64, 18),
                    "bbox_pred": _conv(rng, 1, 64, 36)},
            "cls_score": _dense(rng, 4096, 5), "bbox_pred": _dense(rng, 4096, 20)}
    return sd, tree


def resnet50_file(seed=0):
    """A torchvision ResNet-50 state dict with its ``fc`` and
    ``num_batches_tracked`` entries (both ignored)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.standard_normal(c, dtype=np.float32) * 0.1
        sd[f"{prefix}.running_mean"] = rng.standard_normal(c, dtype=np.float32) * 0.1
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.array(7)

    def conv(name, o, i, k):
        sd[name] = rng.standard_normal((o, i, k, k), dtype=np.float32) * 0.05

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (n, f) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), 1):
        for bi in range(n):
            p = f"layer{li}.{bi}"
            conv(f"{p}.conv1.weight", f, cin, 1)
            conv(f"{p}.conv2.weight", f, f, 3)
            conv(f"{p}.conv3.weight", 4 * f, f, 1)
            for j in (1, 2, 3):
                bn(f"{p}.bn{j}", 4 * f if j == 3 else f)
            if bi == 0:
                conv(f"{p}.downsample.0.weight", 4 * f, cin, 1)
                bn(f"{p}.downsample.1", 4 * f)
            cin = 4 * f
    sd["fc.weight"] = rng.standard_normal((10, 2048), dtype=np.float32)
    sd["fc.bias"] = np.zeros(10, np.float32)
    return sd


def _save(sd, path):
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("backbone", ["vgg16", "resnet50"])
def test_pretrained_backbone_matches_jax(backbone, tmp_path):
    """JAX's converter merged into its tree and bridged, against the
    port's converter on the bridged tree: every tensor equal; the heads
    keep their values."""
    from scda_tpu.train.torch_convert import (
        load_pretrained_backbone as jax_load,
    )
    from scda_tpu_torch.train.torch_convert import load_pretrained_backbone

    if backbone == "vgg16":
        sd, tree = vgg16_file_and_tree()
        cfg = replace_path(tiny_config(backbone="vgg16"), "model.pooling_size", 1)
    else:
        sd = resnet50_file()
        cfg = tiny_config(backbone="resnet50")
        tree = jax_params("resnet50", cfg, seed=2)
    path = _save(sd, str(tmp_path / "backbone.pth"))
    want = bridge.state_dict_from_jax(jax_load(tree, path, backbone), backbone)
    before = bridge.state_dict_from_jax(tree, backbone)
    model = _port_model(cfg, before)
    load_pretrained_backbone(model, path, backbone)
    got = model.state_dict()
    assert set(got) == set(want)
    changed = 0
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        changed += not np.array_equal(want[k], before[k])
    n_file = sum(1 for k in sd if not k.startswith(("fc.", "classifier.6"))
                 and not k.endswith("num_batches_tracked"))
    assert changed == n_file
    assert np.array_equal(got["RCNN_rpn.RPN_Conv.weight"].numpy(),
                          before["RCNN_rpn.RPN_Conv.weight"])


def test_pretrained_backbone_refuses(tmp_path):
    """A file that pickles a module loads only with
    ``allow_unsafe_pickle``; a wrong shape and a missing key raise, and
    ``tiny`` has no converter, as in the JAX package."""
    from scda_tpu_torch.models.backbones.vgg import VGG16_LAYOUT
    from scda_tpu_torch.train.torch_convert import load_pretrained_backbone

    layers, cin = [], 3
    for item in VGG16_LAYOUT:
        if item == "M":
            layers.append(torch.nn.MaxPool2d(2))
        else:
            while len(layers) < item[0]:
                layers.append(torch.nn.ReLU())
            layers.append(torch.nn.Conv2d(cin, item[1], 3, padding=1))
            cin = item[1]
    module = torch.nn.ModuleDict({"features": torch.nn.Sequential(*layers)})
    pickled = str(tmp_path / "module.pth")
    torch.save(module, pickled)
    cfg = replace_path(tiny_config(backbone="vgg16"), "model.pooling_size", 1)
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    with pytest.raises(RuntimeError, match="allow_unsafe_pickle"):
        load_pretrained_backbone(model, pickled, "vgg16")
    load_pretrained_backbone(model, pickled, "vgg16", allow_unsafe_pickle=True)
    torch.testing.assert_close(model.RCNN_base[28].weight,
                               module["features"][28].weight, rtol=0, atol=0)

    sd, _ = vgg16_file_and_tree()
    bad = dict(sd, **{"features.0.weight": np.zeros((64, 3, 5, 5), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained_backbone(model, _save(bad, str(tmp_path / "b.pth")), "vgg16")
    del sd["features.28.bias"]
    with pytest.raises(KeyError):
        load_pretrained_backbone(model, _save(sd, str(tmp_path / "m.pth")), "vgg16")
    with pytest.raises(ValueError, match="no converter"):
        load_pretrained_backbone(model, pickled, "tiny",
                                 allow_unsafe_pickle=True)


# ----------------------------------------------------------- FLOPs

def _configs():
    from scda_tpu import config as jcfg
    from scda_tpu_torch import config as tcfg

    ymls = sorted(glob.glob(os.path.join(REPO, "cfgs", "*.yml")))
    for preset in sorted(jcfg.PRESETS):
        for yml in [None] + ymls:
            j, t = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
            if yml:
                j = jcfg.config_from_yaml(yml, base=j)
                t = tcfg.config_from_yaml(yml, base=t)
            yield f"{preset}+{os.path.basename(yml) if yml else '-'}", j, t


def test_flops_equal_jax_for_every_config():
    from scda_tpu.utils import flops as jflops
    from scda_tpu_torch.utils import flops as tflops

    names = ("inference_flops_per_image", "train_flops_per_image",
             "scda_step_flops_per_src_image")
    seen = 0
    for label, j, t in _configs():
        assert dataclasses.asdict(j) == dataclasses.asdict(t), label
        for canvas in (tuple(j.data.image_size), (512, 1024)):
            for name in names:
                want = getattr(jflops, name)(j, canvas)
                assert getattr(tflops, name)(t, canvas) == want, (label, name)
                assert want > 0
                seen += 1
    assert seen >= 4 * 9 * 2 * 3
    for name in ("conv_flops", "dense_flops"):
        assert getattr(tflops, name)(7, 9, 3, 5, 3, 2) == \
            getattr(jflops, name)(7, 9, 3, 5, 3, 2) if name == "conv_flops" \
            else getattr(tflops, name)(7, 9, 3) == getattr(jflops, name)(7, 9, 3)


# ------------------------------------------------------------- CLIs

def test_draw_detections_bit_equal_to_jax():
    from scda_tpu.cli.demo import draw_detections as jax_draw
    from scda_tpu_torch.cli.demo import draw_detections

    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (90, 140, 3)).astype(np.uint8)
    boxes = rng.uniform(-10, 150, (12, 2))
    boxes = np.concatenate([boxes, boxes + rng.uniform(5, 60, (12, 2))], 1)
    scores = rng.uniform(0, 1, 12)
    classes = rng.randint(1, 10, 12)
    names = [f"class{i}" for i in range(9)]
    for thresh in (0.0, 0.5):
        np.testing.assert_array_equal(
            draw_detections(img, boxes, scores, classes, names, thresh),
            jax_draw(img, boxes, scores, classes, names, thresh))


TINY_SET = ["--set", "train.proposal.pre_nms_top_n=200",
            "train.proposal.post_nms_top_n=50",
            "train.rpn_target.batch_size=64", "train.roi_target.batch_size=32",
            "test.proposal.pre_nms_top_n=200",
            "test.proposal.post_nms_top_n=50", "anchors.scales=2,4,8"]


@pytest.fixture(scope="module")
def trained_tiny(tmp_path_factory):
    """One tiny train step's run directory (checkpoint and config.json)."""
    from scda_tpu_torch.cli import trainval

    save = str(tmp_path_factory.mktemp("surface") / "models")
    assert trainval.main([
        "--net", "tiny", "--device", "cpu", "--dataset", "synthetic",
        "--steps", "1", "--bs", "1", "--synth_images", "2",
        "--synth_size", "128", "192", "--save_dir", save] + TINY_SET) == 0
    return save


def test_demo_end_to_end(trained_tiny, tmp_path, capsys):
    """demo on two PNGs of the synthetic val fixture with the trained
    run's config.json: an overlay each, drawn from the detections that
    the eval step gives on the prepared canvas; those match JAX's
    forward on the same weights and canvas."""
    from PIL import Image

    from scda_tpu.config import _merge_into as jax_merge
    from scda_tpu.config import get_config as jax_get_config
    from scda_tpu.data.pipeline import prepare_image as jax_prepare
    from scda_tpu_torch.cli import demo
    from scda_tpu_torch.config import (
        _merge_into, get_config, replace_path as treplace,
    )
    from scda_tpu_torch.data.synthetic import make_synthetic_dataset
    from scda_tpu_torch.train import checkpoint as ckpt
    from scda_tpu_torch.train.steps import make_eval_step

    ds = make_synthetic_dataset(str(tmp_path / "val"), num_images=2,
                                image_size=(128, 192), seed=100, split="val")
    src = tmp_path / "images"
    src.mkdir()
    for rec in ds.records:
        Image.open(rec.image_path).save(src / f"{rec.image_id}.png")
    out = tmp_path / "out"
    rc = demo.main(["--image_dir", str(src), "--out_dir", str(out), "--net",
                    "tiny", "--device", "cpu", "--load_dir", trained_tiny,
                    "--thresh", "0.0", "--set",
                    "test.proposal.pre_nms_top_n=200",
                    "test.proposal.post_nms_top_n=50"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "architecture from" in printed and "loaded checkpoint step 1" in printed
    run_dir = os.path.join(trained_tiny, "tiny", "synthetic")
    with open(os.path.join(run_dir, "config.json")) as f:
        meta = json.load(f)
    cfg = _merge_into(get_config("vgg16"), {"model": meta["config"]["model"],
                                            "anchors": meta["config"]["anchors"]})
    cfg = treplace(cfg, "test.proposal.pre_nms_top_n", 200)
    cfg = treplace(cfg, "test.proposal.post_nms_top_n", 50)
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    model.load_state_dict(ckpt.load_payload(run_dir)["model"])
    step = make_eval_step(model, cfg)
    # The run's config computes in bf16; JAX is compared in f32.
    cfg32 = treplace(cfg, "model.compute_dtype", "float32")
    model32 = build_model(cfg32.model, cfg32.anchors.num_anchors)
    model32.load_state_dict(model.state_dict())
    step32 = make_eval_step(model32, cfg32)
    for rec in ds.records:
        path = out / f"{rec.image_id}_det.png"
        assert path.exists()
        img = np.asarray(Image.open(src / f"{rec.image_id}.png").convert("RGB"))
        bgr = np.ascontiguousarray(img[:, :, ::-1]).astype(np.float32)
        boxes, scores, classes = demo.detect(step, bgr, cfg, "cpu")
        assert len(scores) > 0
        drawn = demo.draw_detections(img, boxes, scores, classes,
                                     meta["classes"], 0.0)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), drawn)
        # JAX's forward on the same weights and JAX's host prep.
        jcfg = jax_merge(jax_get_config("vgg16"),
                         {"model": meta["config"]["model"],
                          "anchors": meta["config"]["anchors"]})
        jcfg = replace_path(jcfg, "test.proposal.pre_nms_top_n", 200)
        jcfg = replace_path(jcfg, "test.proposal.post_nms_top_n", 50)
        jcfg = replace_path(jcfg, "model.compute_dtype", "float32")
        canvas, scale, (vh, vw) = jax_prepare(bgr, jcfg.data)
        jm = jax_build_model(jcfg.model, num_anchors=jcfg.anchors.num_anchors)
        params = _jax_tree_from_port(model)
        ref = jax.jit(lambda p, x, i: jdet.forward_inference(
            jm, p, x, i, jcfg))(params, jnp.asarray(canvas[None]),
                                jnp.asarray([[vh, vw, scale]], jnp.float32))
        got = step32(torch.from_numpy(canvas[None]),
                     torch.tensor([[vh, vw, scale]], dtype=torch.float32))
        rate, _, n_jax = detection_match_rate(
            got, (ref.boxes, ref.scores, ref.classes, ref.valid))
        assert n_jax > 0 and rate >= 0.9, rate


def _jax_tree_from_port(model):
    """The tiny port model's weights as a JAX params tree (the inverse of
    ``bridge.state_dict_from_jax`` for ``tiny``)."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def conv(w, b):
        return {"kernel": np.transpose(w, (2, 3, 1, 0)), "bias": b}

    a = sd["RCNN_rpn.RPN_cls_score.weight"].shape[0] // 2
    perm = np.asarray([c * a + i for i in range(a) for c in range(2)])
    backbone = {f"conv{i}": conv(sd[f"RCNN_base.{t}.weight"],
                                 sd[f"RCNN_base.{t}.bias"])
                for i, t in enumerate((0, 3, 6, 9))}
    return {"backbone": backbone,
            "head": {"fc": {"kernel": sd["RCNN_top.0.weight"].T,
                            "bias": sd["RCNN_top.0.bias"]}},
            "rpn": {"conv": conv(sd["RCNN_rpn.RPN_Conv.weight"],
                                 sd["RCNN_rpn.RPN_Conv.bias"]),
                    "cls_score": conv(sd["RCNN_rpn.RPN_cls_score.weight"][perm],
                                      sd["RCNN_rpn.RPN_cls_score.bias"][perm]),
                    "bbox_pred": conv(sd["RCNN_rpn.RPN_bbox_pred.weight"],
                                      sd["RCNN_rpn.RPN_bbox_pred.bias"])},
            "cls_score": {"kernel": sd["RCNN_cls_score.weight"].T,
                          "bias": sd["RCNN_cls_score.bias"]},
            "bbox_pred": {"kernel": sd["RCNN_bbox_pred.weight"].T,
                          "bias": sd["RCNN_bbox_pred.bias"]}}


def _json_lines(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("{"):
            out.update(json.loads(line))
    return out


def test_test_net_new_flags_equal_jax_evaluators(trained_tiny, tmp_path,
                                                  monkeypatch, capsys):
    """test_net with --use_07_metric --iou_sweep --coco_protocol --vis
    --vis_count --vis_thresh --allow_unsafe_pickle: the detections are
    the fixture's boxes jittered (so that every number is non-trivial);
    each printed number equals the JAX evaluators' on those detections."""
    from scda_tpu.evals.coco_protocol import evaluate_coco_protocol
    from scda_tpu.evals.voc_eval import (
        evaluate_detections, evaluate_detections_iou_sweep,
    )
    from scda_tpu_torch.cli import test_net
    from scda_tpu_torch.evals import detect

    seen = {}

    def fake_inference(model, dataset, cfg, **kw):
        rng = np.random.RandomState(0)
        dets = {}
        for rec in dataset.records:
            for box, label in zip(rec.boxes, rec.labels):
                cls = dataset.classes[int(label) - 1]
                jitter = rng.uniform(-6, 6, 4)
                dets.setdefault(cls, []).append(
                    (rec.image_id, box + jitter, float(rng.uniform(0.3, 1))))
                grown = box + 3 * np.abs(jitter) * np.array([-1, -1, 1, 1])
                dets[cls].append((rec.image_id, grown,
                                  float(rng.uniform(0, 0.5))))
        seen["dataset"], seen["dets"] = dataset, dets
        return dets, 1.0

    monkeypatch.setattr(detect, "run_inference", fake_inference)
    vis = tmp_path / "vis"
    rc = test_net.main(["--net", "tiny", "--device", "cpu", "--synth_images",
                        "4", "--synth_size", "128", "192", "--load_dir",
                        trained_tiny, "--use_07_metric", "--iou_sweep",
                        "--coco_protocol", "--vis", str(vis), "--vis_count",
                        "3", "--vis_thresh", "0.4", "--allow_unsafe_pickle"]
                       + TINY_SET)
    assert rc == 0
    printed = _json_lines(capsys.readouterr().out)
    ds, dets = seen["dataset"], seen["dets"]
    want = {"eval": evaluate_detections(ds, dets, use_07_metric=True),
            "iou_sweep": evaluate_detections_iou_sweep(ds, dets),
            "coco": evaluate_coco_protocol(ds, dets)}
    assert 0 < want["eval"]["mAP"] < 1 and want["coco"]["AP"] > 0
    for section, values in want.items():
        for k, v in values.items():
            assert printed[section][k] == round(float(v), 4), (section, k)
    assert sorted(os.listdir(vis)) == [f"{r.image_id}_det.png"
                                       for r in ds.records[:3]]


def test_trainval_pretrained_tfb_unsafe_pickle(tmp_path):
    """``trainval --pretrained`` (ResNet-50, 64x96, one step) after the
    seeded init, with ``--use_tfb`` and ``--allow_unsafe_pickle``: the
    frozen layers (conv1, layer1) in the checkpoint are the file's."""
    from scda_tpu_torch.cli import trainval
    from scda_tpu_torch.train import checkpoint as ckpt

    sd = resnet50_file(seed=4)
    path = _save(sd, str(tmp_path / "r50.pth"))
    save = str(tmp_path / "models")
    rc = trainval.main([
        "--net", "res50", "--device", "cpu", "--dataset", "synthetic",
        "--steps", "1", "--bs", "1", "--synth_images", "2", "--synth_size",
        "64", "96", "--save_dir", save, "--pretrained", path, "--use_tfb",
        "--allow_unsafe_pickle", "--set", "train.proposal.pre_nms_top_n=100",
        "train.proposal.post_nms_top_n=20", "train.rpn_target.batch_size=32",
        "train.roi_target.batch_size=8", "anchors.scales=1,2"])
    assert rc == 0
    model = ckpt.load_payload(os.path.join(save, "res50", "synthetic"))["model"]
    np.testing.assert_array_equal(model["RCNN_base.0.weight"].numpy(),
                                  sd["conv1.weight"])
    np.testing.assert_array_equal(model["RCNN_base.4.2.bn3.running_var"].numpy(),
                                  sd["layer1.2.bn3.running_var"])
    assert not np.array_equal(model["RCNN_base.6.0.conv1.weight"].numpy(),
                              sd["layer3.0.conv1.weight"])   # trained

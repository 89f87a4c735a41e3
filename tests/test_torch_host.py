"""The port's host modules against the JAX package's originals, on the
CPU.  ``scda_tpu_torch`` keeps its own copies of ``config``, ``data``,
``native``, ``evals.voc_eval``, ``evals.coco_protocol`` and
``utils.logging`` so that it imports nothing of ``scda_tpu``; every test
here feeds one input to a copy and to its original and demands exact
equality (the code is the same, so there is no tolerance to state).
"""

import dataclasses
import glob
import io
import json
import os

import numpy as np
import pytest

from scda_tpu import config as jcfg
from scda_tpu import data as jdata  # noqa: F401  (fills the registry)
from scda_tpu import native as jnative
from scda_tpu.data import pipeline as jpipe
from scda_tpu.data import synthetic as jsynth
from scda_tpu.data import voc as jvoc
from scda_tpu.evals import coco_protocol as jcoco
from scda_tpu.evals import voc_eval as jeval
from scda_tpu.utils import logging as jlog
from scda_tpu_torch import config as tcfg
from scda_tpu_torch import data as tdata  # noqa: F401
from scda_tpu_torch import native as tnative
from scda_tpu_torch.data import pipeline as tpipe
from scda_tpu_torch.data import synthetic as tsynth
from scda_tpu_torch.data import voc as tvoc
from scda_tpu_torch.evals import coco_protocol as tcoco
from scda_tpu_torch.evals import voc_eval as teval
from scda_tpu_torch.utils import logging as tlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.basename(p)
               for p in glob.glob(os.path.join(REPO, "cfgs", "*.yml")))


def test_every_yaml_is_listed():
    assert len(YAMLS) >= 8


@pytest.mark.parametrize("name", YAMLS)
def test_config_from_yaml_equal(name):
    path = os.path.join(REPO, "cfgs", name)
    a = jcfg.config_from_yaml(path)
    b = tcfg.config_from_yaml(path)
    assert type(b).__module__ == "scda_tpu_torch.config"
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_presets_equal():
    assert sorted(jcfg.PRESETS) == sorted(tcfg.PRESETS)
    for name in jcfg.PRESETS:
        assert (dataclasses.asdict(jcfg.get_config(name))
                == dataclasses.asdict(tcfg.get_config(name)))


@pytest.mark.parametrize("tokens", [
    ["train.batch_size", "4", "model.backbone", "resnet101"],
    ["train.batch_size=4", "anchors.scales=2,4,8"],
    ["data.image_size=128,192", "test.nms_thresh", "0.25",
     "model.multiscale_roi=true"],
])
def test_parse_set_list_and_overrides_equal(tokens):
    a, b = jcfg.parse_set_list(tokens), tcfg.parse_set_list(tokens)
    assert a == b and a
    ca = jcfg.apply_overrides(jcfg.get_config("vgg16"), a)
    cb = tcfg.apply_overrides(tcfg.get_config("vgg16"), b)
    assert dataclasses.asdict(ca) == dataclasses.asdict(cb)
    assert dataclasses.asdict(ca) != dataclasses.asdict(jcfg.get_config("vgg16"))


def test_parse_set_list_dangling_key_raises_in_both():
    for mod in (jcfg, tcfg):
        with pytest.raises(SystemExit, match="missing value"):
            mod.parse_set_list(["train.batch_size"])


def test_replace_path_equal_and_unknown_field_raises():
    a = jcfg.replace_path(jcfg.get_config("res101"), "train.proposal.nms_thresh", "0.6")
    b = tcfg.replace_path(tcfg.get_config("res101"), "train.proposal.nms_thresh", "0.6")
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.train.proposal.nms_thresh == 0.6
    with pytest.raises(KeyError):
        tcfg.replace_path(b, "train.no_such_field", 1)


def _scene(mod, seed, fog=0.0):
    return mod._draw_scene(np.random.RandomState(seed), 200, 320,
                           max_objects=6, classes=mod.SYNTH_CLASSES, fog=fog)


def _numpy_only(monkeypatch, native):
    """Make ``native.available()`` false, as with ``SCDA_NATIVE=0``."""
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_lib", None)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("flip", [False, True])
def test_scene_and_prep_equal(path, flip, monkeypatch):
    """``_draw_scene`` + ``prepare_image`` + ``prepare_gt_boxes`` from one
    seed, through the C++ prep and through the numpy fallback."""
    if path == "numpy":
        _numpy_only(monkeypatch, jnative)
        _numpy_only(monkeypatch, tnative)
    elif not (jnative.available() and tnative.available()):
        pytest.fail("no C++ toolchain: the native prep did not build")
    assert jsynth.SYNTH_CLASSES == tsynth.SYNTH_CLASSES
    (rgb_a, boxes_a, labels_a) = _scene(jsynth, 5, fog=0.2)
    (rgb_b, boxes_b, labels_b) = _scene(tsynth, 5, fog=0.2)
    np.testing.assert_array_equal(rgb_a, rgb_b)
    np.testing.assert_array_equal(boxes_a, boxes_b)
    np.testing.assert_array_equal(labels_a, labels_b)

    ca = jcfg.DataConfig(scale=96, max_size=160, image_size=(96, 160),
                         max_gt_boxes=8)
    cb = tcfg.DataConfig(scale=96, max_size=160, image_size=(96, 160),
                         max_gt_boxes=8)
    bgr = np.ascontiguousarray(rgb_a[:, :, ::-1])
    for img in (bgr, bgr.astype(np.float32)):
        out_a, scale_a, hw_a = jpipe.prepare_image(img, ca, flip=flip)
        out_b, scale_b, hw_b = tpipe.prepare_image(img, cb, flip=flip)
        assert scale_a == scale_b and hw_a == hw_b
        assert out_a.dtype == out_b.dtype == np.float32
        np.testing.assert_array_equal(out_a, out_b)

    difficult = np.zeros(len(boxes_a), bool)
    difficult[-1] = True
    rec_a = jvoc.ImageRecord(image_id="0", image_path="", width=320,
                             height=200, boxes=boxes_a, labels=labels_a,
                             difficult=difficult)
    rec_b = tvoc.ImageRecord(image_id="0", image_path="", width=320,
                             height=200, boxes=boxes_b, labels=labels_b,
                             difficult=difficult)
    gt_a, n_a = jpipe.prepare_gt_boxes(rec_a, scale_a, ca, flip=flip)
    gt_b, n_b = tpipe.prepare_gt_boxes(rec_b, scale_b, cb, flip=flip)
    assert n_a == n_b == min(len(boxes_a) - 1, 8)
    np.testing.assert_array_equal(gt_a, gt_b)


def test_native_copy_builds_its_own_library():
    """The port's native module compiles its own ``prep.cc`` into its own
    directory; its IoU equals the original's."""
    assert tnative.available()
    assert os.path.dirname(tnative._lib_path()).endswith(
        os.path.join("scda_tpu_torch", "native"))
    rng = np.random.RandomState(0)
    a = rng.rand(17, 4).astype(np.float32) * 50
    b = rng.rand(9, 4).astype(np.float32) * 50
    a[:, 2:] += a[:, :2] + 1
    b[:, 2:] += b[:, :2] + 1
    np.testing.assert_array_equal(tnative.bbox_overlaps_native(a, b),
                                  jnative.bbox_overlaps_native(a, b))


def _seeded_detections(dataset, seed):
    """Per class a list of (image_id, box, score): each gt box jittered,
    plus false positives."""
    rng = np.random.RandomState(seed)
    dets = {c: [] for c in dataset.classes}
    for rec in dataset.records:
        for box, label in zip(rec.boxes, rec.labels):
            cls = dataset.classes[int(label) - 1]
            dets[cls].append((rec.image_id, box + rng.randn(4) * 3.0,
                              float(rng.rand())))
        for _ in range(3):
            xy = rng.rand(2) * 80
            cls = dataset.classes[rng.randint(len(dataset.classes))]
            dets[cls].append((rec.image_id,
                              np.concatenate([xy, xy + 20 + rng.rand(2) * 40]),
                              float(rng.rand())))
    return dets


def test_memory_dataset_loader_and_eval_equal(tmp_path):
    """The same seeded dataset through both loaders gives equal batches;
    seeded detections give equal AP under the VOC and the COCO protocol."""
    ds_a = jsynth.make_memory_dataset(num_images=5, image_size=(128, 192),
                                      tmpdir=str(tmp_path / "a"))
    ds_b = tsynth.make_memory_dataset(num_images=5, image_size=(128, 192),
                                      tmpdir=str(tmp_path / "b"))
    assert ds_a.classes == ds_b.classes
    assert len(ds_a.records) == len(ds_b.records) == 5
    for ra, rb in zip(ds_a.records, ds_b.records):
        np.testing.assert_array_equal(ra.boxes, rb.boxes)
        np.testing.assert_array_equal(ra.labels, rb.labels)

    ca = jcfg.DataConfig(scale=128, max_size=224, image_size=(128, 192),
                         max_gt_boxes=8)
    cb = tcfg.DataConfig(scale=128, max_size=224, image_size=(128, 192),
                         max_gt_boxes=8)
    la = jpipe.DataLoader(ds_a, ca, batch_size=2, shuffle=True, seed=4)
    lb = tpipe.DataLoader(ds_b, cb, batch_size=2, shuffle=True, seed=4)
    n = 0
    for ba, bb in zip(la, lb):
        for fa, fb in zip(dataclasses.astuple(ba), dataclasses.astuple(bb)):
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
        n += 1
    assert n >= 2

    dets = _seeded_detections(ds_a, seed=9)
    for metric07 in (False, True):
        ap_a = jeval.evaluate_detections(ds_a, dets, use_07_metric=metric07)
        ap_b = teval.evaluate_detections(ds_b, dets, use_07_metric=metric07)
        assert ap_a == ap_b
        assert 0.0 < ap_a["mAP"] < 1.0
    assert (jeval.evaluate_detections_iou_sweep(ds_a, dets)
            == teval.evaluate_detections_iou_sweep(ds_b, dets))
    assert (jcoco.evaluate_coco_protocol(ds_a, dets)
            == tcoco.evaluate_coco_protocol(ds_b, dets))


def test_dataset_registry_lists_the_same_names():
    names = tvoc.list_datasets()
    assert names == jvoc.list_datasets() and len(names) > 10
    assert tvoc._REGISTRY is not jvoc._REGISTRY
    assert jvoc.CITYSCAPES_CLASSES == tvoc.CITYSCAPES_CLASSES
    assert jvoc.PASCAL_VOC_CLASSES == tvoc.PASCAL_VOC_CLASSES
    with pytest.raises(KeyError):
        tvoc.get_dataset("no_such_dataset")


def test_compute_scale_and_canvas_equal():
    ca = jcfg.DataConfig()
    cb = tcfg.DataConfig()
    for h, w in ((1024, 2048), (375, 1242), (500, 333), (96, 96)):
        assert (jpipe.compute_scale(h, w, ca.scale, ca.max_size)
                == tpipe.compute_scale(h, w, cb.scale, cb.max_size))
        assert jpipe.oriented_canvas(ca, h, w) == tpipe.oriented_canvas(cb, h, w)


def test_metrics_logger_equal(tmp_path):
    lines = []
    for mod, name in ((jlog, "a"), (tlog, "b")):
        stream = io.StringIO()
        log_file = str(tmp_path / name / "metrics.jsonl")
        logger = mod.MetricsLogger(log_file=log_file, stream=stream)
        logger.log(3, {"loss": np.float32(1.5), "tag": "x"})
        logger.close()
        with open(log_file) as f:
            on_disk = f.read()
        assert on_disk == stream.getvalue()
        rec = json.loads(on_disk)["train"]
        rec.pop("wall_s")
        lines.append(rec)
    assert lines[0] == lines[1] == {"step": 3, "loss": 1.5, "tag": "x"}

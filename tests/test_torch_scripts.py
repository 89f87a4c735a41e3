"""The port's runbooks and tools (``scripts_torch/``) against the JAX
package's (``scripts/``), on the CPU.

Each ``scripts_torch/*.sh`` is its original with the CLI module names
switched to the port's and ``--device "${SCDA_TORCH_DEVICE:-cuda}"``
given to every CLI call; its comments speak of the port.
``convert_to_voc.py`` and ``loader_bench.py`` are their originals with
the imports switched (and a docstring of their own; the loader bench
also prints the host's CPU count).  Then what each tool does: the
converter's trees byte for byte, the reference-layout export tensor for
tensor and read back by the JAX package, the export end to end through
``test_net``, the KITTI geometry through ``cli.trainval``, the A/Bs'
arms, the loader bench, and ``chip_smoke.py``'s tables against the
scripts they stand for.
"""

import ast
import json
import os
import re
import runpy
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_numerics_state
from scda_tpu_torch import bridge
from scda_tpu_torch.train.torch_convert import (
    export_reference_detector, reference_payload,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNBOOKS = ["fidelity_foggy.sh", "fidelity_sim10k.sh", "scda_kitti_ab.sh",
            "scda_ab_demo.sh", "scda_car_ab.sh"]
DEVICE_FLAG = '--device "${SCDA_TORCH_DEVICE:-cuda}"'


@pytest.fixture(autouse=True)
def _kept_numerics():
    """The CLIs called in this process set the card numerics; put them
    back for the tests that follow in this worker."""
    with torch_numerics_state.kept():
        yield


@pytest.fixture
def one_thread():
    """One intra-op thread for the tests that run a ResNet on the CPU:
    beside the suite's other workers, eight threads a worker wait on
    each other at every small convolution."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def shell_commands(text):
    """A shell script's logical lines without comments and blank lines:
    continuations joined, runs of blanks collapsed."""
    text = re.sub(r"\\\n", " ", text)
    lines = (line.split(" #")[0].strip() for line in text.splitlines())
    return [" ".join(line.split()) for line in lines
            if line and not line.startswith("#")]


# ---- the scripts are their originals -------------------------------------

@pytest.mark.parametrize("name", RUNBOOKS)
def test_runbook_equals_its_original(name):
    port = shell_commands(_read("scripts_torch", name))
    calls = [line for line in port if "python -m" in line]
    assert calls and all("python -m scda_tpu_torch.cli." in c
                         and DEVICE_FLAG in c for c in calls), calls
    undone = [re.sub(r"scda_tpu_torch\.cli\.(\w+) " + re.escape(DEVICE_FLAG),
                     r"scda_tpu.cli.\1", line) for line in port]
    assert undone == shell_commands(_read("scripts", name))
    assert os.access(os.path.join(REPO, "scripts_torch", name), os.X_OK)


def _code_lines(text):
    """A Python file's lines after its module docstring."""
    end = ast.parse(text).body[0].end_lineno
    return text.splitlines()[end:]


@pytest.mark.parametrize("name,added", [
    ("convert_to_voc.py", []),
    ("loader_bench.py", ['    print(f"host: {os.cpu_count()} CPUs", '
                         'flush=True)'])])
def test_tool_equals_its_original_but_its_imports(name, added):
    port = _code_lines(_read("scripts_torch", name))
    assert all(line in port for line in added)
    port = [line.replace("from scda_tpu_torch.", "from scda_tpu.")
            for line in port if line not in added]
    assert port == _code_lines(_read("scripts", name))


# ---- convert_to_voc.py ----------------------------------------------------

def _raw_tree(tmp_path, dataset):
    from test_cityscapes_raw import _city_tree, _png

    if dataset != "kitti":
        return _city_tree(tmp_path, foggy=dataset == "foggy")
    root = os.path.join(str(tmp_path), "KITTI")
    labels = {"000000": "Car 0.0 0 1.5 10 5 60 35 1 1 1 0 0 0 0\n"
                        "Van 0.0 3 1.5 70 5 110 35 1 1 1 0 0 0 0\n",
              "000001": "Car 0.0 1 1.5 5 5 40 30 1 1 1 0 0 0 0\n"}
    for stem, label in labels.items():
        _png(os.path.join(root, "training", "image_2", f"{stem}.png"),
             120, 40)
        os.makedirs(os.path.join(root, "training", "label_2"), exist_ok=True)
        with open(os.path.join(root, "training", "label_2",
                               f"{stem}.txt"), "w") as f:
            f.write(label)
    return root


def _tree(root):
    """Every file of a tree: symlinks by target, files by bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                out[rel] = ("link", os.readlink(path))
            else:
                with open(path, "rb") as f:
                    out[rel] = ("file", f.read())
    return out


@pytest.mark.parametrize("dataset", ["cityscapes", "foggy", "kitti"])
def test_convert_to_voc_writes_the_jax_scripts_tree(tmp_path, monkeypatch,
                                                    dataset):
    raw = _raw_tree(tmp_path, dataset)
    trees = {}
    for pkg in ("scripts", "scripts_torch"):
        out = os.path.join(str(tmp_path), pkg)
        monkeypatch.setattr(sys, "argv", [
            "convert_to_voc.py", dataset, "--root", raw, "--out", out,
            "--splits", "training" if dataset == "kitti" else "train"])
        with pytest.raises(SystemExit) as done:
            runpy.run_path(os.path.join(REPO, pkg, "convert_to_voc.py"),
                           run_name="__main__")
        assert done.value.code == 0
        trees[pkg] = _tree(out)
    assert len(trees["scripts"]) >= 4
    assert trees["scripts_torch"] == trees["scripts"]


# ---- the reference-layout export ------------------------------------------

def _conv(rng, k, cin, cout, bias=True):
    p = {"kernel": rng.standard_normal((k, k, cin, cout), dtype=np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(cout, dtype=np.float32)
    return p


def _dense(rng, cin, cout):
    return {"kernel": rng.standard_normal((cin, cout), dtype=np.float32),
            "bias": rng.standard_normal(cout, dtype=np.float32)}


def _bn(rng, c):
    return {k: rng.standard_normal(c, dtype=np.float32)
            for k in ("scale", "bias", "mean", "var")}


def _block(rng, cin, f, down):
    p = {}
    for i, (k, a, b) in enumerate(((1, cin, f), (3, f, f), (1, f, 4 * f)), 1):
        p[f"conv{i}"] = _conv(rng, k, a, b, bias=False)
        p[f"bn{i}"] = _bn(rng, b)
    if down:
        p["downsample_conv"] = _conv(rng, 1, cin, 4 * f, bias=False)
        p["downsample_bn"] = _bn(rng, 4 * f)
    return p


def cut_params(backbone, seed=0, a=9, classes=3, multiscale=False):
    """A JAX params tree of ``backbone``'s layout at cut widths (the
    export relabels and transposes; it reads no width)."""
    from scda_tpu.models.backbones.resnet import RESNET_DEPTHS
    from scda_tpu.models.backbones.vgg import VGG16_LAYOUT

    rng = np.random.default_rng(seed)
    if backbone == "vgg16":
        convs, cin = {}, 3
        for item in VGG16_LAYOUT:
            if item != "M":
                convs[f"conv{item[0]}"] = _conv(rng, 3, cin, 2)
                cin = 2
        body = {"backbone": convs,
                "head": {"fc6": _dense(rng, 2 * 49, 6),
                         "fc7": _dense(rng, 6, 6)}}
        feat, hid = 2, 6
    elif backbone == "tiny":
        body = {"backbone": {f"conv{i}": _conv(rng, 3, 3 if i == 0 else 2, 2)
                             for i in range(4)},
                "head": {"fc": _dense(rng, 2 * 49, 6)}}
        feat, hid = 2, 6
    else:
        n = RESNET_DEPTHS[int(backbone[len("resnet"):])]
        stages, cin = {}, 2
        for li, (blocks, f) in enumerate(zip(n[:3], (1, 2, 3)), 1):
            stages[f"layer{li}"] = {f"block{b}": _block(
                rng, cin if b == 0 else 4 * f, f, b == 0)
                for b in range(blocks)}
            cin = 4 * f
        body = {"backbone": {"conv1": _conv(rng, 7, 3, 2, bias=False),
                             "bn1": _bn(rng, 2), **stages},
                "head": {"layer4": {f"block{b}": _block(
                    rng, 12 if b == 0 else 16, 4, b == 0)
                    for b in range(n[3])}}}
        feat, hid = 12, 16
    rpn = {"conv": _conv(rng, 3, feat, 5),
           "cls_score": _conv(rng, 1, 5, 2 * a),
           "bbox_pred": _conv(rng, 1, 5, 4 * a)}
    extra = {"c3_proj": _conv(rng, 1, 8, feat)} if multiscale else {}
    return {**body, "rpn": rpn, "cls_score": _dense(rng, hid, classes),
            "bbox_pred": _dense(rng, hid, 4 * classes), **extra}


def _port_state(params, backbone):
    return {k: torch.from_numpy(v)
            for k, v in bridge.state_dict_from_jax(params, backbone).items()}


@pytest.mark.parametrize("backbone,multiscale", [
    ("vgg16", False), ("resnet50", False), ("resnet50", True)])
def test_export_equals_the_jax_exporter(backbone, multiscale):
    """On the same params carried across by the bridge: the same keys
    (``c3_proj`` left out by both) and exactly the same f32 values."""
    from scda_tpu.train.torch_convert import (
        export_reference_detector as jax_export,
    )

    params = cut_params(backbone, multiscale=multiscale)
    got = export_reference_detector(_port_state(params, backbone), backbone)
    want = jax_export(params, backbone, num_anchors=9)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_export_refuses_tiny_as_the_jax_exporter_does():
    from scda_tpu.train.torch_convert import (
        export_reference_detector as jax_export,
    )

    params = cut_params("tiny")
    with pytest.raises(ValueError, match="no reference exporter"):
        jax_export(params, "tiny")
    with pytest.raises(ValueError, match="no reference exporter"):
        export_reference_detector(_port_state(params, "tiny"), "tiny")


@pytest.mark.parametrize("backbone", ["vgg16", "resnet50"])
def test_jax_package_reads_the_export_back(tmp_path, backbone):
    """The port's ``.pth``, read by the JAX package's
    ``load_reference_checkpoint`` into a zeroed tree, gives back every
    parameter exactly."""
    import jax

    from scda_tpu.config import ModelConfig
    from scda_tpu.train.torch_convert import load_reference_checkpoint

    params = cut_params(backbone)
    mc = ModelConfig(backbone=backbone, pooling_mode="align_legacy")
    payload = reference_payload(_port_state(params, backbone), mc, step=7)
    assert {k: payload[k] for k in ("session", "epoch", "step",
                                    "pooling_mode", "class_agnostic")} == {
        "session": 1, "epoch": 0, "step": 7,
        "pooling_mode": "align_legacy", "class_agnostic": False}
    path = str(tmp_path / "export.pth")
    torch.save(payload, path)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    back = load_reference_checkpoint(zeros, path, backbone)
    flat = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(flat)
    for key, v in flat:
        np.testing.assert_array_equal(np.asarray(got[key]), v,
                                      err_msg=str(key))


# Every CLI call below: ResNet-50 on the CPU at 64x96, f32, with small
# proposal budgets (the export takes vgg16 and the ResNets only).
CUT = ["--set", "model.compute_dtype", "float32",
       "train.proposal.pre_nms_top_n", "128",
       "train.proposal.post_nms_top_n", "32",
       "train.rpn_target.batch_size", "32",
       "train.roi_target.batch_size", "16",
       "adapt.mining_top_n", "16", "adapt.num_groups", "4",
       "test.proposal.pre_nms_top_n", "128", "test.proposal.post_nms_top_n",
       "32", "data.max_gt_boxes", "8", "anchors.scales", "1 2 4"]
SYNTH = ["--dataset", "synthetic", "--synth_size", "64", "96",
         "--synth_images", "2", "--device", "cpu", "--net", "res50"]


def _quiet(main, argv):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc == 0, out.getvalue()[-2000:]
    return out.getvalue()


@pytest.mark.parametrize("adapt", [False, True])
def test_export_script_end_to_end(tmp_path, monkeypatch, adapt, one_thread):
    """A port checkpoint (source-only, or SCDA with its discriminator)
    through ``scripts_torch/export_torch.py``: ``test_net
    --torch_checkpoint`` on the file gives the detections of ``test_net
    --load_dir`` on the run."""
    import importlib

    from scda_tpu_torch.cli import test_net, trainval

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    export = importlib.import_module("scripts_torch.export_torch")
    run = str(tmp_path / "run")
    _quiet(trainval.main, [*SYNTH, "--steps", "1", "--save_dir", run,
                           *(["--adapt", "--synth_fog", "0.4"] if adapt
                             else []), *CUT])
    meta = json.loads(_read(run, "res50", "synthetic", "config.json"))
    assert meta["state_kind"] == ("scda" if adapt else "det")
    pth = str(tmp_path / "export.pth")
    text = _quiet(export.main, ["--load_dir", run, "--net", "res50",
                                "--dataset", "synthetic", "--out", pth])
    assert "exported step-1 " + ("SCDA " if adapt else "") in text
    payload = torch.load(pth, weights_only=True)
    assert payload["step"] == 1 and payload["pooling_mode"] == "align"
    assert not any(k.startswith(("discriminator", "RCNN_c3_proj"))
                   for k in payload["model"])
    dets = {}
    for source in (["--torch_checkpoint", pth], ["--load_dir", run]):
        out = str(tmp_path / f"dets{len(dets)}.json")
        _quiet(test_net.main, [*SYNTH, *source, "--dets_out", out, *CUT])
        dets[source[0]] = json.loads(_read(out))
    assert sum(len(v) for v in dets["--load_dir"].values()) > 0
    assert dets["--torch_checkpoint"] == dets["--load_dir"]


# ---- the KITTI geometry, the A/Bs, the loader bench ------------------------

def test_kitti_protocol_cfg_smoke(tmp_path, monkeypatch):
    """The counterpart of the JAX package's ``test_kitti_protocol_cfg_smoke``
    (``tests/test_io.py``) through the port's ``cli.trainval``:
    ``cfgs/scda_kitti_car.yml`` (car-only, class-agnostic, alternating
    D/G) with 48x96 source scenes on a 64x96 canvas, 2 steps."""
    from scda_tpu_torch.cli import trainval

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    text = _quiet(trainval.main, [
        "--cfg_file", os.path.join(REPO, "cfgs", "scda_kitti_car.yml"),
        "--dataset", "synthetic", "--net", "tiny", "--device", "cpu",
        "--synth_size", "64", "96", "--synth_src_size", "48", "96",
        "--synth_images", "4", "--synth_classes", "car",
        "--synth_fog", "0.3", "--num_devices", "1",
        "--bs", "1", "--steps", "2", "--disp_interval", "1",
        "--save_dir", str(tmp_path),
        "--set", "model.backbone", "tiny", "model.rpn_channels", "64",
        "model.class_agnostic", "True",
        "train.proposal.pre_nms_top_n", "64",
        "train.proposal.post_nms_top_n", "16",
        "train.rpn_target.batch_size", "32", "train.roi_target.batch_size",
        "16", "adapt.mining_top_n", "16", "adapt.num_groups", "4",
        "data.max_gt_boxes", "4", "anchors.scales", "1 2 4"])
    assert "adapt=True" in text
    run = os.path.join(str(tmp_path), "tiny", "synthetic")
    cfg = json.loads(_read(run, "config.json"))["config"]
    assert cfg["adapt"]["d_update"] == "alternating"
    assert cfg["model"]["class_agnostic"] and cfg["model"]["num_classes"] == 2
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line)["train"] for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["d_loss"]) and np.isfinite(r["loss"])
               for r in rows)


def test_init_from_restores_every_tensor(tmp_path, monkeypatch):
    """``cli.trainval --init_from`` leaves out the init: the restore sets
    every tensor of the detector, so a run from a model whose tensors
    hold anything at all ends bit-equal to one from a fresh init."""
    from scda_tpu_torch.cli import trainval
    from scda_tpu_torch.models import faster_rcnn
    from scda_tpu_torch.train.checkpoint import load_payload

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    common = ["--net", "tiny", "--device", "cpu", "--dataset", "synthetic",
              "--synth_size", "64", "96", "--synth_images", "2", "--steps",
              "1", "--set", "model.rpn_channels", "64",
              "train.proposal.pre_nms_top_n", "64",
              "train.proposal.post_nms_top_n", "16",
              "train.rpn_target.batch_size", "32",
              "train.roi_target.batch_size", "16", "anchors.scales", "1 2 4"]
    _quiet(trainval.main, [*common, "--save_dir", str(tmp_path / "src")])
    src = str(tmp_path / "src" / "tiny" / "synthetic")
    runs = []
    for fill in (None, 7.0):
        if fill is not None:
            real = faster_rcnn.empty_model

            def filled(*args, _real=real, **kwargs):
                model = _real(*args, **kwargs)
                for t in [*model.parameters(), *model.buffers()]:
                    t.data.fill_(fill)
                return model
            monkeypatch.setattr(faster_rcnn, "empty_model", filled)
            monkeypatch.setattr(faster_rcnn, "init_params", None)  # unused
        out = str(tmp_path / f"arm{len(runs)}")
        _quiet(trainval.main, [*common, "--init_from", src, "--save_dir", out,
                               "--lr", "0.0005"])
        runs.append(load_payload(os.path.join(out, "tiny", "synthetic")))
    assert runs[0]["model"].keys() == runs[1]["model"].keys()
    for k, v in runs[0]["model"].items():
        assert torch.equal(v, runs[1]["model"][k]), k


@pytest.mark.parametrize("name,backbone", [("inference_bs1", "tiny"),
                                           ("res101_ms", "resnet50"),
                                           ("train_bs1", "resnet50")])
def test_bench_weights_need_no_init_of_their_own(name, backbone,
                                                 one_thread):
    """``bench_torch.seeded_weights`` seeds an empty model: its init sets
    every tensor (the ResNets' frozen BatchNorm buffers too), so the
    weights are those of a built (initialised) model seeded the same
    way, and ``model_from`` loads them whole."""
    import bench_torch
    from scda_tpu_torch.models.faster_rcnn import build_model, init_weights

    cfg = _cut_serving(bench_torch.config_for(name), backbone)
    got = bench_torch.seeded_weights(cfg, he_heads=name.startswith("inf"))
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    init_weights(model, torch.Generator().manual_seed(bench_torch.WEIGHT_SEED),
                 input_scale=1.0 / 64, he_heads=name.startswith("inf"))
    want = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    loaded = bench_torch.model_from(cfg, got, "cpu").state_dict()
    assert all(torch.equal(loaded[k], want[k]) for k in want)


def test_plain_twins_swaps_one_site_and_restores_it():
    from scda_tpu_torch.models.backbones import resnet, vgg
    from scda_tpu_torch.ops import nms, roi_ops
    from scda_tpu_torch.ops.kernels import bottleneck_kernel, plain_twins

    sites = {(vgg, "vgg_stem_fused"), (roi_ops, "roi_align_contract"),
             (resnet, "bottleneck_chain"), (nms, "nms_sorted")}
    before = {s: getattr(*s) for s in sites}
    with plain_twins("bottleneck_chain"):
        assert (resnet.bottleneck_chain
                is bottleneck_kernel.bottleneck_chain_plain)
        assert all(getattr(*s) is before[s] for s in sites
                   if s[1] != "bottleneck_chain")
    assert {s: getattr(*s) for s in sites} == before
    with plain_twins():
        assert all(getattr(*s) is not before[s] for s in sites)
    assert {s: getattr(*s) for s in sites} == before
    with pytest.raises(ValueError, match="no call site"):
        with plain_twins("bottleneck"):
            pass


def _cut_serving(cfg, backbone="resnet50"):
    """A serving config cut for the CPU: 64x96, small proposal budgets,
    f32 (bf16 convolutions are slow on the CPU)."""
    from scda_tpu_torch.config import replace_path

    for key, value in {"data.image_size": (64, 96),
                       "model.backbone": backbone,
                       "model.compute_dtype": "float32",
                       "test.bf16_weights": False,
                       "test.proposal.pre_nms_top_n": 128,
                       "test.proposal.post_nms_top_n": 32,
                       "anchors.scales": (1, 2, 4)}.items():
        cfg = replace_path(cfg, key, value)
    return cfg


def test_ab_scripts_on_cut_configs(monkeypatch, capsys, one_thread):
    """Both A/Bs through ``bench_torch.serving_ab`` on the CPU (plain
    twins only; ResNet-50 multiscale at 64x96, one unit a window): three
    arms each, the f32 detections of the arms equal, K4's stage 1 on a
    cut chain within its bound of the twin."""
    import importlib

    import bench_torch

    monkeypatch.setattr(bench_torch, "SERVING_INPUTS", 1)
    bab = importlib.import_module("scripts_torch.bottleneck_ab")
    mab = importlib.import_module("scripts_torch.ms_proj_ab")
    one = bab.stage1("cpu", shape=(1, 4, 6, 16, 2), repeats=1)
    assert one["max_rel_err"] <= bab.MAX_REL_ERR
    for out, arms in ((bab.stage2("cpu", 1, 1, cfg_hook=_cut_serving),
                       ["on", "off", "on"]),
                      (mab.run(1, "cpu", 1, 1, cfg_hook=_cut_serving),
                       [f"ms_proj_after_pool={f}" for f in
                        (False, True, False)])):
        assert out["arms"] == arms and out["bf16_dets_valid_finite"]
        assert all(g["f32_match_rate"] == 1.0 for g in out["agreement"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert sum("arm" in line for line in lines) == 6


@pytest.mark.parametrize("script", ["bottleneck_ab.py", "ms_proj_ab.py"])
def test_ab_script_without_a_card_exits_2(script, monkeypatch, capsys):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"scripts_torch.{script[:-3]}")
    assert mod.main(["--device", "cuda"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_loader_bench_runs_small(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts_torch",
                                      "loader_bench.py"),
         "--images", "4", "--size", "64", "96", "--epochs", "2"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0] == f"host: {os.cpu_count()} CPUs"
    rows = [line for line in lines if "ep0:" in line]
    assert len(rows) == 2 and all("ep1:" in line for line in rows)
    assert rows[0].startswith("RAM u8 cache") and rows[1].startswith("disk")
    assert lines[-1].startswith("store:")


# ---- chip_smoke.py's tables are the scripts' ------------------------------

def _flags(argv):
    """Flag -> values of one argv, as argparse reads it: a flag given
    twice keeps its last values."""
    out, key = {}, None
    for tok in argv:
        if tok.startswith("--"):
            key = tok
            out[key] = []
        else:
            out[key].append(tok)
    return out


def _script_calls(name, **shell_vars):
    """(module, argv) of each CLI call in a ``scripts_torch`` runbook,
    its arrays and variables expanded."""
    text = _read("scripts_torch", name)
    arrays = {m.group(1): shlex.split(m.group(2)) for m in re.finditer(
        r"^ *(\w+)=\(([^)]*)\)", text, re.M)}
    calls = []
    for line in shell_commands(text):
        m = re.search(r"python -m scda_tpu_torch\.cli\.(\w+) (.*)", line)
        if not m:
            continue
        rest = m.group(2)
        for arr, vals in arrays.items():
            rest = rest.replace(f'"${{{arr}[@]}}"', " ".join(
                shlex.quote(v) for v in vals))
        for var, val in shell_vars.items():
            rest = rest.replace(f"${var}", val)
        calls.append((m.group(1), shlex.split(rest)))
    return calls


# What chip_smoke.py sets by design: paths, device, logging,
# checkpointing and the arms' seeds 3-5; its evaluations take 32 scenes
# at each of AB_FOGS.
IGNORED = {"--device", "--save_dir", "--init_from", "--checkpoint_interval",
           "--disp_interval", "--seed"}
IGNORED_EVAL = IGNORED | {"--load_dir", "--synth_images", "--synth_fog"}


@pytest.mark.parametrize("proto", ["learning_ab", "car"])
def test_protocols_table_holds_the_scripts_flags(proto):
    """``chip_smoke.py``'s ``PROTOCOLS``: every flag each stage of the
    script passes (source, control, SCDA arm, evaluation), but those it
    sets by design (``IGNORED``)."""
    import chip_smoke as cs

    p = cs.PROTOCOLS[proto]
    assert p["script"].replace("scripts/", "scripts_torch/") in (
        f"scripts_torch/{n}" for n in RUNBOOKS)
    calls = _script_calls(os.path.basename(p["script"]))
    source, control, scda = (_flags(argv) for mod, argv in calls[:3])
    head = ["--set", *p["set"]] if p["set"] else []
    scda_head = ["--set", *p["set"], *p["scda_set"]] if (
        p["set"] or p["scda_set"]) else []
    want = {"source": _flags(["--net", cs.AB_NET, *cs.AB_COMMON, *p["train"],
                              *cs.AB_SOURCE, *head]),
            "control": _flags(["--net", cs.AB_NET, *cs.AB_COMMON,
                               *p["train"], *cs.AB_ARM, *head]),
            "scda": _flags(["--net", cs.AB_NET, *cs.AB_COMMON, *p["train"],
                            *cs.AB_ARM, *cs.AB_SCDA, *scda_head])}
    for stage, got in (("source", source), ("control", control),
                       ("scda", scda)):
        assert ({k: v for k, v in got.items() if k not in IGNORED}
                == {k: v for k, v in want[stage].items()
                    if k not in IGNORED}), stage
    evals = [(mod, _flags(argv)) for mod, argv in calls[3:]]
    assert [mod for mod, _ in evals] == ["test_net"]
    want_eval = _flags(["--dataset", "synthetic", "--net", cs.AB_NET,
                        *p["eval"]])
    assert {k: v for k, v in evals[0][1].items()
            if k not in IGNORED_EVAL} == want_eval
    assert "for fog in " + " ".join(cs.AB_FOGS) in _read(
        "scripts_torch", os.path.basename(p["script"]))


def test_kitti_and_fidelity_tables_hold_the_scripts_flags():
    import chip_smoke as cs

    calls = _script_calls("scda_kitti_ab.sh", OUT="out")
    assert [m for m, _ in calls] == ["trainval"] * 3 + ["test_net"]
    common = _flags(cs.KITTI_COMMON)
    source, _, scda = (_flags(argv) for _, argv in calls[:3])
    for k, v in common.items():
        assert source[k] == v, k
    assert _flags([*cs.KITTI_COMMON, *cs.KITTI_SCDA]) == {
        k: v for k, v in scda.items()
        if k not in ("--steps", "--lr", "--init_from", "--save_dir",
                     "--checkpoint_interval", "--device")}
    assert source["--steps"] == ["400"] and scda["--steps"] == ["150"]
    assert len(cs.KITTI_EVALS) == 4   # two arms x two fogs, in the loop
    assert "for arm in ctrl scda" in _read("scripts_torch", "scda_kitti_ab.sh")

    text = _read("scripts_torch", "fidelity_foggy.sh")
    smoke = text.split('if [ "$SMOKE" = "1" ]; then')[1].split("else")[0]
    arrays = {m.group(1): shlex.split(m.group(2)) for m in re.finditer(
        r"(\w+)=\(([^)]*)\)", smoke)}
    want = _flags(["--net", "vgg16", "--bs", "1", *arrays["NDEV"],
                   *arrays["SRC"], *arrays["PRETRAIN"], *arrays["SMALL"]])
    assert _flags(cs.FIDELITY_SMOKE) == want


@pytest.mark.slow
@pytest.mark.parametrize("script", ["fidelity_foggy.sh", "fidelity_sim10k.sh"])
def test_fidelity_runbook_smoke(tmp_path, script):
    """The runbooks end to end on the CPU at fixture scale with the real
    flag paths: caffe-layout ``.pth`` -> source pretrain -> SCDA adapt ->
    eval (``SCDA_FIDELITY_SMOKE=1``, ``SCDA_TORCH_DEVICE=cpu``)."""
    from scda_tpu_torch.models.backbones.vgg import VGG16_LAYOUT

    sd, in_ch = {}, 3
    g = torch.Generator().manual_seed(0)
    for item in VGG16_LAYOUT:
        if item == "M":
            continue
        idx, ch = item
        sd[f"features.{idx}.weight"] = torch.randn(
            ch, in_ch, 3, 3, generator=g) * (2.0 / (9 * in_ch)) ** 0.5
        sd[f"features.{idx}.bias"] = torch.zeros(ch)
        in_ch = ch
    pth = str(tmp_path / "vgg16_caffe.pth")
    torch.save(sd, pth)
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp_path),
               SCDA_FIDELITY_SMOKE="1", SCDA_TORCH_DEVICE="cpu")
    r = subprocess.run(
        ["bash", os.path.join(REPO, "scripts_torch", script), pth,
         str(tmp_path / "out")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=1500)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "loaded pretrained backbone" in r.stdout
    assert "mAP@0.5" in r.stdout
    assert "device=cpu" in r.stdout

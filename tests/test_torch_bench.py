"""``bench_torch.py``, the port's bench, against ``bench.py``, on the CPU.

The inputs, configs, metric names, baselines and FLOP counts of each of
the eleven configs must be ``bench.py``'s (exact equality: the same code
on the same numbers).  Each runner also runs here on ``tiny`` at 64x96
with ``device="cpu"`` (the kernels' twins; one window of one unit) and
must return a whole record; a runner that raises is recorded as an error
and the run exits non-zero; ``main()`` without a card measures nothing.
Timing on the card is ``bench_torch.py``'s own job.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch
from scda_tpu import config as jcfg
from scda_tpu.data import synthetic as jsynth
from scda_tpu_torch.config import replace_path
from scda_tpu_torch.data import synthetic as tsynth
from scda_tpu_torch.ops import kernels
from scda_tpu_torch.ops.kernels import nms_kernel
from scda_tpu_torch.utils import profile

from test_torch_slice import NO_JAX_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = list(bench.CONFIG_RUNNERS)

# The structured-batch calls of bench.py's runners (``bench_inference``
# :166, ``bench_train`` :207, ``_bench_scda`` :267-270): (inputs, batch
# size, seed, fog, classes).
SERVE, TRAIN = (8, 1, 0.0, None), (4, 2, 0.0, None)
EXPECTED_BATCHES = {
    "inference_bs1": [(1, SERVE)], "inference_bs8": [(8, SERVE)],
    "res101_ms": [(1, SERVE)], "res101_bs8": [(8, SERVE)],
    "train_bs1": [(1, TRAIN)], "train_bs8": [(8, TRAIN)],
    "train_bs16": [(16, TRAIN)],
    **{name: [(bs, (4, 3, 0.0, cls)), (bs, (4, 4, 0.4, cls))]
       for name, bs, cls in (("scda_bs1", 1, None), ("scda_bs8", 8, None),
                             ("scda_car", 1, ("car",)),
                             ("scda_car_bs8", 8, ("car",)))},
}
BATCH_CALLS = sorted({(bs, *call) for calls in EXPECTED_BATCHES.values()
                      for bs, call in calls}, key=str)

# ``tiny`` at 64x96 (tests/helpers.py's sizes, cut canvas).
TINY = {"model.backbone": "tiny", "model.rpn_channels": 64,
        "data.image_size": (64, 96), "data.scale": 64, "data.max_size": 96,
        "data.max_gt_boxes": 8, "anchors.scales": (2.0, 4.0, 8.0),
        "train.proposal.pre_nms_top_n": 256,
        "train.proposal.post_nms_top_n": 64, "train.proposal.min_size": 4.0,
        "train.rpn_target.batch_size": 64, "train.roi_target.batch_size": 32,
        "test.proposal.pre_nms_top_n": 128, "test.proposal.post_nms_top_n": 32,
        "test.proposal.min_size": 4.0, "test.max_dets_per_class": 8,
        "test.max_per_image": 16, "adapt.num_groups": 4,
        "adapt.mining_top_n": 32, "adapt.kmeans_iters": 4}
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "spread", "n",
               "samples", "batch_size", "iters", "weights_dtype",
               "gflops_per_img", "mfu", "setup_s", "peak_mem_gb", "card",
               "check", "profile", "wall_s"}
CPU = {"name": "cpu", "power_limit": None}


def tiny(cfg):
    for key, value in TINY.items():
        cfg = replace_path(cfg, key, value)
    return cfg


@pytest.fixture
def small_scenes(monkeypatch):
    """Both packages draw their fixture scenes at 96x192 instead of
    1024x2048 (the same draws on each side, ~100x cheaper)."""
    for module in (jsynth, tsynth):
        real = module._draw_scene
        monkeypatch.setattr(module, "_draw_scene",
                            lambda rng, h, w, _r=real, **kw: _r(rng, 96, 192,
                                                                **kw))


def jax_config(name):
    """The config bench.py builds for ``name`` (``_serving_cfg`` :135,
    ``bench_train`` :195-199, ``_bench_scda`` :245-256)."""
    kw = {"res101_ms": {"preset": "res101", "multiscale_roi": True},
          "res101_bs8": {"preset": "res101", "multiscale_roi": True}}
    if name.startswith(("inference", "res101")):
        return bench._serving_cfg(**kw.get(name, {}))
    bs = int(name.rsplit("_bs", 1)[1]) if "_bs" in name else 1
    cfg = jcfg.get_config("vgg16")
    cfg = jcfg.replace_path(cfg, "data.image_size", (512, 1024))
    if name.startswith("scda"):
        cfg = jcfg.replace_path(cfg, "adapt.enabled", True)
    cfg = jcfg.replace_path(cfg, "train.batch_size", bs)
    if name.startswith("scda_car"):
        cfg = jcfg.replace_path(cfg, "model.num_classes", 2)
        cfg = jcfg.replace_path(cfg, "model.class_agnostic", True)
        cfg = jcfg.replace_path(cfg, "adapt.d_update", "alternating")
    return cfg


def test_same_configs_in_the_same_order():
    assert list(bench_torch.SPECS) == NAMES
    assert bench_torch.HEADLINE == bench.HEADLINE
    assert bench_torch.HEADLINE_METRIC == bench.HEADLINE_METRIC


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_bench_py(name):
    assert (dataclasses.asdict(bench_torch.config_for(name))
            == dataclasses.asdict(jax_config(name)))


@pytest.mark.parametrize("name", NAMES)
def test_metric_baseline_and_flops_equal_bench_py(name):
    assert bench_torch.METRIC_NAMES[name] == bench.METRIC_NAMES[name]
    assert (bench_torch.BASELINES_IMG_PER_SEC[name]
            == bench.BASELINES_IMG_PER_SEC[name])
    assert bench_torch.flops_per_image(name) == bench._flops_per_image(name)


@pytest.mark.parametrize("bs,n,seed,fog,classes", BATCH_CALLS)
def test_structured_batches_bit_equal(small_scenes, bs, n, seed, fog,
                                      classes):
    """Every (inputs, batch size, seed, fog, classes) a runner asks for,
    on a cut canvas."""
    cfg = replace_path(bench_torch.config_for("train_bs1"),
                       "data.image_size", (64, 128))
    jcfg_ = jcfg.replace_path(jax_config("train_bs1"), "data.image_size",
                              (64, 128))
    got = bench_torch.structured_batches(cfg, n, bs, seed=seed, fog=fog,
                                         classes=classes)
    want = bench._structured_batches(jcfg_, n, bs, seed=seed, fog=fog,
                                     classes=classes)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_structured_batches_bit_equal_at_full_scene_size():
    """The 1024x2048 scenes themselves (fogged, car only: the SCDA target
    stream) on a cut canvas."""
    cfg = replace_path(bench_torch.config_for("scda_car"), "data.image_size",
                       (64, 128))
    jcfg_ = jcfg.replace_path(jax_config("scda_car"), "data.image_size",
                              (64, 128))
    got = bench_torch.structured_batches(cfg, 1, 2, seed=4, fog=0.4,
                                         classes=("car",))
    want = bench._structured_batches(jcfg_, 1, 2, seed=4, fog=0.4,
                                     classes=("car",))
    for x, y in zip(got[0], want[0]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert got[0][3].sum() > 0


@pytest.mark.parametrize("name", NAMES)
def test_workload_asks_for_bench_py_inputs(small_scenes, monkeypatch, name):
    calls = []
    real = bench_torch.structured_batches

    def spy(cfg, n, bs, seed=0, fog=0.0, classes=None):
        calls.append((bs, (n, seed, fog, classes)))
        return real(cfg, n, bs, seed=seed, fog=fog, classes=classes)

    monkeypatch.setattr(bench_torch, "structured_batches", spy)
    bench_torch.workload(name, "cpu", tiny(bench_torch.config_for(name)))
    assert calls == EXPECTED_BATCHES[name]


@pytest.mark.parametrize("name", NAMES)
def test_runner_on_tiny_returns_a_whole_record(small_scenes, capsys, name):
    table, rc = bench_torch.run([name], "cpu", CPU, cfg_hook=tiny, iters=1,
                                repeats=1)
    assert rc == 0
    rec = table[name]
    assert set(rec) == RECORD_KEYS, set(rec) ^ RECORD_KEYS
    assert rec["metric"] == bench.METRIC_NAMES[name] and rec["n"] == 1
    assert rec["batch_size"] == bench_torch.SPECS[name].batch_size
    # Nothing measured on the CPU is written under a device metric.
    assert rec["mfu"] is None and rec["peak_mem_gb"] is None
    assert rec["profile"] is None and rec["card"] == CPU
    check = rec["check"]["f32_kernels_vs_twins"]
    assert check.get("match_rate", 1.0) == 1.0 and check.get("max_rel", 0) == 0
    props = check.get("proposals_vs_twins", [])
    kind = bench_torch.SPECS[name].kind
    assert len(props) == {"serve": 0, "train": 1, "scda": 2}[kind]
    assert all(p["kept"] > 0 and p["mismatched_slots"] == 0 for p in props)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == rec and name in lines[-1]["configs"]


def test_a_runner_that_raises_is_an_error_not_a_zero(small_scenes, capsys,
                                                     monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no such kernel")

    monkeypatch.setitem(bench_torch.WORKLOADS, "train", broken)
    table, rc = bench_torch.run(["inference_bs1", "train_bs1"], "cpu", CPU,
                                cfg_hook=tiny, iters=1, repeats=1)
    assert rc == 3
    assert "value" not in table["train_bs1"]
    assert "no such kernel" in table["train_bs1"]["error"]
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["errors"] == ["train_bs1"]
    assert last["metric"] == bench.HEADLINE_METRIC and "value" in last


@pytest.mark.parametrize("name", ["train_bs1", "scda_bs1"])
def test_step_check_holds_proposals_to_the_twins(small_scenes, monkeypatch,
                                                 name):
    """A twin NMS that keeps other boxes than the path's fails the step
    check, though the losses are compared on the path's proposals."""
    real = kernels.call_sites

    def drop_first(*args, **kwargs):
        keep = nms_kernel.nms_sorted_plain(*args, **kwargs).clone()
        keep[..., 0] = False
        return keep

    monkeypatch.setattr(kernels, "call_sites", lambda: tuple(
        (m, n, drop_first if n == "nms_sorted" else t) for m, n, t in real()))
    w = bench_torch.workload(name, "cpu", tiny(bench_torch.config_for(name)))
    with pytest.raises(RuntimeError, match="proposals with the kernels"):
        w.check(w.unit(0))


def test_main_without_a_card_measures_nothing(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(["--configs", "inference_bs1"]) == 2
    out, err = capsys.readouterr()
    assert "value" not in out and "is_available() is False" in err


def test_bench_torch_imports_no_jax(tmp_path):
    """Importing the bench and running its ``main`` loads nothing of JAX or
    the JAX package. The card is hidden from the subprocess, so ``main``
    takes its no-card exit on every machine and measures nothing."""
    code = ("import sys\n"
            "import bench_torch\n"
            "assert bench_torch.main([]) == 2\n"
            + NO_JAX_CODE)
    env = {k: v for k, v in os.environ.items() if k != "SCDA_PLATFORM"}
    env["TMPDIR"] = str(tmp_path)
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_plain_twins_swaps_every_call_site_and_restores():
    sites = kernels.call_sites()
    before = [getattr(m, n) for m, n, _ in sites]
    with kernels.plain_twins():
        assert all(getattr(m, n) is twin for m, n, twin in sites)
    assert [getattr(m, n) for m, n, _ in sites] == before


def test_profile_summary_per_unit():
    """The profiler rows of two units: kinds, the port's kernels by name,
    the busy share against the unprofiled wall time; the profiler's step
    annotation is no kernel."""
    rows = [("ProfilerStep*", 1, 9.0),
            ("void nms_mask_kernel<1>(float4 const*)", 2, 0.2),
            ("nms_scan_kernel(unsigned long const*)", 2, 0.1),
            ("roi_align_contract_bwd_kernel(float const*)", 2, 0.3),
            ("roi_align_contract_kernel(float const*)", 2, 0.1),
            ("sm90_xmma_gemm_bf16", 4, 1.0),
            ("at::native::vectorized_elementwise_kernel", 10, 0.3)]
    s = profile.summarize(rows, 2, 2.0)
    assert s["device_ms_per_unit"] == pytest.approx(1.0)
    assert s["kernels_per_unit"] == 11
    assert s["device_busy_share"] == pytest.approx(0.5)
    assert s["share_by_kind"] == pytest.approx(
        {"library conv/gemm": 0.5, "K2 roi_align": 0.2, "K1 nms": 0.15,
         "elementwise": 0.15})
    assert s["port_kernels"] == {
        "K1 nms_mask": {"launches_per_unit": 1, "ms_per_unit": 0.1},
        "K1 nms_scan": {"launches_per_unit": 1, "ms_per_unit": 0.05},
        "K2 roi_align": {"launches_per_unit": 1, "ms_per_unit": 0.05},
        "K2 roi_align_bwd": {"launches_per_unit": 1,
                             "ms_per_unit": pytest.approx(0.15)}}
    assert s["top_kernels"][0]["name"] == "sm90_xmma_gemm_bf16"
    assert "error" in profile.summarize(rows[:1], 2, 2.0)

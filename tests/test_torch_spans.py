"""The program's spans (``scda_tpu_torch/utils/profile.py``) on the CPU,
at the tiny backbone's size, and one check on the card.

Without a profiler no span opens a range; under one, each path's spans
are in the trace with their documented nesting and ids, and what the
program computes is the same bit for bit.  ``scda.adapt.bwd`` holds every
autograd node that only the adversarial loss reaches and no node of the
detection loss.  The readers of a pass's events (``span_times``,
``span_syncs``) read a fixed event list, on which the benchmark's
``read_trace`` gives what it gave before the program had spans.
``_build.first_use`` and the benchmark's ``kernel_load_s`` reader; the
training CLI's ``scda.data.*`` spans and ``data_wait_frac``.  Marked
``gpu``: the program's K4 spans measure what the benchmark's ranges
around the same calls measure.

This file imports no JAX.
"""

import contextlib
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile as torch_profile

from scda_tpu_torch import config as C
from scda_tpu_torch.adapt import scda
from scda_tpu_torch.models import detector as det
from scda_tpu_torch.models.faster_rcnn import build_model
from scda_tpu_torch.ops.kernels import _build, bottleneck_kernel as bk
from scda_tpu_torch.train.state import create_train_state
from scda_tpu_torch.train.steps import make_train_step
from scda_tpu_torch.utils import profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("train", "scda", "serve")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cfg(d_update: str = "joint") -> C.Config:
    """The tiny backbone on a 128x192 canvas, f32."""
    return C.Config(
        model=C.ModelConfig(backbone="tiny", num_classes=5,
                            compute_dtype="float32", rpn_channels=64),
        train=C.TrainConfig(
            batch_size=1,
            proposal=C.ProposalConfig(pre_nms_top_n=256, post_nms_top_n=64,
                                      nms_thresh=0.7, min_size=4.0),
            rpn_target=C.RPNTargetConfig(batch_size=64),
            roi_target=C.ROITargetConfig(batch_size=32)),
        test=C.TestConfig(
            proposal=C.ProposalConfig(pre_nms_top_n=128, post_nms_top_n=32,
                                      nms_thresh=0.7, min_size=4.0),
            max_dets_per_class=8, max_per_image=16),
        data=C.DataConfig(scale=128, max_size=224, image_size=(128, 192),
                          max_gt_boxes=8),
        adapt=C.AdaptConfig(enabled=True, num_groups=4, mining_top_n=32,
                            kmeans_iters=4, d_update=d_update),
        anchors=C.AnchorConfig(scales=(2.0, 4.0, 8.0)))


def batch(seed: int = 0):
    rng = np.random.RandomState(seed)
    image = torch.from_numpy(rng.randn(1, 128, 192, 3).astype(np.float32))
    info = torch.tensor([[128.0, 192.0, 1.0]])
    gt = torch.zeros(1, 8, 5)
    gt[0, 0] = torch.tensor([10.0, 10.0, 60.0, 70.0, 1.0])
    gt[0, 1] = torch.tensor([80.0, 40.0, 150.0, 120.0, 2.0])
    return image, info, gt, torch.tensor([2])


def make_path(name: str, d_update: str = "joint"):
    """(run() -> the path's outputs, the state it updates) of a fresh
    tiny model: one train step, SCDA step or served batch."""
    cfg = tiny_cfg(d_update)
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    image, info, gt, num = batch()
    if name == "serve":
        return (lambda: det.forward_inference(model, image, info, cfg)), model
    state = create_train_state(cfg, model)
    if name == "train":
        step = make_train_step(model, cfg)
        return (lambda: step(state, image, info, gt, num)[1]), state
    d_model = scda.init_discriminator(cfg, torch.Generator().manual_seed(1))
    state = scda.create_scda_state(cfg, state, d_model)
    step = scda.make_scda_train_step(model, d_model, cfg)
    return (lambda: step(state, image, info, gt, num, 0.5 * image, info)[1],
            state)


def traced(run):
    """``run()`` under a CPU profiler that records the spans' ids: (its
    output, the profiler's events)."""
    with torch_profile(activities=[ProfilerActivity.CPU],
                       record_shapes=True) as prof:
        out = run()
    return out, list(prof.events())


def spans(events):
    """The spans' host ranges."""
    return [e for e in events if e.name.startswith(profile.SPAN_PREFIX)]


def _iv(e):
    return e.time_range.start, e.time_range.end


def _inside(child, parent) -> bool:
    return (child.thread == parent.thread and _iv(parent)[0] <= _iv(child)[0]
            and _iv(child)[1] <= _iv(parent)[1])


# ---- no profiler, no range --------------------------------------------------

def test_a_span_without_a_profiler_is_one_shared_null_context():
    assert profile.span("train_step", step=1) is profile.span("k4")
    assert isinstance(profile.span("serve"), contextlib.nullcontext)
    assert profile.span_ids(call=3) is None


@pytest.mark.parametrize("name", PATHS)
def test_no_range_opens_without_a_profiler(name, monkeypatch):
    opened = []

    def counting(cls):
        class Counting(cls):
            def __init__(self, *args, **kwargs):
                opened.append(args[0] if args else None)
                super().__init__(*args, **kwargs)
        return Counting

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        torch.profiler.record_function)
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        def fast_counting(*args, **kwargs):
            opened.append(args[0] if args else None)
            return fast(*args, **kwargs)
        monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                            fast_counting)
    run, _ = make_path(name)
    run()
    assert opened == []
    # The same patches see the spans while a profiler records.
    _, events = traced(run)
    assert opened and spans(events)


# ---- under a profiler -------------------------------------------------------

COMMON = {"scda.backbone", "scda.rpn", "scda.propose", "scda.roi",
          "scda.head"}
EXPECTED = {
    "train": COMMON | {"scda.train_step", "scda.targets",
                       "scda.targets.anchor", "scda.targets.roi",
                       "scda.backward", "scda.optimizer"},
    "scda": COMMON | {"scda.scda_step", "scda.targets", "scda.targets.anchor",
                      "scda.targets.roi", "scda.adapt", "scda.adapt.target",
                      "scda.adapt.mine", "scda.adapt.patches",
                      "scda.adapt.disc", "scda.adapt.bwd", "scda.backward",
                      "scda.optimizer"},
    "serve": COMMON | {"scda.serve", "scda.postprocess"},
}
TOP = {"train": "scda.train_step", "scda": "scda.scda_step",
       "serve": "scda.serve"}
# Each span's parents in the documented nesting (one of them holds it);
# on the CPU autograd runs the backward on the calling thread.
PARENTS = {
    "scda.targets.anchor": ("scda.targets",),
    "scda.targets.roi": ("scda.targets",),
    "scda.adapt.target": ("scda.adapt",),
    "scda.adapt.mine": ("scda.adapt",),
    "scda.adapt.patches": ("scda.adapt",),
    "scda.adapt.disc": ("scda.adapt",),
    "scda.adapt.bwd": ("scda.backward",),
    "scda.propose": ("scda.train_step", "scda.scda_step", "scda.serve"),
}


@pytest.mark.parametrize("name", PATHS)
def test_the_trace_holds_every_span_of_the_path_nested(name):
    run, _ = make_path(name)
    run()
    _, events = traced(run)
    found = spans(events)
    assert {e.name for e in found} == EXPECTED[name]
    tops = [e for e in found if e.name == TOP[name]]
    assert len(tops) == 1
    for e in found:
        assert _inside(e, tops[0]), e.name
        parents = PARENTS.get(e.name)
        if parents:
            assert any(_inside(e, p) for p in found if p.name in parents), e.name
    if name == "scda":
        target = [e for e in found if e.name == "scda.adapt.target"]
        assert any(_inside(p, target[0]) for p in found
                   if p.name == "scda.propose")


@pytest.mark.parametrize("name", PATHS)
def test_every_span_of_a_unit_carries_its_id(name):
    run, state = make_path(name)
    run()
    _, events = traced(run)
    key = "req" if name == "serve" else "step"
    ids = {e.kwinputs.get(key) for e in spans(events)}
    assert len(ids) == 1 and None not in ids
    if key == "step":
        assert ids == {state.step - 1}
    _, again = traced(run)
    assert {e.kwinputs.get(key) for e in spans(again)} == {ids.pop() + 1}


@pytest.mark.parametrize("name", ["train", "scda"])
def test_the_optimizer_span_holds_every_update(name):
    """One ``scda.optimizer`` a step, and inside it (the CPU's eager
    chain) one in-place update of each trainable tensor, the
    discriminator's too, and no other."""
    run, state = make_path(name)
    run()
    _, events = traced(run)
    (opt,) = [e for e in spans(events) if e.name == "scda.optimizer"]
    tx = getattr(state, "det", state).tx
    plain = len(state.d_momentum) if name == "scda" else 0
    adds = [e for e in events if e.name == "aten::add_"]
    assert len([e for e in adds if _inside(e, opt)]) == len(tx.names) + plain


@pytest.mark.parametrize("d_update", ["joint", "alternating"])
def test_adapt_backward_holds_the_adversarial_nodes_alone(d_update):
    """Every autograd node run inside ``scda.adapt.bwd`` was created after
    every node run after it in the same backward: the span holds the
    nodes only the adversarial loss reaches, and no detection-loss node."""
    run, _ = make_path("scda", d_update)
    run()
    _, events = traced(run)
    (bwd,), (span,) = ([e for e in spans(events) if e.name == n]
                       for n in ("scda.backward", "scda.adapt.bwd"))
    nodes = [e for e in events
             if e.name.startswith("autograd::engine::evaluate_function")
             and e.sequence_nr >= 0 and _inside(e, bwd)]
    inside = [e.sequence_nr for e in nodes if _inside(e, span)]
    after = [e.sequence_nr for e in nodes if _iv(e)[0] > _iv(span)[1]]
    before = [e for e in nodes if _iv(e)[1] < _iv(span)[0]]
    assert inside and after
    assert min(inside) > max(after)
    # Before it only the nodes that join the two losses (the total's).
    assert len(before) <= 3


def test_k4_backward_carries_the_ids_of_its_call():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 4, 6, 32).astype(np.float32))
    ws = [torch.from_numpy(a.astype(np.float32)).requires_grad_() for a in (
        rng.randn(2, 32, 16) * 0.1, rng.randn(2, 1, 16) * 0.1,
        rng.randn(2, 9, 16, 16) * 0.1, rng.randn(2, 1, 16) * 0.1,
        rng.randn(2, 16, 32) * 0.1, rng.randn(2, 1, 32) * 0.1)]

    def run():
        with profile.span("train_step", step=5):
            y = bk.bottleneck_chain(x, *ws, dtype=torch.float32)
            z = bk.bottleneck_chain(y, *ws, dtype=torch.float32)
            with profile.span("backward"):
                torch.autograd.grad(z.sum(), ws)

    _, events = traced(run)
    fwd = [e for e in events if e.name == "scda.k4"]
    bwd = [e for e in events if e.name == "scda.k4.bwd"]
    assert len(fwd) == len(bwd) == 2
    calls = [e.kwinputs["call"] for e in fwd]
    assert calls[1] == calls[0] + 1
    for e in fwd + bwd:
        assert e.kwinputs["step"] == 5 and e.kwinputs["stage"] == 16
    assert sorted(e.kwinputs["call"] for e in bwd) == sorted(calls)


@pytest.mark.parametrize("name", PATHS)
def test_the_profiler_changes_no_bit(name):
    plain_run, plain_state = make_path(name)
    traced_run, traced_state = make_path(name)
    for k in range(2):
        a = plain_run()
        b, events = traced(traced_run)
        assert spans(events)
        for u, v in zip(a.values() if isinstance(a, dict) else a,
                        b.values() if isinstance(b, dict) else b):
            assert torch.equal(u, v)
    if name == "serve":
        return
    for (n, u), (_, v) in zip(plain_state.model.state_dict().items(),
                              traced_state.model.state_dict().items()):
        assert torch.equal(u, v), n
    det_a = getattr(plain_state, "det", plain_state)
    det_b = getattr(traced_state, "det", traced_state)
    for n, m in det_a.momentum.items():
        assert torch.equal(m, det_b.momentum[n]), n


def test_the_harness_call_sites_are_still_looked_up_by_name(monkeypatch):
    """The benchmark swaps ``models.detector.propose`` and
    ``.postprocess``, ``adapt.scda.propose`` and
    ``models.backbones.resnet.bottleneck_chain``: each call goes through
    the module attribute at call time."""
    from scda_tpu_torch.models.backbones import resnet

    seen = []
    for mod, attr in ((det, "propose"), (det, "postprocess"),
                      (scda, "propose"), (resnet, "bottleneck_chain")):
        orig = getattr(mod, attr)

        def wrapped(*args, _orig=orig, _name=f"{mod.__name__}.{attr}",
                    **kwargs):
            seen.append(_name)
            return _orig(*args, **kwargs)
        monkeypatch.setattr(mod, attr, wrapped)
    make_path("serve")[0]()
    make_path("scda")[0]()
    stage = resnet.ResNetStage(64, 16, 2, 1, torch.float32)
    stage(torch.randn(1, 64, 4, 6))
    assert seen.count("scda_tpu_torch.models.detector.propose") == 2
    assert seen.count("scda_tpu_torch.models.detector.postprocess") == 1
    assert seen.count("scda_tpu_torch.adapt.scda.propose") == 1
    assert seen.count("scda_tpu_torch.models.backbones.resnet.bottleneck_chain") == 1


def fpn_path(name: str):
    """``make_path`` for a ResNet-50-FPN at 64x128, f32: one train step or
    served batch of two images."""
    cfg = C.get_config("res101_fpn")
    for key, value in (
            ("model.backbone", "resnet50_fpn"),
            ("model.compute_dtype", "float32"),
            ("data.image_size", (64, 128)), ("data.max_gt_boxes", 8),
            ("train.proposal.pre_nms_top_n", 64),
            ("train.proposal.post_nms_top_n", 32),
            ("train.roi_target.batch_size", 16),
            ("train.rpn_target.batch_size", 32),
            ("test.proposal.pre_nms_top_n", 32),
            ("test.proposal.post_nms_top_n", 16),
            ("test.max_dets_per_class", 4), ("test.max_per_image", 8)):
        cfg = C.replace_path(cfg, key, value)
    torch.manual_seed(0)
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    rng = np.random.RandomState(2)
    image = torch.from_numpy(rng.randn(2, 64, 128, 3).astype(np.float32))
    info = torch.tensor([[64.0, 128.0, 1.0], [48.0, 100.0, 1.0]])
    gt = torch.zeros(2, 8, 5)
    gt[:, 0] = torch.tensor([4.0, 6.0, 40.0, 50.0, 1.0])
    gt[:, 1] = torch.tensor([50.0, 2.0, 90.0, 30.0, 2.0])
    num = torch.tensor([2, 2])
    if name == "serve":
        return (lambda: det.forward_inference(model, image, info, cfg)), model
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    return (lambda: step(state, image, info, gt, num)[1]), state


@pytest.mark.parametrize("name", ["train", "serve"])
def test_fpn_spans_open_only_under_a_profiler_and_carry_their_ids(
        name, monkeypatch):
    """The FPN path's spans: none opens without a profiler; under one,
    ``scda.fpn``, one
    ``scda.rpn.level`` a pyramid level inside ``scda.rpn``, one
    ``scda.propose`` a level's proposal call and one around the collect
    that holds ``scda.propose.collect``, and one ``scda.roi.level`` a
    pooled level inside ``scda.roi``, whose ``rois`` ids count every
    roi once."""
    from scda_tpu_torch.models import fpn

    run, state = fpn_path(name)
    fast = torch._C._profiler._RecordFunctionFast
    opened = []

    def fast_counting(*args, **kwargs):
        opened.append(args[0])
        return fast(*args, **kwargs)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        fast_counting)
    run()
    assert opened == []
    _, events = traced(run)
    found = spans(events)
    by = lambda n: [e for e in found if e.name == n]
    (fpn_span,), (rpn,), (roi,) = by("scda.fpn"), by("scda.rpn"), by("scda.roi")
    rpn_levels = by("scda.rpn.level")
    assert [e.kwinputs["level"] for e in rpn_levels] == list(fpn.RPN_LEVELS)
    assert all(_inside(e, rpn) for e in rpn_levels)
    proposes, (collect,) = by("scda.propose"), by("scda.propose.collect")
    assert len(proposes) == len(fpn.RPN_LEVELS) + 1
    assert sum(_inside(collect, p) for p in proposes) == 1
    assert not any(_inside(p, rpn) for p in proposes)
    roi_levels = by("scda.roi.level")
    assert [e.kwinputs["level"] for e in roi_levels] == list(fpn.ROI_LEVELS)
    assert all(_inside(e, roi) for e in roi_levels)
    assert sum(e.kwinputs["rois"] for e in roi_levels) == 2 * 16
    key = "req" if name == "serve" else "step"
    ids = {e.kwinputs.get(key) for e in found}
    assert len(ids) == 1 and None not in ids
    if key == "step":
        assert ids == {state.step - 1}
    assert fpn_span.kwinputs[key] == ids.pop()


# ---- reading a pass's events --------------------------------------------------

CPU = SimpleNamespace(name="CPU")
CUDA = SimpleNamespace(name="CUDA")


def ev(name, start, end, device=CPU, thread=1, annotation=False, cid=0):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation, id=cid)


def fixed_events(with_spans: bool):
    """One traced unit: host operations and runtime calls on thread 1 (and
    a backward thread 2), their kernels and copies on the device (linked
    by correlation ids), ``bench.*`` ranges, and with ``with_spans`` the
    program's ``scda.*`` ranges."""
    out = [
        ev("bench.unit", 0, 1000, annotation=True),
        ev("aten::conv2d", 10, 60),
        ev("cudaLaunchKernel", 20, 25, cid=1),
        ev("bench.propose", 100, 300, annotation=True),
        ev("aten::sort", 110, 150),
        ev("cudaLaunchKernel", 120, 125, cid=2),
        ev("cudaStreamSynchronize", 160, 200),
        ev("cudaMemcpyAsync", 210, 230, cid=3),
        ev("cudaMemcpyAsync", 400, 410, cid=4),
        ev("cudaLaunchKernel", 416, 418, thread=2, cid=5),
        ev("cudaStreamSynchronize", 420, 430, thread=2),
        # device
        ev("conv_kernel", 30, 90, CUDA, cid=1),
        ev("sort_kernel", 130, 170, CUDA, cid=2),
        ev("Memcpy DtoH (Device -> Pageable)", 215, 228, CUDA, cid=3),
        ev("Memcpy HtoD (Pageable -> Device)", 405, 409, CUDA, cid=4),
        ev("k4_kernel", 600, 700, CUDA, cid=5),
        ev("bench.propose", 125, 230, CUDA, annotation=True),
        ev("ProfilerStep#1", 0, 1000, CUDA, annotation=True),
    ]
    if with_spans:
        out += [
            ev("scda.serve", 5, 900),
            ev("scda.backbone", 8, 70),
            ev("scda.propose", 105, 290),
            ev("scda.k4.bwd", 415, 440, thread=2),
        ]
    return out


def test_spans_leave_the_benchmark_trace_reading_as_it_was():
    """``read_trace`` on a unit with and without the program's spans: the
    same kernels, busy time, ranges and device operations; the idle gaps
    sum the same, and a gap where the host was in Python inside a span is
    put down to the span."""
    from benchmark.metrics import profile as bench

    a = bench.read_trace(fixed_events(False), 0.002, 1, 2.0)
    b = bench.read_trace(fixed_events(True), 0.002, 1, 2.0)
    for key in ("summary", "busy_s", "window_s", "range_ms", "device_ops"):
        assert a[key] == b[key], key
    assert a["summary"]["kernels_per_unit"] == 5
    assert a["range_ms"] == {"bench.propose": pytest.approx(0.053)}
    ga, gb = dict(a["idle_gaps"]), dict(b["idle_gaps"])
    assert sum(ga.values()) == pytest.approx(sum(gb.values()))
    assert ga.pop("bench.unit") == gb.pop("bench.unit/scda.serve") == \
        pytest.approx(40e-6)
    assert ga == gb == {
        "bench.propose/cudaStreamSynchronize": pytest.approx(45e-6),
        "bench.propose/cudaMemcpyAsync": pytest.approx(177e-6),
        "bench.unit/cudaMemcpyAsync": pytest.approx(191e-6)}


def test_span_times_read_the_work_launched_inside_each_span():
    t = profile.span_times(fixed_events(True))
    assert t == {"scda.serve": pytest.approx((60 + 40 + 13 + 4 + 100) / 1e3),
                 "scda.backbone": pytest.approx(60 / 1e3),
                 "scda.propose": pytest.approx((40 + 13) / 1e3),
                 "scda.k4.bwd": pytest.approx(100 / 1e3)}
    assert profile.span_times(fixed_events(False)) == {}


def test_span_syncs_count_blocking_calls_on_the_span_thread():
    events = fixed_events(True)
    assert sorted(e.name for e in profile.blocking_calls(events)) == [
        "cudaMemcpyAsync", "cudaStreamSynchronize", "cudaStreamSynchronize"]
    # The H2D copy does not block; thread 2's sync counts in its own span.
    assert profile.span_syncs(events) == {"scda.serve": 2, "scda.backbone": 0,
                                          "scda.propose": 2, "scda.k4.bwd": 1}
    assert profile.span_syncs(fixed_events(False)) == {}


# ---- set-up: the kernel library's first use -----------------------------------

def test_first_use_records_the_load_and_whether_nvcc_ran(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then touch "$2"; fi\n'
                    '  shift\ndone\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "lib_path",
                        lambda: str(tmp_path / "build" / "libk.so"))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "first_use", {"load_s": None, "built": False})
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or SimpleNamespace(
                            scda_cuda_error_string=SimpleNamespace()))
    lib = _build.lib()
    assert loaded == [str(tmp_path / "build" / "libk.so")]
    assert _build.first_use["built"] is True
    assert _build.first_use["load_s"] > 0
    first = _build.first_use["load_s"]
    assert _build.lib() is lib and _build.first_use["load_s"] == first
    # A second process finds the library built.
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "first_use", {"load_s": None, "built": False})
    _build.lib()
    assert _build.first_use["built"] is False
    assert _build.first_use["load_s"] is not None


def test_kernel_load_reader_finds_nothing_where_no_library_loaded(monkeypatch):
    from benchmark.harness.spec import reader

    read = reader("kernel_load_s")
    run = SimpleNamespace(kind="serve", trace={})
    monkeypatch.setattr(_build, "first_use", {"load_s": None, "built": False})
    assert read(run) is None
    monkeypatch.setattr(_build, "first_use", {"load_s": 0.25, "built": False})
    assert read(run) == 0.25
    # A program without the counter (before it had one).
    monkeypatch.delattr(_build, "first_use")
    assert read(run) is None


# ---- the training CLI -----------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Two CPU steps of ``cli.trainval`` under a profiler: (logged lines,
    the profiler's events)."""
    import torch_numerics_state
    from scda_tpu_torch.cli import trainval

    save = str(tmp_path_factory.mktemp("cli") / "models")
    with torch_numerics_state.kept(), \
            torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        rc = trainval.main([
            "--net", "tiny", "--device", "cpu", "--dataset", "synthetic",
            "--steps", "2", "--bs", "1", "--synth_images", "2",
            "--synth_size", "128", "192", "--save_dir", save,
            "--disp_interval", "1", "--set",
            "train.proposal.pre_nms_top_n=200",
            "train.proposal.post_nms_top_n=50",
            "train.rpn_target.batch_size=64",
            "train.roi_target.batch_size=32", "anchors.scales=2,4,8"])
    assert rc == 0
    with open(os.path.join(save, "tiny", "synthetic", "metrics.jsonl")) as f:
        lines = [json.loads(s)["train"] for s in f]
    return lines, list(prof.events())


def test_cli_logs_the_share_spent_waiting_on_the_loader(cli_run):
    lines, _ = cli_run
    assert [m["step"] for m in lines] == [1, 2]
    for m in lines:
        assert 0.0 <= m["data_wait_frac"] <= 1.0


def test_cli_fetches_and_copies_each_batch_inside_its_spans(cli_run):
    _, events = cli_run
    found = spans(events)
    waits = [e for e in found if e.name == "scda.data.wait"]
    copies = [e for e in found if e.name == "scda.data.h2d"]
    steps = [e for e in found if e.name == "scda.train_step"]
    assert len(steps) == 2 and len(copies) == 2
    # The loop fetches once more before it sees the last step is done.
    assert len(waits) == 3
    for c, s in zip(copies, steps):
        assert _iv(c)[1] <= _iv(s)[0]


# ---- on the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("workload,span,rng", [
    ("res101_ms-train-bs1", "scda.k4.bwd", "bench.chain_bwd"),
    ("res101_ms-serve-bs8", "scda.k4", "bench.chain"),
])
def test_the_k4_spans_measure_what_the_benchmark_ranges_measure(
        workload, span, rng):
    """In one traced pass of the benchmark's cell, the device ms under the
    program's K4 span is within 2% of that under the harness's range
    around the same calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scda_tpu_torch.utils.numerics import set_card_numerics

    sys.path.insert(0, os.path.join(REPO, "scripts_torch"))
    try:
        import span_report
    finally:
        sys.path.remove(os.path.join(REPO, "scripts_torch"))
    set_card_numerics()
    r = span_report.report(workload, 4000000007, 2.0, torch.device("cuda", 0))
    mine, theirs = r["span_ms_per_unit"][span], r["range_ms_per_unit"][rng]
    assert theirs > 0
    assert abs(mine - theirs) <= 0.02 * theirs, (mine, theirs)
    torch.cuda.empty_cache()

"""The benchmark on the CPU: its files load, each cell runs end to end at
the program's ``tiny`` size and prints its result line, the yardstick's
frozen copies equal their originals, the output check fails what it
must fail, and a configuration that names a reference and a CPU cut of
its own is added as data alone."""

from __future__ import annotations

import filecmp
import json
import math
import os
import re
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import control, drive, judge, spec
from benchmark.harness.spec import Cell, kind_runner, reader
from benchmark.metrics import flops, roofline
from benchmark.metrics import profile as prof
from benchmark.tests.tiny import BENCH, ROOT, TINY_LIMITS, tiny_config, tiny_root
from benchmark.traffic import scenes

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCHMARK = json.load(_f)
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, seed=7, trace=False, faults=None):
    return drive.run_cell(cell, seed, 0.2, trace, torch.device("cpu"),
                          time.perf_counter(), faults=faults)


# ---- the files -------------------------------------------------------------

def test_benchmark_json_keeps_to_its_limits():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and not c["reduced"]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files(name):
    cell = Cell(name)
    assert callable(kind_runner(cell.kind))
    assert cell.limits, f"no limits file for {name}"
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = cell.per_layer()
    assert layers
    for m in layers:
        assert callable(reader(m["name"]))


def test_every_metric_and_mix_file_is_named_in_the_benchmark():
    metrics = {m["name"] for m in BENCHMARK["per_layer"]}
    readers = {f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics"))
               if f.endswith(".py") and f[:-3] not in
               ("__init__", "flops", "profile", "roofline")}
    assert readers == metrics
    mixes = {f[:-5] for f in os.listdir(os.path.join(BENCH, "traffic"))
             if f.endswith(".json")}
    assert mixes == {w["traffic"] for w in BENCHMARK["workloads"]}


# ---- runs on the CPU -------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_prints_its_result_line(root, name, trace):
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    cell = Cell("tiny_" + name, root)
    line = json.loads(run.result_line(_run(cell, trace=trace)))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    for c in line["checks"].values():
        assert not c.get("compared", True) or c["value"] <= c["limit"]
    if not trace:
        want = {m["name"] for m in cell.end_to_end()}
        assert set(line["metrics"]) == want
        for m in line["metrics"].values():
            assert m["value"] > 0
    else:
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer()}
        assert {"busy_s", "window_s"} <= set(line["device"])


def _changed_files(root):
    """Files of the repository's benchmark that the checkout at ``root``
    holds changed."""
    def changed(d):
        return d.diff_files + [x for sub in d.subdirs.values() for x in changed(sub)]

    return changed(filecmp.dircmp(BENCH, os.path.join(root, "benchmark"),
                                  ignore=["__pycache__"]))


def test_cells_added_as_data_leave_the_harness_untouched(root):
    """``tiny_root`` adds configurations, mixes, limits and cells as new
    files and entries; every file of the benchmark it copied is the
    repository's, and the new cells run (the test above)."""
    assert _changed_files(root) == []
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    assert {"tiny_" + c for c in CELLS} <= {w["name"] for w in bench["workloads"]}


def test_kinds_are_found_by_name_and_an_unknown_kind_is_refused(root):
    """A kind that needs code of its own is a new file under
    ``harness/kinds/``, found from the cell's checkout; a mistyped kind
    raises instead of falling through to another driver."""
    path = os.path.join(root, "benchmark", "harness", "kinds", "echo_kind.py")
    with open(path, "w") as f:
        f.write("def run(*args):\n    return {'echo': len(args)}\n")
    try:
        assert kind_runner("echo_kind", root)() == {"echo": 0}
        for bad in ("serv", "../drive", "", None):
            with pytest.raises(KeyError):
                kind_runner(bad, root)
    finally:
        os.remove(path)


def test_same_seed_same_inputs():
    cell = Cell("vgg16-serve-bs1")
    a = drive.seeds(2 ** 40 + 3)
    assert a == drive.seeds(2 ** 40 + 3) and a != drive.seeds(2 ** 40 + 4)
    data = cell.cfg.data
    one = scenes.batches(data, np.random.SeedSequence(9), 2, 1, (128, 256), 8, 8, threads=1)
    two = scenes.batches(data, np.random.SeedSequence(9), 2, 1, (128, 256), 8, 8, threads=3)
    for x, y in zip(one, two):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)


# ---- the output check fails what it must ----------------------------------

def _state_unchanged(step):
    from benchmark.harness import program

    def broken(state, *args, **kwargs):
        keep = {k: v.detach().clone()
                for k, v in program.trainable_state(state).items()}
        out = step(state, *args, **kwargs)
        with torch.no_grad():
            for k, v in program.trainable_state(state).items():
                v.copy_(keep[k])
        return out
    return broken


def _answer_altered(forward):
    def broken(image, im_info):
        dets = forward(image, im_info)
        boxes = dets.boxes.clone()
        boxes[0, 0] += 0.25 * (boxes[0, 0, 2:] - boxes[0, 0, :2]).repeat(2) + 4.0
        return dets._replace(boxes=boxes)
    return broken


def _half_the_batch(forward):
    def broken(image, im_info):
        dets = forward(image, im_info)
        valid = dets.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return dets._replace(valid=valid,
                             scores=torch.where(valid, dets.scores, -1.0))
    return broken


def _half_the_batch_step(step):
    """A step that leaves out the second half of its source batch and takes
    the mean over the rest: the first half stands in its place."""
    def broken(state, image, im_info, gt_boxes, num_boxes, *target):
        h = image.shape[0] // 2
        first = lambda t: torch.cat([t[:h], t[:h]])
        return step(state, first(image), first(im_info), first(gt_boxes),
                    first(num_boxes), *target)
    return broken


def _state_unchanged_after_warm_up(step):
    """A step that goes wrong only after the set-up's steps: the window's
    fault the set-up steps cannot see."""
    calls = [0]
    broken = _state_unchanged(step)

    def maybe(state, *args, **kwargs):
        calls[0] += 1
        return (step if calls[0] <= drive.SETUP_STEPS else broken)(
            state, *args, **kwargs)
    return maybe


def _sites_hidden(forward):
    """A forward that reaches none of the recorded call sites, as one
    replayed from a captured graph: it runs with the sites' functions as
    they were before the recorder wrapped them."""
    from scda_tpu_torch.models import detector as det

    plain = {"propose": det.propose, "postprocess": det.postprocess}

    def hidden(image, im_info):
        wrapped = {k: getattr(det, k) for k in plain}
        for k, v in plain.items():
            setattr(det, k, v)
        try:
            return forward(image, im_info)
        finally:
            for k, v in wrapped.items():
                setattr(det, k, v)
    return hidden


@pytest.mark.parametrize("name", ["vgg16-scda-bs1", "res101_ms-train-bs1"])
def test_the_step_after_the_window_is_judged(root, name):
    cell = Cell("tiny_" + name, root)
    r = _run(cell, seed=11, faults={"step": _state_unchanged_after_warm_up})
    assert r["correct"] is False
    assert r["checks"]["window_update_gap"]["value"] == 1.0
    assert r["checks"]["update_gap"]["value"] <= r["checks"]["update_gap"]["limit"]


@pytest.mark.parametrize("name", ["vgg16-serve-bs1", "res101_ms-serve-bs8"])
def test_a_forward_that_hides_its_call_sites_is_not_judged_correct(root, name):
    """Nothing to follow: the run ends with a verdict, not an error."""
    cell = Cell("tiny_" + name, root)
    r = _run(cell, seed=11, faults={"forward": _sites_hidden})
    assert r["correct"] is False
    assert r["checks"]["entries_not_followed"]["value"] >= 1
    assert "head_gap" not in r["checks"]


@pytest.mark.parametrize("name,fault,broken", [
    ("vgg16-scda-bs1", "step", _state_unchanged),
    ("res101_ms-train-bs1", "step", _state_unchanged),
    ("vgg16-train-bs8", "step", _state_unchanged),
    ("vgg16-train-bs8", "step", _half_the_batch_step),
    ("vgg16-serve-bs1", "forward", _answer_altered),
    ("res101_ms-serve-bs8", "forward", _answer_altered),
    ("res101_ms-serve-bs8", "forward", _half_the_batch),
])
def test_a_broken_timed_path_is_not_correct(root, name, fault, broken):
    cell = Cell("tiny_" + name, root)
    r = _run(cell, seed=11, faults={fault: broken})
    assert r["correct"] is False
    failing = [k for k, c in r["checks"].items()
               if c.get("compared", True) and not c["value"] <= c["limit"]]
    assert failing


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_is_not_correct(root, name):
    cell = Cell("tiny_" + name, root)
    numbers = control.control_numbers(cell, 13, torch.device("cpu"))
    correct, checks = judge.verdict(numbers, cell.limits, cell.not_compared)
    assert correct is False, checks


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_fails_at_the_cells_size(name):
    """On the card, at the cell's own size and limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    cell = Cell(name)
    numbers = control.control_numbers(cell, 4000000099, torch.device("cuda", 0))
    correct, checks = judge.verdict(numbers, cell.limits, cell.not_compared)
    assert correct is False, checks


# ---- a configuration with a reference and a CPU cut of its own ------------

PROBE_CUT = {"model": {"backbone": "tiny"}, "adapt": {"d_channels": 16},
             "data": {"image_size": [64, 128]}}


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _write_probe_reference(root):
    """``reference/steps_probe.py``: ``steps.py`` with the RoI head's class
    logits scaled by 1.5, in serving and in training."""
    with open(os.path.join(BENCH, "reference", "steps.py")) as f:
        src = f.read()
    assert src.count("N.roi_head(") == 2
    src = src.replace("N.roi_head(", "_scaled_head(") + (
        "\n\ndef _scaled_head(*args, **kwargs):\n"
        "    cls, deltas = N.roi_head(*args, **kwargs)\n"
        "    return 1.5 * cls, deltas\n")
    with open(os.path.join(root, "benchmark", "reference", "steps_probe.py"),
              "w") as f:
        f.write(src)


def _add_configuration(root, name, base, mix_of, **keys):
    """Configuration ``name`` (``base``'s file with ``keys`` added) in the
    checkout at ``root``, with its CPU cut ``PROBE_CUT`` in
    ``tests/cuts/<name>.json`` and cut by ``tiny_config``, and one cell
    over the tiny mix of the cell ``mix_of``: new files and entries only.
    Returns the cell's name."""
    bench_dir = os.path.join(root, "benchmark")
    with open(os.path.join(bench_dir, "configs", base + ".json")) as f:
        cfg = json.load(f)
    _write_json(os.path.join(bench_dir, "configs", name + ".json"),
                {**cfg, **keys})
    os.makedirs(os.path.join(bench_dir, "tests", "cuts"), exist_ok=True)
    _write_json(os.path.join(bench_dir, "tests", "cuts", name + ".json"),
                PROBE_CUT)
    tiny = "tiny_" + name
    _write_json(os.path.join(bench_dir, "configs", tiny + ".json"),
                tiny_config(name, bench_dir))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = {c["name"]: c for c in bench["configs"]}[base]
    bench["configs"].append({**entry, "name": tiny,
                             "file": f"benchmark/configs/{tiny}.json",
                             "reduced": sorted(PROBE_CUT)})
    like = {w["name"]: w for w in bench["workloads"]}["tiny_" + mix_of]
    cell = f"{tiny}-{mix_of}"
    bench["workloads"].append({**like, "name": cell, "config": tiny})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like["name"] in m.get("workloads", []):
            m["workloads"].append(cell)
    _write_json(os.path.join(bench_dir, "limits", cell + ".json"),
                {"limits": TINY_LIMITS})
    _write_json(os.path.join(root, "BENCHMARK.json"), bench)
    return cell


PROBE_CELLS = (("vgg16", "vgg16-serve-bs1", "head_gap"),
               ("res101_ms", "res101_ms-train-bs1", "grad_gap"))


@pytest.fixture(scope="module")
def probe_root(tmp_path_factory):
    """A checkout as ``tiny_root`` builds one, with, for each of
    ``PROBE_CELLS``, a configuration that names ``steps_probe`` with a
    CPU cut of its own in ``tests/cuts``, and the same configuration
    without the reference key; no harness file changes."""
    root = tiny_root(str(tmp_path_factory.mktemp("probe")))
    _write_probe_reference(root)
    for base, mix_of, _ in PROBE_CELLS:
        _add_configuration(root, f"probe_{base}", base, mix_of,
                           reference="steps_probe")
        _add_configuration(root, f"plain_{base}", base, mix_of)
    assert _changed_files(root) == []
    return root


@pytest.fixture
def steps_unreachable(monkeypatch):
    """The package's ``reference.steps`` raises when called: a harness file
    that still imports it in place of the cell's reference fails."""
    from benchmark.reference import steps

    def refuse(*args, **kwargs):
        raise AssertionError("called benchmark.reference.steps directly")

    for fn in ("serve", "train_steps", "trainable_names", "doubled_biases",
               "first_gradient"):
        monkeypatch.setattr(steps, fn, refuse)


def test_a_configuration_states_its_own_cpu_cut(probe_root):
    """The cut file ``tests/cuts/<config>.json`` is set over the
    configuration; without one, the cut is the tiny backbone as before."""
    bench_dir = os.path.join(probe_root, "benchmark")
    cut = tiny_config("probe_vgg16", bench_dir)
    assert cut["reference"] == "steps_probe"
    assert cut["data"]["image_size"] == [64, 128]
    assert cut["adapt"]["d_channels"] == 16
    assert cut["model"]["backbone"] == "tiny"
    assert cut["model"]["compute_dtype"] == "float32"
    assert Cell("tiny_probe_vgg16-vgg16-serve-bs1", probe_root).cfg.data.image_size \
        == [64, 128]
    for c in BENCHMARK["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            old = json.load(f)
        old["name"] = "tiny_" + c["name"]
        old["model"].update(backbone="tiny", compute_dtype="float32")
        old["test"]["bf16_weights"] = False
        old["data"].update(image_size=[64, 96], scale=64, max_size=96)
        old["adapt"]["d_channels"] = 32
        assert tiny_config(c["name"]) == old


@pytest.mark.parametrize("base,mix_of,fails", PROBE_CELLS)
def test_a_cell_is_judged_by_the_reference_its_configuration_names(
        probe_root, steps_unreachable, base, mix_of, fails):
    """``steps_probe``'s head differs from the program's: the run is not
    correct, and ``fails`` is among the numbers that fail."""
    cell = Cell(f"tiny_probe_{base}-{mix_of}", probe_root)
    assert os.path.basename(cell.reference.__file__) == "steps_probe.py"
    r = _run(cell, seed=17)
    assert r["correct"] is False
    failing = {k for k, c in r["checks"].items()
               if c.get("compared", True) and not c["value"] <= c["limit"]}
    assert fails in failing, r["checks"]


@pytest.mark.parametrize("base,mix_of,fails", PROBE_CELLS)
def test_the_same_configuration_without_the_key_is_correct(
        probe_root, steps_unreachable, base, mix_of, fails):
    cell = Cell(f"tiny_plain_{base}-{mix_of}", probe_root)
    assert os.path.basename(cell.reference.__file__) == "steps.py"
    r = _run(cell, seed=17)
    assert r["correct"] is True, r["checks"]


def test_the_fp8_control_goes_through_the_named_reference(
        probe_root, steps_unreachable):
    cell = Cell("tiny_probe_vgg16-vgg16-serve-bs1", probe_root)
    calls = []
    serve = cell.reference.serve

    def counted(*args, **kwargs):
        calls.append(kwargs.get("proposals") is None)
        return serve(*args, **kwargs)

    cell.reference.serve = counted
    numbers = control.control_numbers(cell, 13, torch.device("cpu"))
    # One call a pool entry as the control, one as the reference judging it.
    n = len(drive.make_inputs(cell, 13)[1])
    assert calls.count(True) == n and calls.count(False) == n
    assert numbers["head_gap"] > 0


def test_a_reference_with_no_file_is_refused(probe_root):
    with pytest.raises(KeyError):
        spec.reference("no_such_reference", probe_root)
    for bad in ("../reference/steps", "", None, "steps.py"):
        with pytest.raises(KeyError):
            spec.reference(bad, probe_root)
    bench_dir = os.path.join(probe_root, "benchmark")
    with open(os.path.join(bench_dir, "configs", "probe_vgg16.json")) as f:
        cfg = json.load(f)
    cfg["reference"] = "no_such_reference"
    _write_json(os.path.join(bench_dir, "configs", "probe_vgg16.json"), cfg)
    _write_json(os.path.join(bench_dir, "configs", "tiny_probe_vgg16.json"),
                tiny_config("probe_vgg16", bench_dir))
    try:
        with pytest.raises(KeyError, match="no_such_reference"):
            Cell("tiny_probe_vgg16-vgg16-serve-bs1", probe_root)
    finally:
        cfg["reference"] = "steps_probe"
        _write_json(os.path.join(bench_dir, "configs", "probe_vgg16.json"), cfg)
        _write_json(os.path.join(bench_dir, "configs", "tiny_probe_vgg16.json"),
                    tiny_config("probe_vgg16", bench_dir))


# ---- the yardstick's frozen copies -----------------------------------------

def test_flops_copy_equals_the_programs():
    from scda_tpu_torch.config import get_config, replace_path
    from scda_tpu_torch.utils import flops as port_flops

    for name, preset in (("vgg16", "vgg16"), ("res101_ms", "res101")):
        cell = Cell({"vgg16": "vgg16-scda-bs1", "res101_ms": "res101_ms-train-bs1"}[name])
        cfg = get_config(preset)
        cfg = replace_path(cfg, "model.multiscale_roi", cell.cfg.model.multiscale_roi)
        hw = tuple(cell.cfg.data.image_size)
        for fn in ("inference_flops_per_image", "train_flops_per_image",
                   "scda_step_flops_per_src_image"):
            assert getattr(flops, fn)(cell.cfg, hw) == getattr(port_flops, fn)(cfg, hw)


def test_mfu_and_rooflines_on_fixed_numbers():
    # 14 source images/s of VGG16 SCDA at 512x1024.
    cell = Cell("vgg16-scda-bs1")
    per = flops.scda_step_flops_per_src_image(cell.cfg, (512, 1024))
    assert math.isclose(roofline.mfu_pct(14.0, per), 100 * 14.0 * per / 989e12)
    # res101-ms layer3 at bs 1 and 8, layer2 at bs 1: the shapes of the cells.
    l3, l2 = ((1, 32, 64, 1024), (22, 1024, 256)), ((1, 64, 128, 512), (3, 512, 128))
    bwd = roofline.chain_bwd_bound(*l3)["bound_ms"] + roofline.chain_bwd_bound(*l2)["bound_ms"]
    assert math.isclose(bwd, 0.2308, rel_tol=2e-3)
    fwd8 = sum(roofline.chain_bound(x, w)["bound_ms"] for x, w in (
        ((8, 128, 256, 256), (2, 256, 64)), ((8, 64, 128, 512), (3, 512, 128)),
        ((8, 32, 64, 1024), (22, 1024, 256))))
    assert math.isclose(fwd8, 1.003, rel_tol=2e-3)
    for bound in (bwd, fwd8):
        for t in (bound, 1.0001 * bound, 3 * bound, 100 * bound):
            assert roofline.share_pct(bound, t) <= 100.0
    assert roofline.share_pct(1.0, 0.0) is None and roofline.mfu_pct(0.0, per) is None


def test_the_scda_readers_on_fixed_numbers():
    """The SCDA cell's per-layer readers: the window's rate as it is, the
    model FLOPs over the device's busy time, launches per source image;
    nothing for another kind or a trace with no device time."""
    from types import SimpleNamespace

    cell = Cell("vgg16-scda-bs1")
    per = flops.scda_step_flops_per_src_image(cell.cfg, (512, 1024))
    trace = {"busy_s": 0.048, "summary": {"kernels_per_unit": 3122.0}}
    run = SimpleNamespace(kind="scda", cfg=cell.cfg, img_per_s=14.2, units=3,
                          images_per_unit=1, trace=trace)
    assert reader("train_img_s.scda")(run) == 14.2
    assert math.isclose(reader("mfu.scda")(run), 100 * 3 / 0.048 * per / 989e12)
    assert 0 < reader("mfu.scda")(run) < 100
    assert reader("launches_per_img.scda")(run) == 3122.0
    for name in ("train_img_s.scda", "mfu.scda", "launches_per_img.scda"):
        assert reader(name)(SimpleNamespace(**{**vars(run), "kind": "train"})) is None
    assert reader("mfu.scda")(SimpleNamespace(
        **{**vars(run), "trace": {**trace, "busy_s": 0.0}})) is None


def test_roofline_copy_equals_chip_smokes():
    sys.path.insert(0, ROOT)
    import chip_smoke

    x = torch.empty((8, 32, 64, 1024), dtype=torch.bfloat16, device="meta")
    w1 = torch.empty((22, 1024, 256), device="meta")
    assert roofline.chain_bound(x.shape, w1.shape)["bound_ms"] == \
        chip_smoke.chain_bound(x, w1)["bound_ms"]
    x1 = torch.empty((1, 32, 64, 1024), dtype=torch.bfloat16, device="meta")
    assert math.isclose(roofline.chain_bwd_bound(x1.shape, w1.shape)["bound_ms"],
                        chip_smoke.chain_bwd_bound(x1, w1)["bound_bf16_ms"])


def test_profile_copy_equals_the_programs():
    from scda_tpu_torch.utils import profile as port_profile

    rows = [("chain_wgmma_kernel<1>", 3, 1.5), ("cudnn::conv", 10, 2.0),
            ("vectorized_elementwise_kernel fill", 40, 0.7),
            ("chain_bwd_wgrad_kernel", 4, 3.0), ("ProfilerStep#2", 1, 9.0)]
    assert prof.summarize(rows, 2, 10.0) == port_profile.summarize(rows, 2, 10.0)
    assert prof.KINDS == port_profile.KINDS
    assert prof.PORT_KERNELS == port_profile.PORT_KERNELS


def test_span_times_copy_equals_the_programs():
    """``read_trace``'s ``span_ms`` is the program's ``span_times`` on the
    program's own fixed events, and empty where no span opened."""
    from scda_tpu_torch.utils import profile as port_profile
    from tests.test_torch_spans import fixed_events

    for with_spans in (True, False):
        events = fixed_events(with_spans)
        got = prof.read_trace(events, 0.002, 1, 2.0)["span_ms"]
        assert got == port_profile.span_times(events)
        assert bool(got) is with_spans


def test_scene_copy_equals_the_programs():
    from scda_tpu_torch.data import pipeline, synthetic

    names = ("person", "rider", "car", "truck", "bus", "train", "motorcycle",
             "bicycle")
    a = synthetic._draw_scene(np.random.RandomState(3), 96, 192, 8, names, 0.4)
    b = scenes.draw_scene(np.random.RandomState(3), 96, 192, 8, 8, 0.4)
    for u, v in zip(a, b):
        assert np.array_equal(u, v)
    img = np.random.RandomState(4).rand(100, 200, 3).astype(np.float32) * 255
    assert np.array_equal(scenes.resize_bilinear(img, 50, 100),
                          pipeline._resize_bilinear_np(img, 50, 100))
    data = Cell("vgg16-serve-bs1").cfg.data
    assert scenes.compute_scale(1024, 2048, data.scale, data.max_size) == \
        pipeline.compute_scale(1024, 2048, data.scale, data.max_size)

"""ResNet-FPN Faster R-CNN (``models/fpn.py``) against the benchmark's plain
f32 reference, ``benchmark/reference/fpn.py``, on the CPU at the
benchmark's CPU cut of ``res101_fpn`` (``benchmark/tests/cuts/
res101_fpn.json``: a ResNet-50 trunk on a 128x256 canvas, fewer
proposals and rois), in f32, on the benchmark's seeded weights and
scenes, two images a batch.

Forward (``forward_inference``, its proposal calls and postprocess
followed by name as the benchmark follows them): each level's RPN
outputs, each level's proposals (exact), the collect (exact), the head's
outputs, the detections (exact, through the reference's postprocess on
the program's head outputs).  Training (``make_train_step`` over
``create_train_state``, three steps): the losses, the first gradient of
every trainable leaf, the three steps' update of every leaf.  The
reference follows the program through its proposal calls, whose greedy
choice among near ties flips on rounding.  The one cached anchor grid, at the
C4 map's settings and at each pyramid level's, against ``shift_anchors``.

Tolerances: both sides compute in f32, in different orders (the program
folds the frozen batch norms into K4's twin and sums over the levels
laid end to end; the reference unfolds them and pools level by level),
so each gap is one of f32 rounding carried through a 50-layer trunk
(and, in the gradients, through its ReLU gates): measured 3.5e-6 (RPN
outputs), 2.5e-7 (losses), 3.3e-4 (a leaf's gradient, |g - g_ref| over
max(|g_ref|, the median leaf's)) and 1.9e-4 (a leaf's three-step update,
the same way).  The tolerances sit over five times above those readings
(1e-4; 1e-5 for the losses; 2e-3 for a leaf) and under what the same
reference reads with its products' operands rounded to bfloat16, the
configuration's own compute (a leaf's gradient 0.044 at worst, 0.017 the
median leaf): ``test_a_bf16_reference_fails_the_tolerances``.

This file imports no JAX.
"""

from __future__ import annotations

import contextlib
import statistics

import numpy as np
import pytest
import torch

from benchmark.harness import program, weights as W
from benchmark.harness.spec import ns
from benchmark.reference import detect as D
from benchmark.reference import fpn as R
from benchmark.reference.precision import BF16, F32
from benchmark.tests.tiny import tiny_config
from benchmark.traffic import scenes
from scda_tpu_torch.core import boxes as box_ops
from scda_tpu_torch.models import detector as det
from scda_tpu_torch.models import fpn
from scda_tpu_torch.models.faster_rcnn import FasterRCNN
from scda_tpu_torch.models.rpn import anchor_grid

SEED = 2 ** 40 + 11
RPN_TOL = 1e-4     # RPN logits and deltas, head logits and deltas
LOSS_TOL = 1e-5    # relative loss
LEAF_TOL = 2e-3    # a leaf's gradient or update


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """(program config, reference config, weights, three batches of 2)."""
    torch.set_num_threads(2)
    cut = tiny_config("res101_fpn")
    cfg = program.port_config(cut, SEED)
    ref_cfg = ns({k: cut[k] for k in program.GROUPS})
    ref_cfg.train.seed = SEED
    weights = W.make(program.model_layout(cfg),
                     torch.Generator().manual_seed(SEED), he_heads=False)
    pool = scenes.batches(ref_cfg.data, np.random.SeedSequence(SEED), 3, 2,
                          scene_hw=(128, 192), max_objects=8, num_classes=8,
                          max_gt=ref_cfg.data.max_gt_boxes)
    batches = [tuple(torch.from_numpy(a) for a in b) for b in pool]
    return cfg, ref_cfg, weights, batches


@contextlib.contextmanager
def recorded(calls):
    """``models.detector.propose`` and ``.postprocess`` wrapped by name, as
    the benchmark wraps them: each call's (name, args, output)."""
    saved = det.propose, det.postprocess

    def wrap(orig, name):
        def call(*args):
            out = orig(*args)
            calls.append((name, args, out))
            return out
        return call

    det.propose, det.postprocess = (wrap(saved[0], "propose"),
                                    wrap(saved[1], "postprocess"))
    try:
        yield
    finally:
        det.propose, det.postprocess = saved


def rel_gap(a, ref) -> float:
    ref = ref.detach().float()
    return float((a.detach().float() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def props(p) -> D.Proposals:
    return D.Proposals(p.boxes.float(), p.scores.float(), p.valid)


@pytest.fixture(scope="module")
def served(setup):
    """The program's served batch with its calls, and the reference's
    forward on the program's per-level proposals."""
    cfg, ref_cfg, weights, batches = setup
    _, model = program.serving(cfg, weights, torch.device("cpu"))
    image, info = batches[0][:2]
    calls = []
    with recorded(calls):
        dets = det.forward_inference(model, image, info, cfg)
    level_calls = [(a, o) for n, a, o in calls if n == "propose"]
    (_, post_args, _), = [c for c in calls if c[0] == "postprocess"]
    ref = R.serve(weights, image, info, ref_cfg, F32,
                  proposals=[props(o) for _, o in level_calls])
    return level_calls, post_args, dets, ref, info


def test_the_model_is_laid_out_as_the_reference_reads_it(setup):
    cfg, _, weights, _ = setup
    with torch.device("meta"):
        model = FasterRCNN(cfg.model, cfg.anchors.num_anchors)
    keys = [k for k, *_ in program.model_layout(cfg)]
    assert keys[0] == "RCNN_base.0.weight"
    assert set(keys) == set(model.state_dict())
    assert {"RCNN_base.7.2.conv3.weight", "RCNN_fpn.inner_blocks.3.weight",
            "RCNN_fpn.layer_blocks.0.bias", "RCNN_top.fc6.weight",
            "RCNN_top.fc7.bias", "RCNN_rpn.RPN_cls_score.weight"} <= set(keys)
    assert model.RCNN_top.fc6.weight.shape == (fpn.MLP_HEAD_DIM,
                                               fpn.FPN_DIM * 7 * 7)


def test_every_level_is_one_proposal_call_with_the_references_anchors(served):
    level_calls, _, _, ref, _ = served
    assert len(level_calls) == len(fpn.RPN_LEVELS)
    for (args, _), (ref_args, _), level in zip(level_calls, ref["calls"],
                                               fpn.RPN_LEVELS):
        cls, bbox, anchors = args[:3]
        h, w = cls.shape[1:3]
        assert cls.shape[3] == 3 and bbox.shape[1:3] == (h, w)
        assert torch.equal(anchors, ref_args[2]), level


def test_rpn_outputs_of_every_level_match_the_reference(served):
    level_calls, _, _, ref, _ = served
    for (args, _), (ref_args, _) in zip(level_calls, ref["calls"]):
        assert rel_gap(args[0], ref_args[0]) <= RPN_TOL
        assert rel_gap(args[1], ref_args[1]) <= RPN_TOL


def test_each_levels_proposals_are_the_reference_layers_exactly(served):
    """The reference's proposal layer on the program's RPN outputs gives
    the program's proposals, slot for slot."""
    level_calls, _, _, _, _ = served
    for args, out in level_calls:
        again = D.propose(args[0].float(), args[1].float(), *args[2:])
        out = props(out)
        assert torch.equal(again.valid, out.valid)
        assert torch.equal(again.boxes, out.boxes)
        assert torch.equal(again.scores[out.valid], out.scores[out.valid])
        assert out.valid.any()


def test_the_collect_is_the_references_exactly(served):
    level_calls, post_args, _, ref, _ = served
    program_props = props(post_args[0])
    assert program_props.boxes.shape[1] == 150
    for a, b in zip(program_props, ref["props"]):
        assert torch.equal(a, b)
    # Ties go to the lower level, then the lower slot.
    one = D.Proposals(torch.zeros(1, 2, 4), torch.tensor([[0.5, 0.5]]),
                      torch.tensor([[True, True]]))
    two = one._replace(boxes=torch.ones(1, 2, 4))
    for collect in (fpn.collect, R.collect):
        got = collect([one, two], 3)
        assert torch.equal(got.boxes[0, :, 0], torch.tensor([0.0, 0.0, 1.0]))


@pytest.mark.parametrize("base_size, scales, stride", [
    (16, (8.0, 16.0, 32.0), 16),                               # the C4 map
    *[(2 ** k, (8.0,), 2 ** k) for k in fpn.RPN_LEVELS]])      # P2 .. P6
def test_one_cached_anchor_grid_serves_every_level(base_size, scales,
                                                      stride):
    """``models.rpn.anchor_grid`` is ``shift_anchors``' grid bit for bit,
    and the same tensor on a second call."""
    ratios = (0.5, 1.0, 2.0)
    h, w = 1 + 512 // stride, 1024 // stride
    key = (base_size, ratios, scales, stride, h, w, torch.device("cpu"))
    got = anchor_grid(*key)
    want = box_ops.shift_anchors(
        box_ops.generate_base_anchors(base_size, ratios, scales), h, w,
        stride)
    assert got.shape == (h * w * len(ratios) * len(scales), 4)
    assert torch.equal(got, torch.from_numpy(want))
    assert anchor_grid(*key) is got


def test_roi_levels_follow_detectrons_rule():
    side = torch.tensor([10.0, 111.0, 112.0, 223.0, 224.0, 447.0, 448.0, 2000.0])
    rois = torch.stack([torch.zeros_like(side), torch.zeros_like(side),
                        side - 1, side - 1], -1)
    want = [2, 2, 3, 3, 4, 4, 5, 5]
    assert fpn.roi_levels(rois).tolist() == want
    assert R.roi_levels(rois).tolist() == want


def test_head_outputs_match_the_reference(served):
    _, post_args, _, ref, _ = served
    assert rel_gap(post_args[1], ref["head"][0]) <= RPN_TOL
    assert rel_gap(post_args[2], ref["head"][1]) <= RPN_TOL


def test_detections_are_the_references_postprocess_exactly(served, setup):
    _, post_args, dets, _, info = served
    ref_cfg = setup[1]
    p = props(post_args[0])
    again = D.postprocess(p, *D.class_boxes(p, post_args[1], post_args[2], info,
                                            ref_cfg), info, ref_cfg)
    for a, b in zip(dets, again):
        assert torch.equal(a, b)


# ---- training ---------------------------------------------------------------

def program_steps(cfg, weights, batches):
    """Three steps through ``make_train_step``: (metrics, per-level
    proposals a step, first gradient, parameters after the last step)."""
    state, step = program.training(cfg, weights, torch.device("cpu"))
    metrics, level_props = [], []
    for i, b in enumerate(batches):
        calls = []
        with recorded(calls):
            _, m = step(state, *b)
        metrics.append({k: float(v) for k, v in m.items()})
        level_props.append([props(o) for n, _, o in calls if n == "propose"])
        if i == 0:
            first = {n: m.detach().clone()
                     for n, m in program.momentum_state(state).items()}
    return metrics, level_props, first, program.trainable_state(state)


@pytest.fixture(scope="module")
def trained(setup):
    cfg, ref_cfg, weights, batches = setup
    metrics, level_props, first, params = program_steps(cfg, weights, batches)
    pairs = [(b, None) for b in batches]
    ref = R.train_steps(weights, None, pairs, ref_cfg, F32, SEED, 3,
                        proposals=level_props)
    names = R.trainable_names(weights, ref_cfg.model)
    doubled = set(R.doubled_biases(weights, names, ref_cfg.train))
    return {"metrics": metrics, "props": level_props, "params": params,
            "first": R.first_gradient(first, doubled), "ref": ref,
            "names": names}


def leaf_gaps(prog, ref):
    """Each leaf's |a - b| over max(|b|, the median leaf's |b|)."""
    norms = {n: float(ref[n].float().norm()) for n in ref}
    med = statistics.median(norms.values())
    return {n: float((prog[n].float() - ref[n].float()).norm())
            / max(norms[n], med, 1e-30) for n in ref}


def updates(params, start):
    return {n: params[n].detach().float() - start[n].float() for n in params}


def test_the_step_trains_every_layer_but_the_frozen_ones(trained, setup):
    names = trained["names"]
    assert set(names) == set(trained["params"])
    assert not any(n.startswith(("RCNN_base.0.", "RCNN_base.4.")) for n in names)
    for prefix in ("RCNN_base.5.", "RCNN_base.7.", "RCNN_fpn.", "RCNN_rpn.",
                   "RCNN_top.fc6.", "RCNN_cls_score."):
        assert any(n.startswith(prefix) for n in names), prefix
    assert all(len(p) == len(fpn.RPN_LEVELS) for p in trained["props"])


def test_losses_match_the_reference(trained):
    for m, r in zip(trained["metrics"], trained["ref"]["metrics"]):
        for k in ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box"):
            assert abs(m[k] - r[k]) <= LOSS_TOL * max(abs(r[k]), 1e-3), k


def test_the_first_gradient_of_every_leaf_matches_the_reference(trained):
    gaps = leaf_gaps(trained["first"], trained["ref"]["first_grad"])
    assert max(gaps.values()) <= LEAF_TOL, max(gaps, key=gaps.get)


def test_three_steps_update_every_leaf_as_the_reference(trained, setup):
    weights = setup[2]
    ref = trained["ref"]
    gaps = leaf_gaps(updates(trained["params"], weights),
                     updates(ref["params"], weights))
    assert max(gaps.values()) <= LEAF_TOL, max(gaps, key=gaps.get)


def test_a_bf16_reference_fails_the_tolerances(trained, setup):
    """The same reference with bfloat16 operands in every product, on the
    program's first step and its proposals: the tolerances above see the
    configuration's own compute precision."""
    _, ref_cfg, weights, batches = setup
    low = R.train_steps(weights, None, [(batches[0], None)], ref_cfg, BF16,
                        SEED, 1, proposals=trained["props"][:1])
    f32 = trained["ref"]
    loss = abs(low["metrics"][0]["loss"] - f32["metrics"][0]["loss"]) \
        / abs(f32["metrics"][0]["loss"])
    grad = max(leaf_gaps(low["first_grad"], f32["first_grad"]).values())
    assert loss > LOSS_TOL and grad > LEAF_TOL


def test_scda_refuses_a_pyramid(setup):
    """SCDA's target tower, mining and discriminator read one feature
    map; an FPN model is refused rather than adapted on part of it."""
    from scda_tpu_torch.adapt import scda

    cfg = setup[0]
    with torch.device("meta"):
        model = FasterRCNN(cfg.model, cfg.anchors.num_anchors)
    with pytest.raises(ValueError, match="feature pyramid"):
        scda.make_scda_train_step(model, None, cfg)

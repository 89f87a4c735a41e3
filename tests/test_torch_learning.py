"""The port learns: its trainer's init against the JAX package's
``init_params``, and the JAX package's learning oracle
(``tests/test_overfit.py``) through the port on the CPU.

  * init: JAX's ``init_params`` and the port's :func:`init_params` for
    ``tiny``, VGG16 and ResNet-50 with multiscale RoI pooling, per
    parameter through the bridge's name map.  The two random streams
    differ, so the draws are held to their distributions: shapes equal;
    for every weight of at least 4096 entries the std within 5% of
    JAX's (a sample std of n truncated-normal draws has a relative
    spread of about 0.6 / sqrt(n), 0.9% at n = 4096); every truncated
    draw inside its bound; biases and FrozenBatchNorm buffers exactly
    equal.  ``model.truncated_init`` truncates both heads, on both sides;
  * the oracle: ``test_overfit.py``'s protocol (``tiny_config``, lr
    5e-3, 4 memory scenes with at most 2 objects from seed 7, bs 2,
    loader seed 0 without flips, 200 steps from the init of seed 0)
    through the port's train step, then ``evaluate_model``'s mAP > 0.3
    on the same scenes.  ``chip_smoke.py`` runs the same protocol on the
    card (its ``oracle_config`` is held equal here).
"""

import dataclasses
import math
import os

import numpy as np
import jax
import pytest
import torch

from helpers import tiny_config
from scda_tpu.config import replace_path
from scda_tpu.models.faster_rcnn import build_model as jax_build_model
from scda_tpu.models.faster_rcnn import init_params as jax_init_params
from scda_tpu_torch import bridge
from scda_tpu_torch.models.faster_rcnn import (
    build_model, empty_model, init_params,
)
from test_torch_parallel import port_config
from test_torch_train import train_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS = {"RCNN_cls_score.weight": 0.01, "RCNN_bbox_pred.weight": 0.001}
# Stddev of a unit normal truncated at +-2.
TRUNC2_STD = 0.87962566103423978


def _port_init(cfg, seed):
    model = build_model(port_config(cfg).model, cfg.anchors.num_anchors)
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def _jax_init(cfg, seed):
    h, w = cfg.data.image_size
    jm = jax_build_model(cfg.model, num_anchors=cfg.anchors.num_anchors)
    params = jax_init_params(jm, jax.random.key(seed), (1, h, w, 3))
    return bridge.state_dict_from_jax(jax.device_get(params),
                                      cfg.model.backbone)


@pytest.fixture(scope="module", params=["tiny", "vgg16", "resnet50_ms"])
def inits(request):
    """Both packages' init of one network (JAX's VGG16 takes ~20 s)."""
    cfg = train_config(request.param)
    model = _port_init(cfg, 3)
    frozen_bn = {n for n, _ in model.named_buffers()}
    port = {k: v.numpy() for k, v in model.state_dict().items()}
    return dict(name=request.param, ref=_jax_init(cfg, 3), port=port,
                frozen_bn=frozen_bn)


def lecun_bound(w):
    """The truncation bound of a ``lecun_normal`` draw of ``w`` (out
    first, as torch lays out conv and linear weights)."""
    fan_in = int(np.prod(w.shape[1:]))
    return 2.0 * math.sqrt(1.0 / fan_in) / TRUNC2_STD


def test_init_shapes_and_exact_entries(inits):
    ref, port = inits["ref"], inits["port"]
    assert set(ref) == set(port)
    exact = [n for n in port if n.endswith(".bias") or n in inits["frozen_bn"]]
    assert exact
    for n in port:
        assert port[n].shape == ref[n].shape, n
    for n in exact:
        np.testing.assert_array_equal(port[n], ref[n], err_msg=n)
    if inits["name"] == "resnet50_ms":
        assert {n.rsplit(".", 1)[1] for n in inits["frozen_bn"]} == {
            "weight", "bias", "running_mean", "running_var"}
        assert float(port["RCNN_base.1.running_var"].min()) == 1.0


def test_init_stds_and_truncation_match_jax(inits):
    ref, port = inits["ref"], inits["port"]
    weights = [n for n in port if n.endswith(".weight")
               and n not in inits["frozen_bn"]]
    big = [n for n in weights if port[n].size >= 4096]
    assert len(big) >= 3
    for n in big:
        want = float(ref[n].std())
        assert abs(float(port[n].std()) - want) <= 0.05 * want, (
            n, float(port[n].std()), want)
    for n in weights:       # the bound itself, rounded to f32, may occur
        if n in HEADS:          # N(0, sigma), untruncated by default
            continue
        for w in (port[n], ref[n]):
            assert float(np.abs(w).max()) <= lecun_bound(w) * (1 + 1e-6), n


@pytest.mark.parametrize("truncated", [False, True], ids=["normal", "truncated"])
def test_truncated_init_truncates_both_heads(truncated):
    """``model.truncated_init``: both heads N(0, sigma) truncated at
    2 sigma, as ``jax.nn.initializers.truncated_normal`` draws (JAX's
    ``tiny`` heads, beside the port's VGG16 ones); without it some of
    the VGG16 heads' 37k and 147k draws lie past 2 sigma, and the std is
    sigma itself."""
    cfg = replace_path(train_config("vgg16"), "model.truncated_init", truncated)
    port = _port_init(cfg, 5).state_dict()
    jcfg = replace_path(tiny_config(), "model.truncated_init", truncated)
    ref = _jax_init(jcfg, 5)
    for n, sigma in HEADS.items():
        w = port[n].numpy()
        assert w.size >= 36864
        std = sigma * (TRUNC2_STD if truncated else 1.0)
        assert abs(float(w.std()) - std) <= 0.05 * std, (n, float(w.std()))
        past = float(np.abs(w).max()) > 2 * sigma
        assert past != truncated, n
        jpast = float(np.abs(ref[n]).max()) > 2 * sigma * (1 + 1e-6)
        assert jpast != truncated, n
        assert float(port[n.replace("weight", "bias")].abs().max()) == 0.0


@pytest.mark.parametrize("net", ["tiny", "resnet50_ms"])
def test_init_is_seeded_and_replaces_every_entry(net):
    """Same seed, same weights; another seed, other weights; and every
    entry is set, over a model built with other weights and over the
    unset memory of ``empty_model`` (the CLIs' start)."""
    cfg = train_config(net)
    a, b, c = (_port_init(cfg, s).state_dict() for s in (1, 1, 2))
    for n in a:
        assert torch.equal(a[n], b[n]), n
    assert not torch.equal(a["RCNN_base.0.weight"], c["RCNN_base.0.weight"])
    mc, anchors = port_config(cfg).model, cfg.anchors.num_anchors
    for other in (build_model(mc, anchors,
                              generator=torch.Generator().manual_seed(9)),
                  empty_model(mc, anchors)):
        init_params(other, torch.Generator().manual_seed(1))
        sd = other.state_dict()
        assert list(sd) == list(a)
        for n, v in sd.items():
            assert torch.equal(v, a[n]), n
            assert v.stride() == a[n].stride(), n


# ---------------------------------------------------------- the oracle

def oracle_config():
    """``test_overfit.py``'s config: ``tiny_config`` at lr 5e-3."""
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, learning_rate=5e-3))


def test_chip_smoke_runs_the_oracle_protocol():
    import chip_smoke

    assert (dataclasses.asdict(chip_smoke.oracle_config())
            == dataclasses.asdict(oracle_config()))
    assert chip_smoke.ORACLE == dict(scenes=4, max_objects=2, data_seed=7,
                                     batch_size=2, loader_seed=0,
                                     init_seed=0, steps=200, map_min=0.3)


@pytest.mark.parametrize("name, script", [
    ("learning_ab", "scripts/scda_ab_demo.sh"),
    ("car", "scripts/scda_car_ab.sh"),
])
def test_chip_smoke_runs_the_script_protocols(name, script):
    """``chip_smoke.py`` passes the port's CLIs what the JAX repo's
    script passes its own: each stage's steps and learning rate, the
    SCDA arm's target, and the protocol's classes and ``--set`` overrides
    (the car protocol's class-agnostic head, alternating D/G), to
    training and evaluation alike.  What it changes on purpose: every
    step logged, seeds 3-5 per arm, 32 val scenes."""
    import chip_smoke

    proto = chip_smoke.PROTOCOLS[name]
    assert proto["script"] == script
    with open(os.path.join(REPO, script)) as f:
        text = " ".join(f.read().split())
    for flags in (chip_smoke.AB_SOURCE[:4], chip_smoke.AB_ARM[:4],
                  chip_smoke.AB_SCDA, proto["train"], proto["set"],
                  proto["scda_set"]):
        assert " ".join(flags) in text, flags
    assert proto["eval"] == proto["train"]
    assert chip_smoke.AB_NET == "vgg16" and "--net vgg16" in text
    assert "--bs 1" in text and "--synth_images 16" in text
    assert " ".join(chip_smoke.AB_COMMON[:6]) == (
        "--dataset synthetic --bs 1 --synth_images 16")
    assert chip_smoke.AB_VAL_IMAGES == 32 and chip_smoke.AB_SEEDS == (3, 4, 5)


def test_port_overfits_four_scenes_to_map(tmp_path):
    """``test_overfit.py`` through the port: 200 steps, mAP > 0.3."""
    from scda_tpu_torch.data.pipeline import DataLoader
    from scda_tpu_torch.data.synthetic import make_memory_dataset
    from scda_tpu_torch.evals.detect import evaluate_model
    from scda_tpu_torch.train.state import create_train_state
    from scda_tpu_torch.train.steps import make_train_step

    cfg = port_config(oracle_config())
    ds = make_memory_dataset(num_images=4, image_size=cfg.data.image_size,
                             max_objects=2, seed=7, tmpdir=str(tmp_path))
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    init_params(model, torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, steps_per_epoch=10**6)
    step_fn = make_train_step(model, cfg)
    loader = DataLoader(ds, cfg.data, batch_size=2, seed=0,
                        augment_flip=False, prefetch=0)
    losses = []
    for batch in loader.repeat():
        state, metrics = step_fn(state, *(torch.from_numpy(a) for a in (
            batch.image, batch.im_info, batch.gt_boxes, batch.num_boxes)))
        losses.append(float(metrics["loss"]))
        if len(losses) >= 200:
            break
    assert all(map(math.isfinite, losses))
    results = evaluate_model(model, ds, cfg, device="cpu", batch_size=2)
    assert results["mAP"] > 0.3, results

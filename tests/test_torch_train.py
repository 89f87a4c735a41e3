"""The source-only train step of the port against the JAX package, on the
CPU (f32 compute).

Both packages get the same numpy weights (bridged), the same batch and
the same target uniforms (JAX's, rebuilt from its key chain: the two
random streams differ).  VGG16's dropout is switched off on both sides
(``flax.linen.Dropout`` and the port's ``vgg.dropout`` patched to the
identity); ``tiny`` and ResNet have none.

  * one step on ``tiny`` (128x192) and at full width on a 64x96 canvas
    for VGG16 and ResNet-50 with multiscale RoI pooling: the four losses
    at rtol=1e-5, every trainable gradient within 1e-4 of its norm (see
    the test for why not elementwise);
  * the optimizer: those gradients, scaled so that one of three steps
    clips, through three steps across an lr boundary with the momentum
    in f32 and in bf16, against optax: params at rtol=1e-5, atol=1e-8;
    frozen params bit-unchanged;
  * three whole train steps on ``tiny`` against JAX's ``make_train_step``;
  * bit-equal resume, the CLI, the guards of the kernel wrappers and
    ``check_train_config``, and the tie-splitting max-pool backward.

PyTorch's CPU convolution backward through oneDNN returns the data
gradient of a channels_last conv with a bias about 2e-3 off (against
float64; JAX and PyTorch's native kernels agree to 1e-6), which the
gradient checks caught at conv3_1 of VGG16.  The port's modules run
channels_last, so this file runs with oneDNN off.  The card runs cuDNN.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import synthetic_batch, tiny_config
from scda_tpu.config import replace_path
from scda_tpu.models import detector as jdet
from scda_tpu.models.faster_rcnn import build_model as jax_build_model
from scda_tpu.train import state as jstate
from scda_tpu.train.steps import make_train_step as jax_make_train_step
from scda_tpu_torch import bridge
from scda_tpu_torch.models import detector as tdet
from scda_tpu_torch.models.backbones import vgg as tvgg
from scda_tpu_torch.models.faster_rcnn import build_model
from scda_tpu_torch.train import checkpoint as ckpt
from scda_tpu_torch.train.state import create_train_state
from scda_tpu_torch.train.steps import (
    check_train_config, make_train_step, step_generators,
)
from test_torch_slice import jax_params
from test_torch_targets import jax_draws

import torch_numerics_state


@pytest.fixture(autouse=True, scope="module")
def _kept_numerics():
    """The CLIs' ``main`` sets the process-wide numerics
    (``scda_tpu_torch/utils/numerics.py``); they go back to what they
    were once this module is done."""
    with torch_numerics_state.kept():
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSSES = ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box")


@pytest.fixture(autouse=True, scope="module")
def _native_cpu_convolutions():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def train_config(name):
    if name == "tiny":
        return tiny_config()
    backbone = {"vgg16": "vgg16", "resnet50_ms": "resnet50"}[name]
    cfg = tiny_config(num_classes=9, backbone=backbone)
    cfg = replace_path(cfg, "model.rpn_channels", 512)
    cfg = replace_path(cfg, "data.image_size", (64, 96))
    if name == "resnet50_ms":
        cfg = replace_path(cfg, "model.multiscale_roi", True)
        cfg = replace_path(cfg, "model.ms_fine_threshold", 32.0)
        # The res50/101/152 presets' optimizer knobs (config.py:420-438).
        cfg = replace_path(cfg, "train.double_bias", False)
        cfg = replace_path(cfg, "train.weight_decay", 1e-4)
    return cfg


def step_draws(key, cfg, b, feat_hw):
    """The anchor and roi uniforms JAX's forward_train draws from ``key``."""
    k_anchor, k_roi, _ = jax.random.split(key, 3)
    n_anchor = feat_hw[0] * feat_hw[1] * cfg.anchors.num_anchors
    n_roi = cfg.train.proposal.post_nms_top_n + cfg.data.max_gt_boxes
    return {"anchor": jax_draws(k_anchor, b, n_anchor),
            "roi": jax_draws(k_roi, b, n_roi)}


def _t(x):
    return torch.from_numpy(np.array(x))


def train_params(backbone, cfg, seed):
    """``jax_params`` with the reference's head init (RPN and RoI heads
    N(0, 0.01), box regressors N(0, 0.001) in scale), so that the losses
    start near their untrained values and no logit saturates."""
    params = jax_params(backbone, cfg, seed=seed)
    for tree, gain in ((params["rpn"]["cls_score"], 0.01),
                       (params["rpn"]["bbox_pred"], 0.01),
                       (params["cls_score"], 0.01),
                       (params["bbox_pred"], 0.001)):
        tree["kernel"] = tree["kernel"] * np.float32(
            gain / tree["kernel"].std())
    return params


def train_batch(seed, cfg):
    """``synthetic_batch`` with unit-scale pixels (the He-scaled backbone
    keeps them O(1)) and a padded second image."""
    image, im_info, gt, num = synthetic_batch(np.random.RandomState(seed), cfg)
    h, w = cfg.data.image_size
    im_info[1] = [h - 16, w - 32, 0.9]
    return image / np.float32(30.0), im_info, gt, num


def _no_dropout(mp):
    import flax.linen as fnn

    mp.setattr(fnn.Dropout, "__call__",
               lambda self, x, deterministic=None, rng=None: x)
    mp.setattr(tvgg, "dropout", lambda x, rate, generator: x)


def _port_model(cfg, params):
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    sd = bridge.state_dict_from_jax(params, cfg.model.backbone)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


@pytest.fixture(scope="module", params=["tiny", "vgg16", "resnet50_ms"])
def step_run(request):
    """One train forward + backward in both packages."""
    name = request.param
    cfg = train_config(name)
    backbone = cfg.model.backbone
    params = train_params(backbone, cfg, seed=3)
    batch = train_batch(4, cfg)
    h, w = cfg.data.image_size
    key = jax.random.key(5)
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        jm = jax_build_model(cfg.model, num_anchors=cfg.anchors.num_anchors)

        def loss_fn(p, *b):
            out = jdet.forward_train(jm, p, *b, cfg, key)
            return out.loss, out.metrics

        (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, *map(jnp.asarray, batch))

        model = _port_model(cfg, params)
        state = create_train_state(cfg, model)
        stride = cfg.model.feat_stride
        draws = step_draws(key, cfg, 2, (h // stride, w // stride))
        out = tdet.forward_train(model, *map(_t, batch), cfg,
                                 step_generators(0, 0, "cpu"), draws=draws)
        names, tparams = state.trainable()
        grads = torch.autograd.grad(out.loss, tparams, materialize_grads=True)
    jgrads_sd = bridge.state_dict_from_jax(jax.device_get(jgrads), backbone)
    return dict(name=name, cfg=cfg, params=params, jgrads=jgrads,
                jgrads_sd=jgrads_sd, jmetrics=jax.device_get(jmetrics),
                metrics={k: float(v) for k, v in out.metrics.items()},
                names=names, grads=dict(zip(names, grads)), state=state)


def test_step_losses_match_jax(step_run):
    m, ref = step_run["metrics"], step_run["jmetrics"]
    for k in LOSSES:
        np.testing.assert_allclose(m[k], float(ref[k]), rtol=1e-5, err_msg=k)
    assert m["fg_cnt"] == float(ref["fg_cnt"]) > 0
    assert m["rpn_cls"] > 0 and m["rcnn_box"] > 0


def test_step_gradients_match_jax(step_run):
    """Each gradient within 1e-4 of its norm.  Not elementwise: the
    proposal boxes are decoded through ``exp``, whose last ulp differs
    between XLA and PyTorch, and RoI-Align's weights are linear in the
    box coordinates, so the pooled features, and every gradient that
    flows through the head, differ by about 3e-5 of their scale; small
    entries of a tensor carry that error at the tensor's scale."""
    grads, ref = step_run["grads"], step_run["jgrads_sd"]
    assert len(grads) > 4
    for n, g in grads.items():
        err = np.linalg.norm(g.numpy() - ref[n])
        assert err <= 1e-4 * np.linalg.norm(ref[n]), (n, err)
    nonzero = [n for n, g in grads.items() if g.abs().max() > 0]
    assert len(nonzero) >= len(grads) - 1, sorted(set(grads) - set(nonzero))


def test_frozen_params_have_no_gradient(step_run):
    state = step_run["state"]
    frozen = set(state.tx.frozen)
    for n, p in state.model.named_parameters():
        assert p.requires_grad == (n not in frozen)
    want = {"tiny": set(),
            "vgg16": {f"RCNN_base.{i}.{k}" for i in (0, 2, 5, 7)
                      for k in ("weight", "bias")},
            "resnet50_ms": {"RCNN_base.0.weight"}}[step_run["name"]]
    assert want <= frozen
    if step_run["name"] == "resnet50_ms":   # conv1 + layer1 frozen
        assert all(n.startswith(("RCNN_base.0.", "RCNN_base.4."))
                   for n in frozen)
        assert any(n.startswith("RCNN_base.4.") for n in frozen)


@pytest.mark.parametrize("momentum_dtype", ["float32", "bfloat16"])
def test_three_optimizer_steps_match_optax(step_run, momentum_dtype):
    cfg = replace_path(step_run["cfg"], "train.momentum_dtype", momentum_dtype)
    cfg = replace_path(cfg, "train.lr_decay_step", 2)
    cfg = replace_path(cfg, "train.max_epochs", 4)
    names, gsd = step_run["names"], step_run["jgrads_sd"]
    norm = np.sqrt(sum(float(np.sum(gsd[n].astype(np.float64) ** 2))
                       for n in names))
    scales = [c * cfg.train.clip_gradients / norm for c in (0.5, -3.0, 0.8)]

    js = jstate.create_train_state(cfg, step_run["params"], steps_per_epoch=1)
    for s in scales:
        js = js.apply_gradients(jax.tree_util.tree_map(
            lambda g: g * np.float32(s), step_run["jgrads"]))
    ref = bridge.state_dict_from_jax(jax.device_get(js.params),
                                     cfg.model.backbone)

    model = _port_model(cfg, step_run["params"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model, steps_per_epoch=1)
    assert state.tx.lr_schedule(1) == cfg.train.learning_rate * np.float32(1)
    for s in scales:
        state.apply_gradients({n: torch.from_numpy(gsd[n] * np.float32(s))
                               for n in names})
    assert state.step == 3
    assert {v.dtype for v in state.momentum.values()} == {
        getattr(torch, momentum_dtype)}
    frozen = set(state.tx.frozen)
    for n, v in model.state_dict().items():
        if n in frozen:
            assert torch.equal(v, before[n]), n
        else:
            np.testing.assert_allclose(v.numpy(), ref[n], rtol=1e-5,
                                       atol=1e-8, err_msg=n)


def test_three_train_steps_match_jax_tiny():
    """tiny has no dropout: three whole steps with JAX's per-step draws
    (``fold_in(base_rng, step)``) give the same losses and params."""
    cfg = tiny_config()
    params = train_params("tiny", cfg, seed=6)
    batch = train_batch(7, cfg)
    base = jax.random.key(8)
    js = jstate.create_train_state(cfg, params, steps_per_epoch=10)
    jstep = jax_make_train_step(jax_build_model(cfg.model), cfg, donate=False)
    model = _port_model(cfg, params)
    state = create_train_state(cfg, model, steps_per_epoch=10)
    step = make_train_step(model, cfg)
    h, w = cfg.data.image_size
    for i in range(3):
        js, jm = jstep(js, *map(jnp.asarray, batch), base)
        draws = step_draws(jax.random.fold_in(base, i), cfg, 2, (h // 16, w // 16))
        state, m = step(state, *map(_t, batch), draws=draws)
        for k in LOSSES:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    ref = bridge.state_dict_from_jax(jax.device_get(js.params), "tiny")
    for n, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[n], rtol=1e-5, atol=1e-7,
                                   err_msg=n)


def test_resume_is_bit_equal(tmp_path):
    """2 steps, save, restore into a fresh state, 2 steps == 4 straight
    steps: params and momentum bit for bit (the step's randomness comes
    from (seed, step) alone)."""
    cfg = replace_path(tiny_config(), "train.momentum_dtype", "bfloat16")
    rng = np.random.RandomState(9)
    batches = [list(map(_t, synthetic_batch(rng, cfg))) for _ in range(4)]

    def fresh(seed):
        model = build_model(cfg.model, cfg.anchors.num_anchors,
                            generator=torch.Generator().manual_seed(seed))
        return create_train_state(cfg, model, steps_per_epoch=3)

    state = fresh(0)
    step = make_train_step(state.model, cfg)
    for i, b in enumerate(batches):
        state, _ = step(state, *b)
        if i == 1:
            path = ckpt.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "ckpt_00000002.pth"
    assert ckpt.latest_step(str(tmp_path)) == 2

    resumed = ckpt.restore_checkpoint(str(tmp_path), fresh(1))
    assert resumed.step == 2
    step2 = make_train_step(resumed.model, cfg)
    for b in batches[2:]:
        resumed, _ = step2(resumed, *b)
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n in state.momentum:
        assert torch.equal(state.momentum[n], resumed.momentum[n]), n
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"session", "epoch", "step", "model", "optimizer",
                            "pooling_mode", "class_agnostic"}


def test_checkpoints_are_pruned_and_written_atomically(tmp_path):
    cfg = tiny_config()
    state = create_train_state(cfg, build_model(cfg.model))
    for s in range(ckpt.KEEP + 2):
        state.step = s
        ckpt.save_checkpoint(str(tmp_path), state)
    assert sorted(os.listdir(tmp_path)) == [
        f"ckpt_{s:08d}.pth" for s in range(2, ckpt.KEEP + 2)]
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), state)


def test_max_pool_backward_splits_ties_as_jax():
    """Planted ties (all four, two, none of a window's values equal the
    max): the cotangent splits evenly, exactly as JAX's custom vjp."""
    from scda_tpu.models.backbones.vgg import max_pool_2x2 as jax_pool

    x = np.random.RandomState(0).randn(2, 6, 8, 3).astype(np.float32)
    x[0, 0:2, 0:2, 0] = 1.5                     # 4-way tie
    x[0, 2, 2:4, 1] = 2.5                       # 2-way tie
    x[1, 4:6, 6:8, :] = 0.0                     # 4-way tie at zero
    g = np.random.RandomState(1).randn(2, 3, 4, 3).astype(np.float32)
    _, vjp = jax.vjp(jax_pool, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    y = tvgg.max_pool_2x2(xt)
    y.backward(_t(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jax_pool(jnp.asarray(x))))
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(), ref)
    assert ref[0, 0, 0, 0] == g[0, 0, 0, 0] / 4


def test_dropout_keeps_half_and_scales_by_two():
    x = torch.ones(64, 4096)
    y = tvgg.dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y > 0).float().mean()) - 0.5) < 0.01
    again = tvgg.dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


def test_check_train_config():
    """vgg16 unfrozen: refused on CUDA whatever stem_pallas says (K3 has
    no backward); on the CPU as JAX, refused only with stem_pallas."""
    cfg = replace_path(tiny_config(backbone="vgg16"),
                       "train.freeze_pretrained_layers", False)
    for stem in (True, False):
        with pytest.raises(ValueError):
            check_train_config(replace_path(cfg, "model.stem_pallas", stem),
                               torch.device("cuda"))
    with pytest.raises(ValueError):
        check_train_config(cfg, torch.device("cpu"))
    check_train_config(replace_path(cfg, "model.stem_pallas", False), "cpu")
    check_train_config(tiny_config(backbone="vgg16"), torch.device("cuda"))


def test_unfrozen_vgg_stem_trains_on_the_cpu():
    """With freezing off (and stem_pallas off, as JAX requires) the CPU
    stem runs the differentiable twin, so conv1_1 gets a gradient."""
    cfg = replace_path(tiny_config(backbone="vgg16"),
                       "train.freeze_pretrained_layers", False)
    cfg = replace_path(cfg, "model.stem_pallas", False)
    cfg = replace_path(cfg, "data.image_size", (64, 96))
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    state = create_train_state(cfg, model)
    assert state.tx.frozen == []
    x = torch.randn(1, 3, 32, 48)
    model.RCNN_base(x).sum().backward()
    assert model.RCNN_base[0].weight.grad.abs().max() > 0


def test_wrappers_refuse_to_drop_gradients():
    """Each kernel wrapper that launches outside autograd raises when
    grad mode is on and an input requires grad (here on their CPU
    paths, which share the check).  The stem's CPU path is its
    differentiable twin, so there it carries the gradient instead (the
    card's refusal is a ``gpu`` test)."""
    from scda_tpu_torch.ops.kernels import (
        bottleneck_kernel, nms_kernel, roi_align_kernel, stem_kernel,
    )

    boxes = torch.rand(1, 8, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="grad"):
        nms_kernel.nms_sorted(boxes, torch.ones(1, 8, dtype=torch.bool),
                              iou_threshold=0.5, max_output=4)
    k1 = torch.ones(3, 3, 3, 64, requires_grad=True)
    stem_kernel.vgg_stem_fused(torch.ones(1, 4, 4, 3), k1, torch.zeros(64),
                               torch.ones(3, 3, 64, 64), torch.zeros(64),
                               dtype=torch.float32).sum().backward()
    assert k1.grad.abs().max() > 0
    feat = torch.zeros(1, 4, 6, 8, requires_grad=True)
    wy, wx = torch.rand(1, 2, 3, 4), torch.rand(1, 2, 3, 6)
    with pytest.raises(RuntimeError, match="roi_align_contract"):
        roi_align_kernel.roi_align_contract_fwd(wy, wx, feat)
    with pytest.raises(RuntimeError, match="not differentiable"):
        roi_align_kernel.roi_align_contract(wy.requires_grad_(), wx, feat)
    x = torch.zeros(1, 2, 3, 64, requires_grad=True)
    ws = [torch.zeros(s) for s in ((1, 64, 16), (1, 1, 16), (1, 9, 16, 16),
                                   (1, 1, 16), (1, 16, 64), (1, 1, 64))]
    with pytest.raises(RuntimeError, match="bottleneck_chain"):
        bottleneck_kernel.bottleneck_chain_fwd(x, *ws)
    with torch.no_grad():   # outside grad mode the wrappers run
        nms_kernel.nms_sorted(boxes, torch.ones(1, 8, dtype=torch.bool),
                              iou_threshold=0.5, max_output=4)
        bottleneck_kernel.bottleneck_chain_fwd(x, *ws)


def test_cli_trains_and_test_net_evaluates(tmp_path):
    """trainval --dataset synthetic --steps 2 on the CPU writes a
    checkpoint; test_net --torch_checkpoint evaluates it."""
    from scda_tpu_torch.cli import test_net, trainval

    save = str(tmp_path / "models")
    rc = trainval.main([
        "--net", "tiny", "--device", "cpu", "--dataset", "synthetic",
        "--steps", "2", "--bs", "2", "--synth_images", "4",
        "--synth_size", "128", "192", "--save_dir", save,
        "--checkpoint_interval", "1", "--set",
        "train.proposal.pre_nms_top_n=200", "train.proposal.post_nms_top_n=50",
        "train.rpn_target.batch_size=64", "train.roi_target.batch_size=32",
        "anchors.scales=2,4,8",
    ])
    assert rc == 0
    run_dir = os.path.join(save, "tiny", "synthetic")
    assert ckpt.latest_step(run_dir) == 2
    assert os.path.exists(os.path.join(run_dir, "metrics.jsonl"))
    rc = test_net.main([
        "--net", "tiny", "--device", "cpu", "--synth_images", "2",
        "--synth_size", "128", "192", "--torch_checkpoint",
        os.path.join(run_dir, "ckpt_00000002.pth"), "--set",
        "test.proposal.pre_nms_top_n=200", "test.proposal.post_nms_top_n=50",
        "anchors.scales=2,4,8",
    ])
    assert rc == 0


@pytest.mark.parametrize("argv, why", [
    # --adapt is ported; without a target to adapt to it still exits 2.
    pytest.param(["--adapt", "--dataset", "cityscapes_train"],
                 "requires --target_dataset", id="argv0"),
    # --num_devices is ported; a batch that does not divide still exits 2.
    pytest.param(["--num_devices", "2", "--bs", "3"], "not divisible",
                 id="argv1"),
])
def test_cli_refuses_what_is_not_ported(argv, why, capsys):
    from scda_tpu_torch.cli import trainval

    assert trainval.main(["--device", "cpu", *argv]) == 2
    assert why in capsys.readouterr().err


def test_train_path_imports_no_jax(tmp_path):
    """The train modules, one tiny train step, and both CLIs' ``main`` on
    ``tiny`` load neither jax nor flax nor anything of the JAX package (a
    fresh interpreter: this one has them loaded)."""
    from test_torch_slice import NO_JAX_CODE, TINY_CONFIG_CODE

    save = str(tmp_path / "models")
    code = (
        "import os, sys, torch\n"
        "import numpy as np\n"
        + TINY_CONFIG_CODE +
        "import scda_tpu_torch.cli.trainval, scda_tpu_torch.train.checkpoint\n"
        "import scda_tpu_torch.cli.test_net\n"
        "from scda_tpu_torch.models.faster_rcnn import build_model\n"
        "from scda_tpu_torch.train.state import create_train_state\n"
        "from scda_tpu_torch.train.steps import make_train_step\n"
        "cfg = tiny_config()\n"
        "m = build_model(cfg.model, cfg.anchors.num_anchors)\n"
        "s = create_train_state(cfg, m)\n"
        "rng = np.random.RandomState(0)\n"
        "gt = np.zeros((2, 8, 5), np.float32)\n"
        "gt[:, 0] = [20.0, 30.0, 90.0, 100.0, 2.0]\n"
        "b = [torch.from_numpy(x) for x in (\n"
        "    rng.randn(2, 128, 192, 3).astype(np.float32) * 30,\n"
        "    np.tile(np.array([[128, 192, 1.0]], np.float32), (2, 1)),\n"
        "    gt, np.ones(2, np.int32))]\n"
        "s, met = make_train_step(m, cfg)(s, *b)\n"
        "assert bool(torch.isfinite(met['loss']))\n"
        f"save = {save!r}\n"
        "rc = scda_tpu_torch.cli.trainval.main([\n"
        "    '--net', 'tiny', '--device', 'cpu', '--dataset', 'synthetic',\n"
        "    '--steps', '1', '--bs', '2', '--synth_images', '4',\n"
        "    '--synth_size', '128', '192', '--save_dir', save,\n"
        "    '--checkpoint_interval', '1', '--set',\n"
        "    'train.proposal.pre_nms_top_n=200',\n"
        "    'train.proposal.post_nms_top_n=50',\n"
        "    'train.rpn_target.batch_size=64',\n"
        "    'train.roi_target.batch_size=32', 'anchors.scales=2,4,8'])\n"
        "assert rc == 0, rc\n"
        "rc = scda_tpu_torch.cli.test_net.main([\n"
        "    '--net', 'tiny', '--device', 'cpu', '--synth_images', '2',\n"
        "    '--synth_size', '128', '192', '--torch_checkpoint',\n"
        "    os.path.join(save, 'tiny', 'synthetic', 'ckpt_00000001.pth'),\n"
        "    '--set', 'test.proposal.pre_nms_top_n=200',\n"
        "    'test.proposal.post_nms_top_n=50', 'anchors.scales=2,4,8'])\n"
        "assert rc == 0, rc\n"
        + NO_JAX_CODE
    )
    env = {k: v for k, v in os.environ.items() if k != "SCDA_PLATFORM"}
    env["TMPDIR"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr

"""The SCDA adaptation path of the port against the JAX package, on the
CPU (f32): gradient reversal, k-means, region mining, the patch
discriminator, one and two adaptation steps under both schedules, and
the CLIs end to end.

Both packages get the same numpy inputs and the same weights (bridged).
The random streams differ, so wherever JAX draws (the k-means inits, the
target functions' uniforms) the test rebuilds JAX's draws from its key
chain and hands them to the port (``draws=``).

Differences by design, not held equal:
  * ``argmin`` / ``argmax`` take the first index on a tie in both
    packages, but only bit-equal distances tie: inputs here have no
    near-ties, and assignments and counts are then held exactly equal;
  * the centre update sums members in an order each compiler chooses
    (a matmul in XLA, an einsum here): centres to 1e-5.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import tiny_config
from scda_tpu.adapt import region_mining as jmine
from scda_tpu.core import grad_reverse as jgrl
from scda_tpu.core import kmeans as jkm
from scda_tpu.models.discriminator import PatchDiscriminator as JaxD
from scda_tpu_torch import bridge
from scda_tpu_torch.adapt.region_mining import mine_regions
from scda_tpu_torch.core.grad_reverse import grad_reverse, scaled_gradient
from scda_tpu_torch.core.kmeans import kmeans
from scda_tpu_torch.models.discriminator import PatchDiscriminator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _native_cpu_convolutions():
    # oneDNN's CPU conv backward is 2e-3 off for channels_last with a
    # bias (see test_torch_train.py); the card runs cuDNN.
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- GRL

@pytest.mark.parametrize("case", ["scale1", "scale0.3", "scaled_gradient"])
def test_grad_reverse_matches_jax(case):
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    if case == "scaled_gradient":
        jf, tf = (lambda v: jgrl.scaled_gradient(v, 0.7),
                  lambda v: scaled_gradient(v, 0.7))
    else:
        s = float(case[len("scale"):])
        jf, tf = (lambda v: jgrl.grad_reverse(v, s),
                  lambda v: grad_reverse(v, s))
    ref_y = jf(jnp.asarray(x))
    ref_g = jax.grad(lambda v: jnp.sum(jf(v) ** 2 * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = tf(xt)
    (y ** 2 * _t(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ref_y))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_g), rtol=1e-6)
    sign = 1.0 if case == "scaled_gradient" else -1.0
    assert np.sign(xt.grad.numpy()[0, 0]) == sign * np.sign(2 * x[0, 0] * w[0, 0])


# ------------------------------------------------------------- k-means

def jax_kmeans_draws(key, init, k, n):
    """The noise ``scda_tpu.core.kmeans`` draws from ``key``."""
    if init == "++":
        k0, k1 = jax.random.split(key)
        return {"g0": _t(jax.random.gumbel(k0, (n,))),
                "gs": _t(jax.random.gumbel(k1, (max(k - 1, 0), n)))}
    return {"u": _t(jax.random.uniform(key, (k,)))}


def _points(case, rng):
    n = 48
    pts = (rng.rand(n, 2) * np.array([192.0, 128.0])).astype(np.float32)
    mask = np.ones(n, bool)
    if case == "masked":
        mask = rng.rand(n) > 0.3
        pts[~mask] = 1e3
    elif case == "few_valid":       # fewer valid points than K
        mask[:] = False
        mask[[3, 17, 40]] = True
    elif case == "all_equal":
        pts[:] = [7.0, 9.0]
    return pts, mask


@pytest.mark.parametrize("keyed", [False, True], ids=["nokey", "keyed"])
@pytest.mark.parametrize("init", ["++", "spread"])
@pytest.mark.parametrize("case", ["plain", "masked", "few_valid", "all_equal"])
def test_kmeans_matches_jax(case, init, keyed):
    """Assignments and counts exactly equal (inputs without near-ties, or
    with exact ties, which both sides break toward the first index);
    centres to 1e-5."""
    k, iters = 5, 6
    pts, mask = _points(case, np.random.RandomState(11))
    key = jax.random.key(4) if keyed else None
    rc, ra, rn = jkm.kmeans(jnp.asarray(pts), k, mask=jnp.asarray(mask),
                            iters=iters, key=key, init=init)
    draws = jax_kmeans_draws(key, init, k, len(pts)) if keyed else None
    c, a, n = kmeans(_t(pts), k, mask=_t(mask), iters=iters, draws=draws,
                     init=init)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(n.numpy(), np.asarray(rn))
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), rtol=1e-5, atol=1e-5)
    assert int(n.sum()) == int(mask.sum())


def test_kmeans_batched_equals_per_image_and_generator_is_seeded():
    rng = np.random.RandomState(2)
    pts = _t((rng.rand(3, 40, 2) * 100).astype(np.float32))
    mask = _t(rng.rand(3, 40) > 0.2)
    c, a, n = kmeans(pts, 4, mask=mask, iters=5)
    for i in range(3):
        ci, ai, ni = kmeans(pts[i], 4, mask=mask[i], iters=5)
        assert torch.equal(a[i], ai) and torch.equal(n[i], ni)
        np.testing.assert_allclose(c[i].numpy(), ci.numpy(), rtol=1e-6)
    for init in ("++", "spread"):
        # iters=0 returns the init itself: Lloyd may well take two
        # inits to the same centres.
        runs = [kmeans(pts, 4, mask=mask, iters=0, init=init,
                       generator=torch.Generator().manual_seed(s))
                for s in (0, 0, 1)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert not torch.equal(runs[0][0], runs[2][0])
        assert all(int(r[2].sum()) == int(mask.sum()) for r in runs)
        assert all(bool(torch.isfinite(r[0]).all()) for r in runs)
    with pytest.raises(ValueError, match="init"):
        kmeans(pts, 4, init="grid")


def test_kmeans_and_mining_have_no_host_sync():
    """Neither module that must stay on the device calls anything that
    waits for it (``item``, ``tolist``, ``cpu``, ``numpy``, ``nonzero``,
    ``masked_select``, ``bool`` / ``int`` / ``float`` of a tensor), nor
    branches on a tensor: every ``if`` / ``while`` test and every call of
    ``int`` / ``bool`` / ``float`` names only Python values."""
    import ast

    banned = {"item", "tolist", "cpu", "numpy", "nonzero", "masked_select",
              "argwhere", "unique"}
    for rel in ("core/kmeans.py", "adapt/region_mining.py"):
        with open(os.path.join(REPO, "scda_tpu_torch", rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in banned, (rel, node.lineno, node.attr)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                assert node.func.id not in ("bool", "float", "int"), (
                    rel, node.lineno)
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                names = {n.id for n in ast.walk(node.test)
                         if isinstance(n, ast.Name)}
                assert names <= {"init", "single", "draws", "generator",
                                 "mask", "u", "g0", "n", "t"}, (
                    rel, node.lineno, names)
                calls = [n for n in ast.walk(node.test)
                         if isinstance(n, ast.Call)]
                assert not calls, (rel, node.lineno)


# -------------------------------------------------------------- mining

def mining_inputs(seed, b=3, n=40):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2) * np.array([150.0, 90.0])
    wh = 8 + rng.rand(b, n, 2) * 40
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.rand(b, n) > 0.25
    valid[1, 2:] = False          # two valid proposals: empty groups
    boxes[~valid] = 0.0
    return boxes, valid


def jax_mining_draws(key, b, init, k, n):
    per = [jax_kmeans_draws(kk, init, k, n) for kk in jax.random.split(key, b)]
    return {name: torch.stack([p[name] for p in per]) for name in per[0]}


@pytest.mark.parametrize("init", ["++", "spread"])
def test_mine_regions_matches_jax(init):
    cfg = dataclasses.replace(tiny_config().adapt, kmeans_init=init)
    boxes, valid = mining_inputs(5)
    key = jax.random.key(9)
    ref = jmine.mine_regions(jnp.asarray(boxes), jnp.asarray(valid), cfg, key)
    top_n = min(cfg.mining_top_n, boxes.shape[1])
    draws = jax_mining_draws(key, len(boxes), init, cfg.num_groups, top_n)
    out = mine_regions(_t(boxes), _t(valid), cfg, draws=draws)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.boxes.numpy(), np.asarray(ref.boxes))
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(ref.weights),
                               rtol=1e-6)
    assert not out.valid[1].all() and out.valid[0].any()
    assert torch.equal(out.boxes[~out.valid],
                       torch.zeros_like(out.boxes[~out.valid]))
    np.testing.assert_allclose(out.weights.sum(1).numpy(), 1.0, rtol=1e-6)


# ------------------------------------------------------- discriminator

def d_params_numpy(seed, cin, ch):
    rng = np.random.default_rng(seed)

    def conv(i, o):
        return {"kernel": (rng.standard_normal((3, 3, i, o))
                           * np.sqrt(2.0 / (9 * i))).astype(np.float32),
                "bias": (rng.standard_normal(o) * 0.1).astype(np.float32)}

    return {"conv1": conv(cin, ch), "conv2": conv(ch, ch),
            "conv3": conv(ch, ch),
            "fc": {"kernel": (rng.standard_normal((ch, 1))
                              / np.sqrt(ch)).astype(np.float32),
                   "bias": np.array([0.05], np.float32)}}


def port_discriminator(d_params, cin, ch):
    d = PatchDiscriminator(cin, ch)
    sd = bridge.discriminator_state_dict_from_jax(d_params)
    d.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return d


def test_discriminator_matches_jax():
    """Logits to 1e-5; gradients w.r.t. patches and parameters within
    1e-4 of each tensor's norm."""
    cin, ch = 12, 16
    dp = d_params_numpy(0, cin, ch)
    x = np.random.RandomState(3).randn(5, 7, 7, cin).astype(np.float32)
    w = np.random.RandomState(4).randn(5).astype(np.float32)
    jd = JaxD(channels=ch)

    def loss(p, v):
        return jnp.sum(jd.apply({"params": p}, v) * w)

    ref = jd.apply({"params": dp}, jnp.asarray(x))
    gp, gx = jax.grad(loss, argnums=(0, 1))(dp, jnp.asarray(x))
    d = port_discriminator(dp, cin, ch)
    xt = _t(x).requires_grad_()
    out = d(xt)
    assert out.shape == (5,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    (out * _t(w)).sum().backward()
    gsd = bridge.discriminator_state_dict_from_jax(jax.device_get(gp))
    pairs = [("patches", xt.grad.numpy(), np.asarray(gx))]
    pairs += [(n, p.grad.numpy(), gsd[n]) for n, p in d.named_parameters()]
    assert len(pairs) == 9
    for n, got, want in pairs:
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), n


def test_init_discriminator_channels_and_seed():
    from scda_tpu.config import replace_path
    from scda_tpu_torch.adapt.scda import init_discriminator

    for backbone, c in (("vgg16", 512), ("tiny", 64), ("resnet101", 1024)):
        cfg = replace_path(tiny_config(), "model.backbone", backbone)
        cfg = replace_path(cfg, "adapt.d_channels", 8)
        d = init_discriminator(cfg, torch.Generator().manual_seed(1))
        assert d.conv1.weight.shape == (8, c, 3, 3)
        assert float(d.conv1.bias.abs().max()) == 0.0
        std = float(d.conv1.weight.std())
        assert abs(std - (9 * c) ** -0.5) < 0.15 * (9 * c) ** -0.5
    again = init_discriminator(cfg, torch.Generator().manual_seed(1))
    assert torch.equal(d.fc.weight, again.fc.weight)


# ------------------------------------------------------- the SCDA step

from scda_tpu.adapt import scda as jscda                      # noqa: E402
from scda_tpu.config import replace_path                      # noqa: E402
from scda_tpu.models.faster_rcnn import build_model as jax_build_model  # noqa: E402
from scda_tpu.train import state as jstate                    # noqa: E402
from scda_tpu_torch.adapt import scda as tscda                # noqa: E402
from scda_tpu_torch.train.state import create_train_state     # noqa: E402
from scda_tpu_torch.train.steps import scda_step_generators   # noqa: E402
from test_torch_slice import _dense                           # noqa: E402
from test_torch_train import (                                # noqa: E402
    _port_model, step_draws, train_batch, train_params,
)

D_CH = 16
METRICS = ("loss", "rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "adv",
           "adv_src", "adv_tgt", "d_acc")
CASES = {  # name: (d_update, class-agnostic car-only)
    "joint": ("joint", False),
    "alternating": ("alternating", False),
    "car_alternating": ("alternating", True),
}


def scda_config(case):
    d_update, car = CASES[case]
    cfg = tiny_config(num_classes=2 if car else 5, adapt=True)
    cfg = replace_path(cfg, "model.class_agnostic", car)
    cfg = replace_path(cfg, "adapt.d_update", d_update)
    return replace_path(cfg, "adapt.d_channels", D_CH)


def scda_inputs(cfg):
    params = train_params("tiny", cfg, seed=3)
    if cfg.model.class_agnostic:
        tree = _dense(np.random.default_rng(8), 128, 4)
        tree["kernel"] = tree["kernel"] * np.float32(
            0.001 / tree["kernel"].std())
        params["bbox_pred"] = tree
    src = train_batch(4, cfg)
    tgt_image, tgt_info, _, _ = train_batch(5, cfg)
    return params, d_params_numpy(6, 64, D_CH), src, (tgt_image, tgt_info)


def scda_draws(key, cfg, b):
    """Every draw JAX's ``_scda_parts`` makes from the step key."""
    k_det, k_s, k_t = jax.random.split(key, 3)
    h, w = cfg.data.image_size
    draws = step_draws(k_det, cfg, b, (h // 16, w // 16))
    ac = cfg.adapt
    n = min(ac.mining_top_n, cfg.train.proposal.post_nms_top_n)
    draws["mine_src"] = jax_mining_draws(k_s, b, ac.kmeans_init,
                                         ac.num_groups, n)
    draws["mine_tgt"] = jax_mining_draws(k_t, b, ac.kmeans_init,
                                         ac.num_groups, n)
    return draws


def port_scda_grads(cfg, model, d_model, src, tgt, draws):
    """(metrics, detector grads, discriminator grads) of one port forward."""
    forward = (tscda.scda_forward if cfg.adapt.d_update == "joint"
               else tscda.scda_forward_alternating)
    total, metrics = forward(model, d_model, tuple(map(_t, src)),
                             *map(_t, tgt), cfg,
                             scda_step_generators(0, 0, "cpu"), draws)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in model.named_parameters() if p.requires_grad]
    d_names, d_params = zip(*d_model.named_parameters())
    grads = torch.autograd.grad(total, [*params, *d_params],
                                materialize_grads=True)
    return ({k: float(v) for k, v in metrics.items()},
            dict(zip(names, grads[:len(names)])),
            dict(zip(d_names, grads[len(names):])))


@pytest.fixture(scope="module", params=list(CASES))
def scda_run(request):
    """One SCDA forward + backward in both packages."""
    cfg = scda_config(request.param)
    params, dp, src, tgt = scda_inputs(cfg)
    key = jax.random.key(5)
    jm = jax_build_model(cfg.model, num_anchors=cfg.anchors.num_anchors)
    jd = JaxD(channels=D_CH)
    jforward = (jscda.scda_forward if cfg.adapt.d_update == "joint"
                else jscda.scda_forward_alternating)

    def loss_fn(p, d, src_b, ti, tinfo):
        return jforward(jm, jd, p, d, src_b, ti, tinfo, cfg, key)

    (_, jmetrics), (jg, jgd) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
            params, dp, tuple(map(jnp.asarray, src)), *map(jnp.asarray, tgt))

    model = _port_model(cfg, params)
    create_train_state(cfg, model)
    d_model = port_discriminator(dp, 64, D_CH)
    draws = scda_draws(key, cfg, 2)
    metrics, grads, d_grads = port_scda_grads(cfg, model, d_model, src, tgt,
                                              draws)
    return dict(case=request.param, cfg=cfg, params=params, dp=dp, src=src,
                tgt=tgt, draws=draws, jmetrics=jax.device_get(jmetrics),
                jgrads=bridge.state_dict_from_jax(jax.device_get(jg), "tiny"),
                jd_grads=bridge.discriminator_state_dict_from_jax(
                    jax.device_get(jgd)),
                metrics=metrics, grads=grads, d_grads=d_grads)


def test_scda_metrics_match_jax(scda_run):
    m, ref = scda_run["metrics"], scda_run["jmetrics"]
    names = METRICS + (("d_loss",) if "alternating" in scda_run["case"] else ())
    assert set(names) | {"fg_cnt", "bg_cnt"} == set(m) == set(ref)
    for k in names:
        np.testing.assert_allclose(m[k], float(ref[k]), rtol=1e-4, err_msg=k)
    assert m["fg_cnt"] == float(ref["fg_cnt"]) > 0
    assert m["adv"] > 0


def test_scda_gradients_match_jax(scda_run):
    """Detector and discriminator gradients within 1e-4 of each tensor's
    norm (see test_torch_train.py for why not elementwise)."""
    for grads, ref in ((scda_run["grads"], scda_run["jgrads"]),
                       (scda_run["d_grads"], scda_run["jd_grads"])):
        assert len(grads) >= 8
        for n, g in grads.items():
            err = np.linalg.norm(g.numpy() - ref[n])
            assert err <= 1e-4 * np.linalg.norm(ref[n]), (n, err)
            assert np.linalg.norm(ref[n]) > 0, n


def _port_grads(run, **adapt):
    cfg = run["cfg"]
    for k, v in adapt.items():
        cfg = replace_path(cfg, f"adapt.{k}", v)
    model = _port_model(cfg, run["params"])
    d_model = port_discriminator(run["dp"], 64, D_CH)
    return port_scda_grads(cfg, model, d_model, run["src"], run["tgt"],
                           run["draws"])


def test_scda_adversarial_gradient_signs_and_scales(scda_run):
    """The detector's adversarial gradient (total minus detection-only)
    flips sign with ``grl_weight`` under the joint schedule; the
    discriminator's gradient scales with ``adv_weight`` there, and under
    the alternating schedule does not depend on it (the G loss sees a
    frozen D, the D loss detached patches)."""
    joint = scda_run["cfg"].adapt.d_update == "joint"
    _, g0, _ = _port_grads(scda_run, adv_weight=0.0)
    _, g_pos, d_pos = scda_run["grads"], scda_run["grads"], scda_run["d_grads"]
    _, g_big, d_big = _port_grads(scda_run, adv_weight=0.3)
    name = "RCNN_base.9.weight"      # the last backbone conv of ``tiny``
    adv_pos = g_pos[name] - g0[name]
    assert float(adv_pos.abs().max()) > 0
    if joint:
        _, g_neg, _ = _port_grads(scda_run, grl_weight=-1.0)
        adv_neg = g_neg[name] - g0[name]
        np.testing.assert_allclose(adv_neg.numpy(), -adv_pos.numpy(),
                                   rtol=1e-3, atol=1e-6 * float(
                                       adv_pos.abs().max()) + 1e-9)
        for n in d_pos:
            np.testing.assert_allclose(d_big[n].numpy(), 3.0 * d_pos[n].numpy(),
                                       rtol=1e-4, atol=1e-9)
    else:
        for n in d_pos:
            np.testing.assert_allclose(d_big[n].numpy(), d_pos[n].numpy(),
                                       rtol=1e-5, atol=1e-9)
        # adv_weight=0: the detector sees the detection loss alone.
        cfg0 = replace_path(scda_run["cfg"], "adapt.d_update", "joint")
        run0 = dict(scda_run, cfg=cfg0)
        _, g_det, _ = _port_grads(run0, adv_weight=0.0)
        for n in g0:
            np.testing.assert_allclose(g0[n].numpy(), g_det[n].numpy(),
                                       rtol=1e-5, atol=1e-9)
    # The rpn head of the target tower gets no adversarial gradient.
    rpn = "RCNN_rpn.RPN_Conv.weight"
    np.testing.assert_allclose(g_pos[rpn].numpy(), g0[rpn].numpy(),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("case", ["joint", "car_alternating"])
def test_two_scda_steps_match_jax(case):
    """Two whole steps through ``make_scda_train_step`` on both sides,
    with JAX's per-step draws: metrics, then the parameters of both
    networks."""
    cfg = scda_config(case)
    params, dp, src, tgt = scda_inputs(cfg)
    base = jax.random.key(8)
    jm = jax_build_model(cfg.model, num_anchors=cfg.anchors.num_anchors)
    jd = JaxD(channels=D_CH)
    js = jscda.create_scda_state(
        cfg, jstate.create_train_state(cfg, params, steps_per_epoch=10), dp)
    jstep = jscda.make_scda_train_step(jm, jd, cfg, donate=False)

    model = _port_model(cfg, params)
    d_model = port_discriminator(dp, 64, D_CH)
    state = tscda.create_scda_state(
        cfg, create_train_state(cfg, model, steps_per_epoch=10), d_model)
    step = tscda.make_scda_train_step(model, d_model, cfg)
    names = METRICS + (("d_loss",) if "alternating" in case else ())
    for i in range(2):
        js, jmet = jstep(js, *map(jnp.asarray, src), *map(jnp.asarray, tgt),
                         base)
        draws = scda_draws(jax.random.fold_in(base, i), cfg, 2)
        state, met = step(state, *map(_t, src), *map(_t, tgt), draws=draws)
        for k in names:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert state.step == 2 == int(js.step)
    ref = bridge.state_dict_from_jax(jax.device_get(js.det.params), "tiny")
    for n, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[n], rtol=1e-5, atol=1e-7,
                                   err_msg=n)
    ref_d = bridge.discriminator_state_dict_from_jax(
        jax.device_get(js.d_params))
    for n, v in d_model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_d[n], rtol=1e-5, atol=1e-7,
                                   err_msg=n)
        assert float(state.d_momentum[n].abs().max()) > 0


def test_unknown_d_update_raises():
    cfg = replace_path(scda_config("joint"), "adapt.d_update", "sometimes")
    model = _port_model(cfg, train_params("tiny", cfg, seed=3))
    with pytest.raises(ValueError, match="d_update"):
        tscda.make_scda_train_step(model, PatchDiscriminator(64, D_CH), cfg)


def test_zero_weight_groups_give_exactly_zero_gradient():
    """An invalid group has a zeroed box (pooled from a 1x1 roi at the
    map's origin) and weight 0: its patch takes part in the forward, and
    its gradient into the features is exactly 0, not NaN, also when its
    logit is extreme."""
    from scda_tpu_torch.models.faster_rcnn import pool_rois

    cfg = scda_config("joint")
    feat = (torch.randn(1, 8, 12, 64) * 50).requires_grad_()
    boxes = torch.zeros(1, 4, 4)                       # all four zeroed
    patches = pool_rois(feat, boxes, None, cfg.model, output_size=7)
    d = PatchDiscriminator(64, D_CH)
    loss, acc = tscda._weighted_bce(d(patches.float()) * 1e4,
                                    torch.zeros(4), torch.zeros(4, dtype=bool), 1)
    (g,) = torch.autograd.grad(loss, feat)
    assert float(loss) == 0.0 and float(acc) == 0.0
    assert torch.equal(g, torch.zeros_like(g))
    # One valid group beside them: only its pixels get gradient.
    boxes[0, 0] = torch.tensor([64.0, 32.0, 160.0, 96.0])
    patches = pool_rois(feat, boxes, None, cfg.model, output_size=7)
    w = torch.tensor([1.0, 0, 0, 0])
    loss, _ = tscda._weighted_bce(d(patches.float()), w, w > 0, 0)
    (g,) = torch.autograd.grad(loss, feat)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert float(g[0, :2, :4].abs().max()) == 0.0      # rows 0-1: origin only
    assert float(g[0, 0, 0].abs().max()) == 0.0


# ------------------------------------------------------------ the CLIs

SMALL = ["train.proposal.pre_nms_top_n=200", "train.proposal.post_nms_top_n=50",
         "train.rpn_target.batch_size=64", "train.roi_target.batch_size=32",
         "test.proposal.pre_nms_top_n=200", "test.proposal.post_nms_top_n=50",
         "anchors.scales=2,4,8", "adapt.num_groups=4", "adapt.mining_top_n=32",
         "adapt.kmeans_iters=4", "adapt.d_channels=16"]


def _train(save, *extra, steps=2, sets=()):
    from scda_tpu_torch.cli import trainval

    return trainval.main([
        "--net", "tiny", "--device", "cpu", "--dataset", "synthetic",
        "--steps", str(steps), "--bs", "2", "--synth_images", "4",
        "--synth_size", "128", "192", "--save_dir", save,
        "--checkpoint_interval", "1", *extra, "--set", *SMALL, *sets])


def _eval(load, *extra):
    from scda_tpu_torch.cli import test_net

    return test_net.main([
        "--net", "tiny", "--device", "cpu", "--synth_images", "2",
        "--synth_size", "128", "192", "--load_dir", load, *extra])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Source-only for two steps, then ``--adapt --init_from`` it: four
    steps straight, and two steps plus ``--r`` for two more."""
    root = tmp_path_factory.mktemp("scda_cli")
    src, straight, resumed = (str(root / n) for n in ("src", "a", "b"))
    assert _train(src) == 0
    init = ["--adapt", "--init_from", os.path.join(src, "tiny", "synthetic")]
    assert _train(straight, *init, steps=4) == 0
    assert _train(resumed, *init, steps=2) == 0
    assert _train(resumed, "--adapt", "--r", steps=4) == 0
    return dict(src=src, straight=straight, resumed=resumed)


def test_cli_adapts_and_resumes_bit_equal(cli_runs):
    import json

    from scda_tpu_torch.train import checkpoint as ckpt

    dirs = {k: os.path.join(v, "tiny", "synthetic") for k, v in cli_runs.items()}
    with open(os.path.join(dirs["straight"], "config.json")) as f:
        meta = json.load(f)
    assert meta["state_kind"] == "scda" and meta["config"]["adapt"]["enabled"]
    with open(os.path.join(dirs["src"], "config.json")) as f:
        assert json.load(f)["state_kind"] == "det"
    a = ckpt.load_payload(dirs["straight"], 4)
    b = ckpt.load_payload(dirs["resumed"], 4)
    # The detector's dict plus the discriminator and its momentum.
    assert set(a) == set(ckpt.load_payload(dirs["src"], 2)) | {
        "discriminator", "d_momentum"}
    for part in ("model", "discriminator", "d_momentum"):
        assert set(a[part]) == set(b[part])
        for n in a[part]:
            assert torch.equal(a[part][n], b[part][n]), (part, n)
    for n, v in a["optimizer"]["momentum"].items():
        assert torch.equal(v, b["optimizer"]["momentum"][n]), n
    # --init_from reset the step and carried the source-only weights in:
    # step 1 of adaptation differs from the source run's step 2 weights.
    first = ckpt.load_payload(dirs["straight"], 1)
    src = ckpt.load_payload(dirs["src"], 2)
    assert not torch.equal(first["model"]["RCNN_base.9.weight"],
                           src["model"]["RCNN_base.9.weight"])
    assert float(first["discriminator"]["conv1.weight"].std()) > 0
    lines = open(os.path.join(dirs["straight"], "metrics.jsonl")).read()
    assert '"adv"' in lines and '"d_acc"' in lines


def test_test_net_load_dir_evaluates_scda_checkpoint(cli_runs, capsys):
    assert _eval(cli_runs["straight"]) == 0
    out = capsys.readouterr()
    assert "loaded SCDA checkpoint step 4" in out.out
    assert "mAP@0.5" in out.out and "align_legacy" not in out.err
    assert _eval(cli_runs["straight"], "--checkpoint_step", "1") == 0
    assert "step 1 " in capsys.readouterr().out
    assert _eval(cli_runs["src"], "--synth_fog", "0.5") == 0
    out = capsys.readouterr()
    assert "loaded checkpoint step 2" in out.out
    with pytest.raises(FileNotFoundError):
        _eval(cli_runs["straight"], "--checkpoint_step", "0")


def test_align_legacy_note_only_for_reference_files(cli_runs, tmp_path, capsys):
    """The port's own checkpoint given by path gets no ``align_legacy``
    note (it was trained with ``align``); a reference-layout file does."""
    from scda_tpu_torch.train import checkpoint as ckpt

    run = os.path.join(cli_runs["src"], "tiny", "synthetic")
    own = os.path.join(run, "ckpt_00000002.pth")
    sets = ["--set", "anchors.scales=2,4,8",
            "test.proposal.pre_nms_top_n=200", "test.proposal.post_nms_top_n=50"]
    assert _eval("none", "--torch_checkpoint", own, *sets) == 0
    assert "align_legacy" not in capsys.readouterr().err
    payload = ckpt.load_payload(run, 2)
    assert ckpt.is_port_checkpoint(payload)
    ref = str(tmp_path / "reference.pth")
    torch.save({"model": payload["model"], "pooling_mode": "align",
                "optimizer": {"state": {}, "param_groups": []}}, ref)
    assert _eval("none", "--torch_checkpoint", ref, *sets) == 0
    assert "align_legacy" in capsys.readouterr().err


def test_load_dir_restores_a_non_default_architecture(tmp_path, capsys):
    """Trained with ``model.multiscale_roi`` and a class-agnostic head on
    one class: ``--load_dir`` rebuilds both from config.json, with no
    ``--set model.*`` and no ``--synth_classes`` repeated."""
    save = str(tmp_path / "m")
    assert _train(save, "--synth_classes", "redbox", sets=[
        "model.multiscale_roi=true", "model.class_agnostic=true",
        "model.ms_fine_threshold=32"]) == 0
    capsys.readouterr()
    assert _eval(save) == 0
    out = capsys.readouterr().out
    assert "architecture from" in out and "loaded checkpoint step 2" in out
    assert "AP@0.5 redbox" in out and "greenbox" not in out
    # Without the recorded config the same weights do not fit.
    os.unlink(os.path.join(save, "tiny", "synthetic", "config.json"))
    with pytest.raises(RuntimeError, match="RCNN_c3_proj|size mismatch"):
        _eval(save)


def test_adapt_needs_a_target(capsys):
    from scda_tpu_torch.cli import trainval

    rc = trainval.main(["--device", "cpu", "--adapt", "--dataset",
                        "pascal_voc_2007_trainval"])
    assert rc == 2 and "--target_dataset" in capsys.readouterr().err
    args = trainval.parse_args(["--cfg_file",
                                os.path.join(REPO, "cfgs/scda_sim10k_car.yml")])
    cfg = trainval.build_config(args)
    assert args.adapt and cfg.adapt.d_update == "alternating"
    assert cfg.model.class_agnostic and trainval.target_name(args) == (
        "synthetic_foggy")


def test_adapt_cli_imports_no_jax(tmp_path):
    """``trainval --adapt`` with a ``dir:`` target and ``test_net
    --load_dir`` in a fresh interpreter load neither jax nor flax nor
    anything of the JAX package."""
    from PIL import Image
    from test_torch_slice import NO_JAX_CODE

    tgt = tmp_path / "target_images"
    tgt.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (128, 192, 3), np.uint8)).save(
            str(tgt / f"{i}.png"))
    save = str(tmp_path / "models")
    code = (
        "import sys\n"
        "from scda_tpu_torch.cli import test_net, trainval\n"
        f"sets = {SMALL!r}\n"
        "rc = trainval.main([\n"
        "    '--net', 'tiny', '--device', 'cpu', '--dataset', 'synthetic',\n"
        f"    '--adapt', '--target_dataset', 'dir:{tgt}', '--steps', '1',\n"
        "    '--bs', '2', '--synth_images', '4', '--synth_size', '128', '192',\n"
        f"    '--save_dir', {save!r}, '--checkpoint_interval', '1',\n"
        "    '--set', 'adapt.d_update=alternating', *sets])\n"
        "assert rc == 0, rc\n"
        "rc = test_net.main(['--net', 'tiny', '--device', 'cpu',\n"
        "    '--synth_images', '2', '--synth_size', '128', '192',\n"
        f"    '--load_dir', {save!r}])\n"
        "assert rc == 0, rc\n"
        + NO_JAX_CODE
    )
    env = {k: v for k, v in os.environ.items() if k != "SCDA_PLATFORM"}
    env["TMPDIR"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
    assert "target=target_images (3 images)" in r.stdout

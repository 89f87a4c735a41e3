"""ResNet modules of the port against the JAX package's flax modules, on
the CPU: FrozenBatchNorm2d, Bottleneck (stride 1 and 2, with and without
the downsample), ResNetStage at narrow widths (its identity tail through
the K4 twin), the C4 head, ``init_weights`` on ResNet-101 and the
reference-checkpoint loader.

Both sides get the same numbers, drawn with numpy and bridged.
Tolerances: f32 rtol=atol=1e-5 per module (summation order only), 1e-4
for a stage (the chain folds each BatchNorm into its conv, which moves
one rounding per conv) and for the head; bf16 rtol=atol=1e-2 (XLA may
skip intermediate bf16 roundings that PyTorch makes).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scda_tpu.models.backbones import resnet as jres
from scda_tpu_torch import bridge
from scda_tpu_torch.models.backbones import resnet as tres

F32 = np.float32


def conv_tree(rng, k, cin, cout):
    w = rng.standard_normal((k, k, cin, cout), dtype=F32)
    return {"kernel": w * F32(np.sqrt(2.0 / (k * k * cin)))}


def bn_tree(rng, ch, damp=1.0):
    """Near-identity frozen statistics; ``damp`` scales the weight (0.1
    on bn3 keeps a deep net's residual adds from growing without bound)."""
    return {"scale": (rng.random(ch, dtype=F32) + F32(0.5)) * F32(damp),
            "bias": rng.standard_normal(ch, dtype=F32) * F32(0.05),
            "mean": rng.standard_normal(ch, dtype=F32) * F32(0.05),
            "var": rng.random(ch, dtype=F32) + F32(0.5)}


def block_tree(rng, cin, f, downsample):
    t = {"conv1": conv_tree(rng, 1, cin, f), "bn1": bn_tree(rng, f),
         "conv2": conv_tree(rng, 3, f, f), "bn2": bn_tree(rng, f),
         "conv3": conv_tree(rng, 1, f, 4 * f), "bn3": bn_tree(rng, 4 * f, 0.1)}
    if downsample:
        t["downsample_conv"] = conv_tree(rng, 1, cin, 4 * f)
        t["downsample_bn"] = bn_tree(rng, 4 * f)
    return t


def stage_tree(rng, cin, f, n):
    return {f"block{i}": block_tree(rng, cin if i == 0 else 4 * f, f, i == 0)
            for i in range(n)}


def head_tree(rng, depth):
    """The flax C4 head's param tree (layer4) at full width."""
    return {"layer4": stage_tree(rng, 1024, 512, jres.RESNET_DEPTHS[depth][3])}


def resnet_trees(rng, depth):
    """(backbone, head) flax param trees of a ResNet at full width."""
    n = jres.RESNET_DEPTHS[depth]
    backbone = {"conv1": conv_tree(rng, 7, 3, 64), "bn1": bn_tree(rng, 64),
                "layer1": stage_tree(rng, 64, 64, n[0]),
                "layer2": stage_tree(rng, 256, 128, n[1]),
                "layer3": stage_tree(rng, 512, 256, n[2])}
    return backbone, head_tree(rng, depth)


def _load(module, tree):
    """A flax stage (``block{i}`` keys) or block tree into ``module``."""
    sd = {}
    if "conv1" in tree:
        bridge.resnet_block(sd, "x", tree)
    else:
        for name, blk in tree.items():
            bridge.resnet_block(sd, f"x.{name[len('block'):]}", blk)
    module.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()})
    return module


def _nhwc(x_nchw):
    return x_nchw.permute(0, 2, 3, 1).float().numpy()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_bn_matches_flax(dtype):
    rng = np.random.default_rng(0)
    p = bn_tree(rng, 48)
    x = rng.standard_normal((2, 5, 7, 48), dtype=F32) * F32(3.0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jres.FrozenBatchNorm(48, dtype=jdt).apply(
        {"params": p}, jnp.asarray(x).astype(jdt))
    bn = tres.FrozenBatchNorm2d(48)
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(p["mean"]),
                        "running_var": torch.from_numpy(p["var"])})
    out = bn(_nchw(x).to(tdt))
    assert out.dtype == tdt
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean",
                                    "running_var"}
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref, F32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,f,stride,downsample", [
    (64, 16, 1, False), (32, 16, 1, True), (64, 32, 2, True),
])
def test_bottleneck_matches_flax(dtype, cin, f, stride, downsample):
    rng = np.random.default_rng(cin + f + stride)
    tree = block_tree(rng, cin, f, downsample)
    x = rng.standard_normal((2, 9, 10, cin), dtype=F32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jres.Bottleneck(f, stride=stride, downsample=downsample,
                          dtype=jdt).apply({"params": tree}, jnp.asarray(x))
    mod = _load(tres.Bottleneck(cin, f, stride, downsample, dtype=tdt), tree)
    with torch.no_grad():
        out = mod(_nchw(x))
    assert out.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref, F32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("cin,f,stride", [(32, 16, 1), (64, 32, 2)])
def test_stage_matches_flax_stage(cin, f, stride):
    """Block0 per block, the identity tail folded through the K4 twin,
    against the flax stage's per-block path."""
    rng = np.random.default_rng(f)
    tree = stage_tree(rng, cin, f, 3)
    x = rng.standard_normal((2, 11, 14, cin), dtype=F32)
    ref = jres.ResNetStage(f, 3, stride, dtype=jnp.float32).apply(
        {"params": tree}, jnp.asarray(x))
    stage = _load(tres.ResNetStage(cin, f, 3, stride, torch.float32), tree)
    with torch.no_grad():
        out = stage(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("head_matmul", [False, True])
def test_c4_head_matches_flax(head_matmul):
    """layer4 + spatial mean on (R, 7, 7, 1024) pooled rois, against
    both of JAX's lowerings (``head_matmul``, which the port ignores)."""
    rng = np.random.default_rng(3)
    head = head_tree(rng, 50)
    pooled = rng.standard_normal((3, 7, 7, 1024), dtype=F32)
    ref = jax.jit(lambda p, x: jres.ResNetC4Head(
        depth=50, dtype=jnp.float32, matmul=head_matmul).apply(
            {"params": p}, x))(head, jnp.asarray(pooled))
    mod = tres.ResNetC4Head(50, torch.float32)
    _load(mod[0], head["layer4"])
    with torch.no_grad():
        out = mod(torch.from_numpy(pooled))
    assert out.shape == (3, 2048)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_init_weights_builds_resnet101():
    """init_weights on ResNet-101: convs without bias, seeded frozen
    statistics with bn3 damped; features finite and not constant."""
    from helpers import tiny_config
    from scda_tpu.config import replace_path
    from scda_tpu_torch.models.faster_rcnn import build_model, init_weights

    cfg = replace_path(tiny_config(num_classes=9), "model.backbone",
                       "resnet101")
    model = build_model(cfg.model, cfg.anchors.num_anchors)
    init_weights(model, torch.Generator().manual_seed(1), input_scale=1 / 64)
    bn3 = model.RCNN_base[6][5].bn3.weight
    bn2 = model.RCNN_base[6][5].bn2.weight
    assert float(bn3.max()) < 0.15 and float(bn2.min()) >= 0.5
    image = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 64, 96, 3), dtype=F32)
        * F32(50.0))
    with torch.no_grad():
        feat = model.features(image)
    assert feat.shape == (1, 4, 6, 1024)
    assert bool(torch.isfinite(feat).all())
    assert float(feat.std()) > 1e-2
    assert float((feat - feat.mean(dim=(1, 2), keepdim=True)).abs().max()) > 1e-2


def test_reference_checkpoint_drops_num_batches_tracked(tmp_path):
    """A torchvision-lineage ResNet .pth carries BatchNorm's
    ``num_batches_tracked``; the loader drops it and loads the rest."""
    from helpers import tiny_config
    from scda_tpu.config import replace_path
    from scda_tpu_torch.models.faster_rcnn import build_model

    cfg = replace_path(tiny_config(num_classes=9), "model.backbone",
                       "resnet50")
    src = build_model(cfg.model, cfg.anchors.num_anchors,
                      generator=torch.Generator().manual_seed(2))
    sd = dict(src.state_dict())
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "res50.pth")
    torch.save({"model": sd}, path)
    fresh = build_model(cfg.model, cfg.anchors.num_anchors,
                        generator=torch.Generator().manual_seed(3))
    bridge.load_reference_checkpoint(fresh, path)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k

"""Weights between the JAX package and the port.

:func:`state_dict_from_jax` turns a JAX params tree (nested dicts of
numpy arrays, the layout ``scda_tpu.models.faster_rcnn.init_params``
returns) into the port's state dict:

  * ``vgg16`` reproduces ``scda_tpu.train.torch_convert.
    export_reference_detector``: HWIO -> OIHW conv kernels, (in, out) ->
    (out, in) linears, and the RPN cls channels permuted from the JAX
    head's anchor-major ``a * 2 + c`` to the reference's class-major
    ``c * A + a``;
  * ``resnet50/101/152`` reproduce the exporter too: conv1/bn1 ->
    ``RCNN_base.0/.1``, layer1..3 -> ``RCNN_base.4/.5/.6.{block}``,
    layer4 -> ``RCNN_top.0.{block}``, each FrozenBatchNorm's scale, bias,
    mean and var -> ``weight``, ``bias``, ``running_mean``,
    ``running_var``;
  * ``tiny`` maps the same way (the exporter raises on it): convs
    ``conv0..3`` -> ``RCNN_base.{0,3,6,9}``, ``head/fc`` -> ``RCNN_top.0``.

With ``multiscale_roi`` params, ``c3_proj`` (which the reference lineage
does not have, so the exporter leaves it out) maps to ``RCNN_c3_proj``.

:func:`discriminator_state_dict_from_jax` does the same for the SCDA
patch discriminator's flax tree (``conv1..3``, ``fc``).

:func:`load_reference_checkpoint` loads a reference-layout ``.pth``
(``{'model': state_dict}`` or a bare state dict) with
``weights_only=True`` unless ``allow_unsafe_pickle``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from scda_tpu_torch.models.backbones.resnet import RESNET_DEPTHS
from scda_tpu_torch.models.backbones.vgg import VGG16_LAYOUT

_TINY_CONV_INDEX = {0: 0, 1: 3, 2: 6, 3: 9}


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _conv(k_hwio) -> np.ndarray:
    return np.transpose(_f32(k_hwio), (3, 2, 0, 1))


def _linear(k_in_out) -> np.ndarray:
    return np.transpose(_f32(k_in_out), (1, 0))


def _bn(sd, prefix, p) -> None:
    sd[f"{prefix}.weight"] = _f32(p["scale"])
    sd[f"{prefix}.bias"] = _f32(p["bias"])
    sd[f"{prefix}.running_mean"] = _f32(p["mean"])
    sd[f"{prefix}.running_var"] = _f32(p["var"])


def resnet_block(sd, prefix, p) -> None:
    """One flax ``Bottleneck`` tree -> ``{prefix}.conv1.weight`` ..."""
    for i in (1, 2, 3):
        sd[f"{prefix}.conv{i}.weight"] = _conv(p[f"conv{i}"]["kernel"])
        _bn(sd, f"{prefix}.bn{i}", p[f"bn{i}"])
    if "downsample_conv" in p:
        sd[f"{prefix}.downsample.0.weight"] = _conv(
            p["downsample_conv"]["kernel"])
        _bn(sd, f"{prefix}.downsample.1", p["downsample_bn"])


def _resnet(sd, params, depth) -> None:
    blocks = RESNET_DEPTHS[depth]
    sd["RCNN_base.0.weight"] = _conv(params["backbone"]["conv1"]["kernel"])
    _bn(sd, "RCNN_base.1", params["backbone"]["bn1"])
    for li, n in enumerate(blocks[:3], start=1):
        for bi in range(n):
            resnet_block(sd, f"RCNN_base.{li + 3}.{bi}",
                         params["backbone"][f"layer{li}"][f"block{bi}"])
    for bi in range(blocks[3]):
        resnet_block(sd, f"RCNN_top.0.{bi}",
                     params["head"]["layer4"][f"block{bi}"])


def state_dict_from_jax(params: Mapping[str, Any], backbone: str,
                        num_anchors: int = 9) -> Dict[str, np.ndarray]:
    """JAX params tree -> the port's state dict (numpy values)."""
    sd: Dict[str, np.ndarray] = {}
    if backbone == "vgg16":
        for item in VGG16_LAYOUT:
            if item == "M":
                continue
            idx, _ = item
            p = params["backbone"][f"conv{idx}"]
            sd[f"RCNN_base.{idx}.weight"] = _conv(p["kernel"])
            sd[f"RCNN_base.{idx}.bias"] = _f32(p["bias"])
        for torch_i, ours in ((0, "fc6"), (3, "fc7")):
            p = params["head"][ours]
            sd[f"RCNN_top.{torch_i}.weight"] = _linear(p["kernel"])
            sd[f"RCNN_top.{torch_i}.bias"] = _f32(p["bias"])
    elif backbone == "tiny":
        for i, torch_i in _TINY_CONV_INDEX.items():
            p = params["backbone"][f"conv{i}"]
            sd[f"RCNN_base.{torch_i}.weight"] = _conv(p["kernel"])
            sd[f"RCNN_base.{torch_i}.bias"] = _f32(p["bias"])
        p = params["head"]["fc"]
        sd["RCNN_top.0.weight"] = _linear(p["kernel"])
        sd["RCNN_top.0.bias"] = _f32(p["bias"])
    elif backbone in ("resnet50", "resnet101", "resnet152"):
        _resnet(sd, params, int(backbone[len("resnet"):]))
    else:
        raise ValueError(f"unknown backbone {backbone!r}")

    rpn = params["rpn"]
    sd["RCNN_rpn.RPN_Conv.weight"] = _conv(rpn["conv"]["kernel"])
    sd["RCNN_rpn.RPN_Conv.bias"] = _f32(rpn["conv"]["bias"])
    inv = np.asarray([a * 2 + c for c in range(2) for a in range(num_anchors)])
    sd["RCNN_rpn.RPN_cls_score.weight"] = _conv(rpn["cls_score"]["kernel"])[inv]
    sd["RCNN_rpn.RPN_cls_score.bias"] = _f32(rpn["cls_score"]["bias"])[inv]
    sd["RCNN_rpn.RPN_bbox_pred.weight"] = _conv(rpn["bbox_pred"]["kernel"])
    sd["RCNN_rpn.RPN_bbox_pred.bias"] = _f32(rpn["bbox_pred"]["bias"])
    sd["RCNN_cls_score.weight"] = _linear(params["cls_score"]["kernel"])
    sd["RCNN_cls_score.bias"] = _f32(params["cls_score"]["bias"])
    sd["RCNN_bbox_pred.weight"] = _linear(params["bbox_pred"]["kernel"])
    sd["RCNN_bbox_pred.bias"] = _f32(params["bbox_pred"]["bias"])
    if "c3_proj" in params:
        sd["RCNN_c3_proj.weight"] = _conv(params["c3_proj"]["kernel"])
        sd["RCNN_c3_proj.bias"] = _f32(params["c3_proj"]["bias"])
    return sd


def discriminator_state_dict_from_jax(
        d_params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The flax ``PatchDiscriminator`` tree -> the state dict of
    :class:`scda_tpu_torch.models.discriminator.PatchDiscriminator`."""
    sd: Dict[str, np.ndarray] = {}
    for name in ("conv1", "conv2", "conv3"):
        sd[f"{name}.weight"] = _conv(d_params[name]["kernel"])
        sd[f"{name}.bias"] = _f32(d_params[name]["bias"])
    sd["fc.weight"] = _linear(d_params["fc"]["kernel"])
    sd["fc.bias"] = _f32(d_params["fc"]["bias"])
    return sd


def load_reference_checkpoint(model: torch.nn.Module, path: str, *,
                              allow_unsafe_pickle: bool = False):
    """Load a reference-layout detector ``.pth`` into ``model``; returns
    the file's payload.

    ``weights_only=True`` (:func:`scda_tpu_torch.train.torch_convert.
    torch_load`): such files come from outside this package and need
    nothing but tensors and dicts; ``allow_unsafe_pickle`` permits the full
    unpickle a legacy file may need.  A ``module.`` prefix (saved from
    ``nn.DataParallel``) is stripped, and so are the ``num_batches_tracked``
    counters of ``nn.BatchNorm2d`` in torchvision-lineage ResNet files
    (the port's frozen BatchNorm has none).
    """
    from scda_tpu_torch.train.torch_convert import torch_load

    payload = torch_load(path, allow_unsafe_pickle)
    sd = payload.get("model", payload) if isinstance(payload, dict) else payload
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items() if not k.endswith(".num_batches_tracked")}
    model.load_state_dict(sd)
    return payload

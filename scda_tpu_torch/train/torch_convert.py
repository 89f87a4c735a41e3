"""Pretrained backbones from torch ``.pth`` files (port of
``scda_tpu/train/torch_convert.py``'s ``convert_vgg16``,
``convert_resnet`` and ``load_pretrained_backbone``).

The reference loads caffe-lineage backbones (``vgg16_caffe.pth``,
``resnet101_caffe.pth``) whose inputs are BGR 0-255 mean-subtracted
images, which is what :mod:`scda_tpu_torch.data.pipeline` produces.  The
JAX package transposes them into its NHWC layout; the port keeps torch's
layout, so converting is a rename:

  * VGG16: ``features.N.*`` -> ``RCNN_base.N.*``; ``classifier.0/3.*``
    (fc6, fc7), when the file has them, -> ``RCNN_top.0/3.*``;
  * ResNet: ``conv1`` / ``bn1`` -> ``RCNN_base.0`` / ``.1``,
    ``layer1..3.B.*`` -> ``RCNN_base.4..6.B.*``, ``layer4.B.*`` ->
    ``RCNN_top.0.B.*`` (``downsample.0/1`` keep their names); each
    BatchNorm's weight, bias, running mean and variance become the
    frozen BatchNorm's.

Only the backbone (and VGG16's fc6/fc7) is replaced; the RPN and RoI
heads keep their fresh init.  Every key the model's layout asks for must
be in the file with the model's shape; keys the layout does not read
(``fc.*``, ``num_batches_tracked``) are ignored, as in the JAX package.

The other way, :func:`export_reference_detector` (port of the JAX
package's function of that name) turns a trained detector into the
reference lineage's state dict and :func:`reference_payload` into the
``{'model': ...}`` file its ``test_net.py`` loads.  The port's modules
already carry the reference's names and RPN channel order, so the export
is the state dict without what the reference lacks.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch

from scda_tpu_torch.config import parse_backbone
from scda_tpu_torch.models.faster_rcnn import FasterRCNN


def _vgg16_keys(model_keys, sd: Mapping[str, torch.Tensor]) -> Dict[str, str]:
    """Model key -> file key for a torchvision / caffe VGG16."""
    out = {k: "features." + k[len("RCNN_base."):]
           for k in model_keys if k.startswith("RCNN_base.")}
    if "classifier.0.weight" in sd:
        for i in (0, 3):
            for leaf in ("weight", "bias"):
                out[f"RCNN_top.{i}.{leaf}"] = f"classifier.{i}.{leaf}"
    return out


def _resnet_keys(model_keys) -> Dict[str, str]:
    """Model key -> file key for a torchvision ResNet."""
    out = {}
    for k in model_keys:
        m = re.match(r"RCNN_base\.(\d+)\.(.*)", k)
        if m:
            i, rest = int(m.group(1)), m.group(2)
            out[k] = ({0: "conv1", 1: "bn1"}[i] + "." + rest if i < 2
                      else f"layer{i - 3}.{rest}")
        elif k.startswith("RCNN_top.0."):
            out[k] = "layer4." + k[len("RCNN_top.0."):]
    return out


def convert_backbone(model: FasterRCNN, state_dict: Mapping[str, torch.Tensor],
                     backbone: str) -> Dict[str, torch.Tensor]:
    """The model's backbone keys filled from a torch state dict, with
    their shapes checked.  Raises KeyError for a key the layout needs and
    the file lacks (or a converted key the model lacks) and ValueError
    for a shape that differs."""
    model_sd = model.state_dict()
    family = parse_backbone(backbone)[0]
    if family == "vgg16":
        names = _vgg16_keys(model_sd, state_dict)
    elif family in ("resnet", "resnet_fpn"):
        names = _resnet_keys(model_sd)
    else:
        raise ValueError(f"no converter for backbone {backbone!r}")
    out = {}
    for ours, theirs in names.items():
        if ours not in model_sd:
            raise KeyError(f"converted param {theirs} -> {ours} not in the "
                           "model")
        value = torch.as_tensor(state_dict[theirs])
        if tuple(value.shape) != tuple(model_sd[ours].shape):
            raise ValueError(f"shape mismatch at {ours}: model "
                             f"{tuple(model_sd[ours].shape)}, torch "
                             f"{tuple(value.shape)}")
        out[ours] = value.float()
    return out


def torch_load(path: str, allow_unsafe_pickle: bool = False):
    """``torch.load`` to the CPU with ``weights_only=True``: files from
    outside this package need nothing but tensors and containers, and a
    full unpickle runs code from the file.  ``allow_unsafe_pickle`` falls
    back to it for a file that needs it (only for files you trust)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:   # the loader's errors span pickle and torch types
        if not allow_unsafe_pickle:
            raise RuntimeError(
                f"{path} is not loadable with weights_only=True (it pickles "
                "non-tensor objects). If you trust this file, pass "
                "allow_unsafe_pickle=True / --allow_unsafe_pickle.") from e
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state_dict(path: str, allow_unsafe_pickle: bool = False):
    """A state dict from a ``.pth`` (:func:`torch_load`); a pickled module
    or a ``{'state_dict': ...}`` wrapper is unwrapped."""
    sd = torch_load(path, allow_unsafe_pickle)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return sd


@torch.no_grad()
def load_pretrained_backbone(model: FasterRCNN, path: str, backbone: str,
                             allow_unsafe_pickle: bool = False) -> FasterRCNN:
    """Copy a torchvision / caffe backbone ``.pth`` into ``model`` in place
    (the RPN and RoI heads keep their init); returns ``model``."""
    sd = load_torch_state_dict(path, allow_unsafe_pickle)
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    for name, value in convert_backbone(model, sd, backbone).items():
        tensors[name].copy_(value)
    return model


def export_reference_detector(state_dict: Mapping[str, torch.Tensor],
                              backbone: str) -> Dict[str, torch.Tensor]:
    """A VGG16 or ResNet detector's state dict -> the reference layout
    (f32 tensors on the CPU).  ``RCNN_c3_proj`` (multiscale pooling), which
    the reference lineage does not have, is left out; other backbones
    have no reference counterpart and raise ValueError."""
    if parse_backbone(backbone)[0] not in ("vgg16", "resnet", "resnet_fpn"):
        raise ValueError(f"no reference exporter for {backbone!r}")
    return {k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in state_dict.items()
            if not k.startswith("RCNN_c3_proj.")}


def reference_payload(state_dict: Mapping[str, torch.Tensor], model_cfg,
                      step: int) -> Dict[str, Any]:
    """The ``{'model': ...}`` payload the reference's ``test_net.py --r``
    loads, with the fields the JAX package's exporter writes."""
    return {"model": export_reference_detector(state_dict,
                                               model_cfg.backbone),
            "session": 1, "epoch": 0, "step": int(step),
            "pooling_mode": model_cfg.pooling_mode,
            "class_agnostic": model_cfg.class_agnostic}

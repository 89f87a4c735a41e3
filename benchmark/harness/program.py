"""What the benchmark takes from the program (``scda_tpu_torch``): its
configuration, model and entry points, and its call sites, around which
the harness records what the judged units produced and opens ranges for
the trace.  Those wrappers are installed only outside the measured
window: on the set-up steps, the traced pass and the units judged after
the window.  Nothing here imports JAX or the JAX package.

The entries the window drives:

* ``serve``: ``models.detector.forward_inference`` on a model holding
  the benchmark's weights, cast to bfloat16 by ``evals.detect.
  bf16_inference_params`` where the configuration serves bf16 weights;
* ``train``: the step of ``train.steps.make_train_step`` over
  ``train.state.create_train_state``;
* ``scda``: the step of ``adapt.scda.make_scda_train_step`` over
  ``adapt.scda.create_scda_state``.

Call sites: ``models.detector.propose`` and ``adapt.scda.propose`` (the
proposal layer, K1), ``models.detector.postprocess`` (per-class decode,
NMS and the top detections), ``models.backbones.resnet.bottleneck_chain``
(K4 and, through the autograd node it creates, K4's backward).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

GROUPS = ("model", "train", "test", "anchors", "adapt", "data")


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def port_config(config_dict: dict, seed: int):
    """The program's ``Config``: its preset with every value of the
    benchmark's configuration file set, and the step streams' seed."""
    from scda_tpu_torch.config import get_config, replace_path

    cfg = get_config(config_dict["port_preset"])
    for group in GROUPS:
        for dotted, value in _leaves(config_dict[group], group + "."):
            cfg = replace_path(cfg, dotted, value)
    return replace_path(cfg, "train.seed", int(seed))


def model_layout(cfg) -> List[tuple]:
    """(state-dict key, shape, role, module) of every tensor of the
    detector: roles ``weight`` and ``bias`` of the convolutions and linear
    layers, and ``bn_<buffer>`` for the four buffers of each frozen batch
    norm."""
    from scda_tpu_torch.models.backbones.resnet import FrozenBatchNorm2d
    from scda_tpu_torch.models.faster_rcnn import FasterRCNN

    with torch.device("meta"):
        model = FasterRCNN(cfg.model, cfg.anchors.num_anchors)
    out = []
    for mname, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm2d):
            for b in ("weight", "bias", "running_mean", "running_var"):
                out.append((f"{mname}.{b}", tuple(getattr(mod, b).shape),
                            "bn_" + b, mname))
        elif isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            out.append((f"{mname}.weight", tuple(mod.weight.shape), "weight",
                        mname))
            if mod.bias is not None:
                out.append((f"{mname}.bias", tuple(mod.bias.shape), "bias",
                            mname))
    return out


def discriminator_layout(cfg) -> List[tuple]:
    from scda_tpu_torch.adapt.scda import discriminator_in_channels
    from scda_tpu_torch.models.discriminator import PatchDiscriminator

    with torch.device("meta"):
        d = PatchDiscriminator(discriminator_in_channels(cfg),
                               cfg.adapt.d_channels)
    return [(k, tuple(v.shape), "weight" if k.endswith("weight") else "bias",
             k.rsplit(".", 1)[0]) for k, v in d.state_dict().items()]


def detector(cfg, weights: Dict[str, torch.Tensor], device):
    from scda_tpu_torch.models.faster_rcnn import empty_model

    model = empty_model(cfg.model, cfg.anchors.num_anchors, device=device)
    model.load_state_dict(weights)
    return model


def serving(cfg, weights, device):
    """``forward(image, im_info) -> Detections`` on a model of its own."""
    from scda_tpu_torch.evals.detect import bf16_inference_params
    from scda_tpu_torch.models import detector as det

    model = detector(cfg, weights, device)
    if cfg.test.bf16_weights:
        bf16_inference_params(model)

    def forward(image, im_info):
        return det.forward_inference(model, image, im_info, cfg)

    return forward, model


def training(cfg, weights, device, d_weights=None):
    """(state, step): the source-only step, or with ``d_weights`` the SCDA
    step and its discriminator."""
    from scda_tpu_torch.train.state import create_train_state
    from scda_tpu_torch.train.steps import make_train_step

    model = detector(cfg, weights, device)
    det_state = create_train_state(cfg, model)
    if d_weights is None:
        return det_state, make_train_step(model, cfg)
    from scda_tpu_torch.adapt import scda
    from scda_tpu_torch.adapt.scda import discriminator_in_channels
    from scda_tpu_torch.models.discriminator import PatchDiscriminator

    with torch.device("meta"):
        d_model = PatchDiscriminator(discriminator_in_channels(cfg),
                                     cfg.adapt.d_channels)
    d_model = d_model.to_empty(device=device)
    d_model.load_state_dict(d_weights)
    state = scda.create_scda_state(cfg, det_state, d_model)
    return state, scda.make_scda_train_step(model, d_model, cfg)


def trainable_state(state) -> Dict[str, torch.Tensor]:
    """The trainable tensors the step updates (the discriminator's as
    ``D.<name>``), by name: live references."""
    det = getattr(state, "det", state)
    names, params = det.trainable()
    out = dict(zip(names, params))
    if hasattr(state, "d_model"):
        out.update({"D." + n: p for n, p in state.d_model.named_parameters()})
    return out


def momentum_state(state) -> Dict[str, torch.Tensor]:
    det = getattr(state, "det", state)
    out = dict(det.momentum)
    if hasattr(state, "d_momentum"):
        out.update({"D." + n: m for n, m in state.d_momentum.items()})
    return out


def step_count(state) -> int:
    """The steps the state has taken (the next step's stream index)."""
    return int(state.step)


# ---- call sites ------------------------------------------------------------

def _sites():
    """(module, name) of each call site the recorder wraps."""
    from scda_tpu_torch.adapt import scda
    from scda_tpu_torch.models import detector as det
    return ((det, "propose"), (scda, "propose"), (det, "postprocess"))


class CallRecorder:
    """Wraps the program's call sites of the proposal layer
    (``models.detector.propose``, ``adapt.scda.propose``) and of the
    detection postprocess (``models.detector.postprocess``).  Each call's
    (site, arguments, output) goes to ``calls`` while ``record`` is set,
    or to ``latest[slot]`` while ``slot`` is set; with ``trace`` set the
    call runs inside a ``bench.<site>`` range."""

    def __init__(self):
        self.record = False
        self.calls: List[tuple] = []
        self.slot: Optional[int] = None
        self.latest: Dict[int, List[tuple]] = {}
        self.trace = False

    @contextlib.contextmanager
    def installed(self):
        sites = _sites()
        saved = [getattr(m, name) for m, name in sites]

        def wrap(orig, name):
            def call(*args, **kwargs):
                if self.trace:
                    with torch.profiler.record_function("bench." + name):
                        out = orig(*args, **kwargs)
                else:
                    out = orig(*args, **kwargs)
                if self.record:
                    self.calls.append((name, args, out))
                if self.slot is not None:
                    self.latest.setdefault(self.slot, []).append(
                        (name, args, out))
                return out
            return call

        try:
            for (m, name), orig in zip(sites, saved):
                setattr(m, name, wrap(orig, name))
            yield self
        finally:
            for (m, name), orig in zip(sites, saved):
                setattr(m, name, orig)


class ChainRanges:
    """Wraps ``models.backbones.resnet.bottleneck_chain``: each call runs
    inside a ``bench.chain`` range and records its (x, w1) shapes; where
    its output takes part in a backward, the autograd node the call
    created runs inside a ``bench.chain_bwd`` range (the node's pre-hook
    opens it, its hook closes it)."""

    def __init__(self):
        self.calls: List[dict] = []

    @contextlib.contextmanager
    def installed(self):
        from scda_tpu_torch.models.backbones import resnet

        orig = resnet.bottleneck_chain
        calls = self.calls

        def bottleneck_chain(x, w1, *rest, **kwargs):
            with torch.profiler.record_function("bench.chain"):
                y = orig(x, w1, *rest, **kwargs)
            rec = {"x": tuple(x.shape), "w1": tuple(w1.shape),
                   "backward": False}
            node = y.grad_fn if y.requires_grad else None
            if node is not None:
                rec["backward"] = True
                open_ranges = []

                def pre(grad_outputs):
                    rf = torch.profiler.record_function("bench.chain_bwd")
                    rf.__enter__()
                    open_ranges.append(rf)

                def post(grad_inputs, grad_outputs):
                    if open_ranges:
                        open_ranges.pop().__exit__(None, None, None)

                node.register_prehook(pre)
                node.register_hook(post)
            calls.append(rec)
            return y

        resnet.bottleneck_chain = bottleneck_chain
        try:
            yield self
        finally:
            resnet.bottleneck_chain = orig

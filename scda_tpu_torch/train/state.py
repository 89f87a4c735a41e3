"""Train state and optimizer (port of ``scda_tpu/train/state.py``).

The JAX package chains optax transforms over its params tree; the port
writes the same chain out over named parameter lists, in optax's order:

  1. frozen parameters get no gradient (``requires_grad=False``: the
     analogue of JAX zeroing them first, and autograd then skips the
     backward below the last trainable layer);
  2. clip by the global norm of the trainable gradients
     (``train.clip_gradients``): ``(g / norm) * max_norm`` when the norm
     reaches the bound;
  3. add ``weight_decay * p`` where decay applies (trainable, and not a
     bias unless ``bias_decay``);
  4. double the bias gradients (``double_bias``);
  5. SGD momentum (``trace = g + momentum * trace``, stored in
     ``momentum_dtype``, the product taken in that dtype as optax does),
     then ``p -= lr(step) * trace``.

``torch.optim.SGD`` cannot hold a bfloat16 momentum buffer nor put decay
and the bias scale in this order.  The learning rate is optax's
piecewise-constant schedule, reproduced in float32.  Parameters and the
momentum are updated in place.

The chain is :mod:`scda_tpu_torch.ops.kernels.sgd_kernel`'s, over a rule a
tensor (:meth:`SgdChain.rules`): on CUDA tensors one hand-written pass
(three launches a step, the SCDA discriminator's plain SGD in the same
launches), elsewhere its plain twin, op by op.  The tensors' device alone
decides.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from scda_tpu_torch.config import Config
from scda_tpu_torch.models.backbones.resnet import resnet_frozen_param_paths
from scda_tpu_torch.models.backbones.vgg import vgg_frozen_param_paths
from scda_tpu_torch.models.faster_rcnn import FasterRCNN
from scda_tpu_torch.ops.kernels import sgd_kernel
from scda_tpu_torch.ops.kernels.sgd_kernel import SgdRule


def frozen_paths_for(cfg: Config) -> Sequence[str]:
    """Module prefixes of the frozen parameters."""
    if not cfg.train.freeze_pretrained_layers:
        return ()
    if cfg.model.backbone == "vgg16":
        return vgg_frozen_param_paths()
    if cfg.model.backbone.startswith("resnet"):
        return resnet_frozen_param_paths(cfg.model.resnet_fixed_blocks)
    return ()


def is_frozen(name: str, frozen_prefixes: Sequence[str]) -> bool:
    """Segment-exact prefix match: ``RCNN_base.2`` freezes conv1_2 but
    not ``RCNN_base.21``."""
    return any(name == p or name.startswith(p + ".") for p in frozen_prefixes)


def _is_bias(name: str, p: torch.Tensor) -> bool:
    return name.endswith(".bias") and p.dim() == 1


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """Step decay, ``learning_rate * gamma`` every ``lr_decay_step``
    epochs: optax ``piecewise_constant_schedule`` evaluated in float32
    (the scale applies from the boundary's step on)."""
    tc = cfg.train
    boundaries = []
    e = tc.lr_decay_step
    while e <= tc.max_epochs:
        boundaries.append(e * steps_per_epoch)
        e += tc.lr_decay_step
    init, gamma = np.float32(tc.learning_rate), np.float32(tc.gamma)

    def schedule(count: int) -> float:
        v = init
        for threshold in boundaries:
            if count >= threshold:
                v = np.float32(gamma * v)
        return float(v)

    return schedule


# A tensor of a PlainSgd group: no clip, no decay, no bias factor.
PLAIN_RULE = SgdRule(clip=False, decay=0.0, scale=1.0, group=1)


class PlainSgd(NamedTuple):
    """A group of tensors under plain SGD with momentum (``trace = g +
    decay * trace``, ``p -= lr * trace``: no clip, no weight decay, no
    bias factor), updated in the same pass as a chain's own: the SCDA
    discriminator's.  Dicts by the same names."""

    params: Dict[str, torch.Tensor]
    grads: Dict[str, torch.Tensor]
    momentum: Dict[str, torch.Tensor]
    decay: float
    lr: float


class SgdChain:
    """The optimizer of :mod:`scda_tpu.train.state` over a model's named
    parameters; see the module docstring for the order."""

    def __init__(self, cfg: Config, model: FasterRCNN, steps_per_epoch: int):
        tc = cfg.train
        frozen = frozen_paths_for(cfg)
        self.lr_schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.clip = tc.clip_gradients if tc.clip_gradients > 0 else None
        self.weight_decay = tc.weight_decay
        self.momentum = tc.momentum
        self.momentum_dtype = (torch.bfloat16 if tc.momentum_dtype == "bfloat16"
                               else torch.float32)
        named = list(model.named_parameters())
        self.frozen = [n for n, _ in named if is_frozen(n, frozen)]
        self.names = [n for n, _ in named if not is_frozen(n, frozen)]
        by_name = dict(named)
        self.decay = [n for n in self.names
                      if tc.bias_decay or not _is_bias(n, by_name[n])]
        self.bias = ([n for n in self.names if _is_bias(n, by_name[n])]
                     if tc.double_bias else [])
        # optax's trace takes decay * trace in the trace's dtype.
        self.momentum_factor = float(torch.tensor(self.momentum,
                                                  dtype=self.momentum_dtype))
        decay = set(self.decay) if self.weight_decay else set()
        bias = set(self.bias)
        self._rules = [SgdRule(clip=self.clip is not None,
                               decay=self.weight_decay if n in decay else 0.0,
                               scale=2.0 if n in bias else 1.0, group=0)
                       for n in self.names]
        self._tables: Optional[sgd_kernel.SgdTables] = None

    def rules(self, plain: int = 0) -> List[SgdRule]:
        """What the chain does to each tensor of ``names``, in order, then
        to ``plain`` tensors of a :class:`PlainSgd` group."""
        return self._rules + [PLAIN_RULE] * plain

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Zero momentum for every trainable parameter."""
        return {n: torch.zeros_like(params[n], dtype=self.momentum_dtype)
                for n in self.names}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor],
               momentum: Dict[str, torch.Tensor], count: int,
               plain: Optional[PlainSgd] = None) -> None:
        """One step on the trainable ``params`` and ``momentum``, in place,
        and on the ``plain`` group's where one is given."""
        ps = [params[n] for n in self.names]
        gs = [grads[n] for n in self.names]
        ms = [momentum[n] for n in self.names]
        mom = (self.momentum_factor, 0.0)
        lr = (self.lr_schedule(count), 0.0)
        if plain is not None:
            names = list(plain.momentum)
            ps += [plain.params[n] for n in names]
            gs += [plain.grads[n] for n in names]
            ms += [plain.momentum[n] for n in names]
            mom, lr = (mom[0], plain.decay), (lr[0], plain.lr)
        rules = self.rules(len(ms) - len(self.names))
        if not ms:
            return
        if ms[0].is_cuda:
            if self._tables is None or not self._tables.matches(ps, ms):
                self._tables = sgd_kernel.SgdTables(ps, ms, rules, self.clip)
            sgd_kernel.sgd_chain(self._tables, gs, momentum=mom, lr=lr)
        else:
            sgd_kernel.sgd_chain_plain(ps, gs, ms, rules, clip=self.clip,
                                       momentum=mom, lr=lr)


@dataclasses.dataclass
class TrainState:
    """Step count, the model (its f32 parameters) and the momentum."""

    step: int
    model: FasterRCNN
    momentum: Dict[str, torch.Tensor]
    tx: SgdChain

    def trainable(self) -> Tuple[List[str], List[torch.Tensor]]:
        params = dict(self.model.named_parameters())
        return self.tx.names, [params[n] for n in self.tx.names]

    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        plain: Optional[PlainSgd] = None) -> None:
        """One optimizer step; ``plain``: a group updated in the same
        pass."""
        self.tx.update(dict(self.model.named_parameters()), grads,
                       self.momentum, self.step, plain)
        self.step += 1


def create_train_state(cfg: Config, model: FasterRCNN,
                       steps_per_epoch: int = 1000) -> TrainState:
    """Freeze the frozen parameters (``requires_grad_(False)``), build the
    optimizer and zero momentum.  The model's parameters must be f32."""
    tx = SgdChain(cfg, model, steps_per_epoch)
    params = dict(model.named_parameters())
    for n, p in params.items():
        if p.dtype != torch.float32:
            raise TypeError(f"create_train_state: parameter {n} is "
                            f"{p.dtype}; training keeps float32 parameters")
        p.requires_grad_(n not in tx.frozen)
    return TrainState(step=0, model=model, momentum=tx.init(params), tx=tx)

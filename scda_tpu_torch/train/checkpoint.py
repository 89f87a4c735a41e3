"""Checkpoints of the port's train state, in the reference lineage's
format: one ``torch.save`` of

    {session, epoch, step, model, optimizer, pooling_mode, class_agnostic}

per file, ``model`` the detector's state dict (reference layout, so
``cli/test_net.py`` evaluates it) and ``optimizer`` the momentum buffers.
An SCDA state (:class:`scda_tpu_torch.adapt.scda.ScdaTrainState`) saves
the same dict plus ``discriminator`` (its state dict) and ``d_momentum``,
so ``model`` is the detector either way.  Restoring a detector-only
checkpoint into an SCDA state loads the model and its momentum and
leaves the discriminator as it is: adaptation starts from a source-only
detector.  A save writes a temp file and renames it, so a
crash never leaves a torn ``ckpt_<step>.pth``.  Saves are synchronous:
the JAX package's asynchronous Orbax writer serves a TPU host's slow
device fetch, which a torch state on one card does not need.

Resume is bit-equal: the step's randomness derives from (seed, step)
(:func:`scda_tpu_torch.train.steps.step_generators`), and the state is
the model, the momentum and the step (and the discriminator with its
momentum).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Union

import torch

from scda_tpu_torch.adapt.scda import ScdaTrainState
from scda_tpu_torch.train.state import TrainState

AnyState = Union[TrainState, ScdaTrainState]

_NAME = re.compile(r"^ckpt_(\d{8})\.pth$")
KEEP = 5          # newest checkpoints kept, as the JAX package's default
SESSION = 1       # the reference dict's ``session``: one run per directory


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.pth")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory))
                  if m)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def is_port_checkpoint(payload: Any) -> bool:
    """Whether a loaded ``.pth`` was written by :func:`save_checkpoint`
    (its ``optimizer`` holds ``momentum``; the reference lineage saves a
    ``torch.optim`` state dict there)."""
    return (isinstance(payload, dict)
            and "momentum" in (payload.get("optimizer") or {}))


def load_payload(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The dict of ``ckpt_<step>.pth`` (the newest by default; step 0 is
    a real step), on the CPU."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return torch.load(_path(directory, step), map_location="cpu",
                      weights_only=True)


def save_checkpoint(directory: str, state: AnyState, *,
                    epoch: int = 0) -> str:
    """Write ``directory/ckpt_<state.step>.pth`` and keep the newest
    :data:`KEEP` checkpoints.  Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, state.step)
    det = state.det if isinstance(state, ScdaTrainState) else state
    mc = det.model.cfg
    payload = {
        "session": SESSION, "epoch": epoch, "step": state.step,
        "model": det.model.state_dict(),
        "optimizer": {"momentum": det.momentum},
        "pooling_mode": mc.pooling_mode, "class_agnostic": mc.class_agnostic,
    }
    if isinstance(state, ScdaTrainState):
        payload["discriminator"] = state.d_model.state_dict()
        payload["d_momentum"] = state.d_momentum
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    for old in _steps(directory)[:-KEEP]:
        os.unlink(_path(directory, old))
    return path


def _copy_buffers(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
                  what: str) -> None:
    if set(src) != set(dst):
        raise ValueError(f"checkpoint {what} does not match the train "
                         "state's trainable parameters")
    with torch.no_grad():
        for n, buf in dst.items():
            buf.copy_(src[n])


def restore_checkpoint(directory: str, state: AnyState,
                       step: Optional[int] = None) -> AnyState:
    """Load ``ckpt_<step>.pth`` (the newest by default) into ``state`` in
    place: the model's tensors, the momentum and the step; into an SCDA
    state also the discriminator and its momentum, where the checkpoint
    holds them."""
    payload = load_payload(directory, step)
    det = state.det if isinstance(state, ScdaTrainState) else state
    det.model.load_state_dict(payload["model"])
    _copy_buffers(det.momentum, payload["optimizer"]["momentum"], "momentum")
    det.step = int(payload["step"])
    if isinstance(state, ScdaTrainState) and "discriminator" in payload:
        state.d_model.load_state_dict(payload["discriminator"])
        _copy_buffers(state.d_momentum, payload["d_momentum"], "d_momentum")
    return state

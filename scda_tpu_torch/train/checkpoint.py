"""Checkpoints of the port's train state, in the reference lineage's
format: one ``torch.save`` of

    {session, epoch, step, model, optimizer, pooling_mode, class_agnostic}

per file, ``model`` the detector's state dict (reference layout, so
``cli/test_net.py --torch_checkpoint`` evaluates it) and ``optimizer``
the momentum buffers.  A save writes a temp file and renames it, so a
crash never leaves a torn ``ckpt_<step>.pth``.  Saves are synchronous:
the JAX package's asynchronous Orbax writer serves a TPU host's slow
device fetch, which a torch state on one card does not need.

Resume is bit-equal: the step's randomness derives from (seed, step)
(:func:`scda_tpu_torch.train.steps.step_generators`), and the state is
the model, the momentum and the step.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from scda_tpu_torch.train.state import TrainState

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


def save_checkpoint(directory: str, state: TrainState, *,
                    epoch: int = 0) -> str:
    """Write ``directory/ckpt_<state.step>.pth`` and keep the newest
    :data:`KEEP` checkpoints.  Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, state.step)
    mc = state.model.cfg
    payload = {
        "session": SESSION, "epoch": epoch, "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": {"momentum": state.momentum},
        "pooling_mode": mc.pooling_mode, "class_agnostic": mc.class_agnostic,
    }
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


def restore_checkpoint(directory: str, state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Load ``ckpt_<step>.pth`` (the newest by default) into ``state`` in
    place: the model's tensors, the momentum and the step."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    payload = torch.load(_path(directory, step), map_location="cpu",
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    momentum = payload["optimizer"]["momentum"]
    if set(momentum) != set(state.momentum):
        raise ValueError("checkpoint momentum does not match the train "
                         "state's trainable parameters")
    with torch.no_grad():
        for n, buf in state.momentum.items():
            buf.copy_(momentum[n])
    state.step = int(payload["step"])
    return state

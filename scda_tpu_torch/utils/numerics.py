"""The numerics every entry point of the port runs in.

The JAX package's f32 parity and every gate on the card assume full f32
convolutions and matmuls, and the JAX package's runs on the TPU repeat
bit for bit.  PyTorch's defaults give neither on the card: cuDNN runs
f32 convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` is True),
may pick a convolution algorithm by timing and may pick one whose sums
run in a varying order, and the CUDA backward of a gather or of advanced
indexing adds with atomics.  :func:`set_card_numerics` turns all of that
off for the process.  It is not an option: the three CLIs, each rank of
``parallel/mesh.py``, ``chip_smoke.py``, ``bench_torch.py`` and
``utils/kernel_probe.py`` call it first, and nothing turns it off.

``torch.utils.deterministic.fill_uninitialized_memory`` stays at its
default (on): with deterministic algorithms, ``torch.empty`` then fills
its memory with NaN, so a kernel that leaves part of its output unwritten
shows up instead of passing on stale values.
"""

from __future__ import annotations

import os

import torch

# cuBLAS needs a fixed workspace to be deterministic; PyTorch raises on
# the first cuBLAS call under deterministic algorithms without it.  It is
# read when the process creates its first cuBLAS handle.
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def set_card_numerics() -> None:
    """Full f32 (no TF32) and deterministic algorithms, process-wide.

    Call it before the first CUDA tensor exists.  An op with no
    deterministic CUDA implementation raises from then on: the port
    writes such ops another way, it never turns the check off."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)

"""The process-wide settings that ``scda_tpu_torch.utils.numerics`` sets,
read and restored for tests.  The CLIs set them when a test calls their
``main`` in this process; :func:`kept` puts them back afterwards, so that
no later test in the same worker runs under them."""

import contextlib
import os

import torch

ENV = "CUBLAS_WORKSPACE_CONFIG"


def read() -> dict:
    """Every setting of ``set_card_numerics``, by name."""
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "cudnn.benchmark": torch.backends.cudnn.benchmark,
        "deterministic_algorithms":
            torch.are_deterministic_algorithms_enabled(),
        "deterministic_warn_only":
            torch.is_deterministic_algorithms_warn_only_enabled(),
        "fill_uninitialized_memory":
            torch.utils.deterministic.fill_uninitialized_memory,
        ENV: os.environ.get(ENV),
    }


# What the helper leaves, whatever was set before.
CARD = {"cudnn.allow_tf32": False, "cuda.matmul.allow_tf32": False,
        "cudnn.deterministic": True, "cudnn.benchmark": False,
        "deterministic_algorithms": True, "deterministic_warn_only": False,
        "fill_uninitialized_memory": True, ENV: ":4096:8"}


def apply(values: dict) -> None:
    torch.backends.cudnn.allow_tf32 = values["cudnn.allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = values["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.deterministic = values["cudnn.deterministic"]
    torch.backends.cudnn.benchmark = values["cudnn.benchmark"]
    torch.use_deterministic_algorithms(
        values["deterministic_algorithms"],
        warn_only=values["deterministic_warn_only"])
    torch.utils.deterministic.fill_uninitialized_memory = values[
        "fill_uninitialized_memory"]
    if values[ENV] is None:
        os.environ.pop(ENV, None)
    else:
        os.environ[ENV] = values[ENV]


@contextlib.contextmanager
def kept():
    """Restore every setting of ``set_card_numerics`` on exit."""
    before = read()
    try:
        yield before
    finally:
        apply(before)

"""The driver of SCDA mixes: the training driver (``kinds/train.py``),
which takes a target pool and the discriminator where the mix has
``target_pool``."""

from benchmark.harness.kinds.train import run  # noqa: F401

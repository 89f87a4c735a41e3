"""Uniform draws for the step's random streams, whole or one rank's rows.

Every random draw of a step (target sampling, dropout, the k-means
inits) has the batch, or the batch times a per-image count, as its
leading axis, and comes from one ``torch.Generator`` seeded from (seed,
step).  Under data parallelism (:mod:`scda_tpu_torch.parallel.mesh`) a
rank holds a :class:`RowShard` instead: it draws the global batch's shape
from the same generator and keeps its own rows, so every rank sees the
values a single process with the global batch would.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch


class RowShard(NamedTuple):
    """Rows ``index`` of ``count`` equal slices of each draw's leading
    axis, drawn at ``count`` times the local shape from ``generator``."""

    generator: torch.Generator
    index: int
    count: int

    @property
    def device(self) -> torch.device:
        return self.generator.device


Source = Union[torch.Generator, RowShard]


def uniform(source: Source, shape: Sequence[int]) -> torch.Tensor:
    """f32 uniforms in [0, 1) of ``shape``, on the generator's device."""
    if isinstance(source, RowShard):
        n = shape[0]
        u = torch.rand((n * source.count, *shape[1:]),
                       generator=source.generator, device=source.device)
        return u[source.index * n:(source.index + 1) * n]
    return torch.rand(tuple(shape), generator=source, device=source.device)

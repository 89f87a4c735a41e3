"""Data parallelism over several GPUs (port of ``scda_tpu/parallel/mesh.py``).

The JAX package shards the batch over a one-axis ``('data',)`` mesh and
replicates the parameters; its step computes the loss of the global batch
and XLA sums the gradient.  Here each rank is a process with one device
(``cuda:rank``, or the CPU with gloo) that holds a replica of the
parameters and its slice of every batch, and the same arithmetic is
written out with ``torch.distributed``:

  * every loss divides its local numerator by the global denominator
    (counts of sampled anchors, rois, valid groups: all-reduced and
    detached; the batch size times the world size), so the ranks' losses
    sum to the global batch's;
  * the gradients are summed over the ranks, flattened into one bucket
    and reduced by one ``all_reduce``, before the optimizer, whose clip
    then sees the global gradient's norm;
  * every random draw is taken at the global batch's shape from the same
    (seed, step) generators, each rank keeping its rows
    (:class:`scda_tpu_torch.core.draws.RowShard`);
  * the loader follows the global epoch order and prepares only the
    rank's rows of each batch (:class:`ShardedDataLoader`).

So N ranks with batch b each equal one process with batch N * b, up to
the order of float sums.  ``DistributedDataParallel`` would average the
ranks' gradients of per-rank means, which is the same only at one rank,
and it never sees gradients taken with ``torch.autograd.grad``.

The CLIs start their ranks themselves (:func:`spawn`); a world of one
device takes the plain path, with no process group.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from scda_tpu_torch.core.draws import RowShard
from scda_tpu_torch.data.pipeline import DataLoader
from scda_tpu_torch.utils.numerics import set_card_numerics


class World:
    """One rank's view of the data-parallel group."""

    def __init__(self, rank: int, size: int):
        self.rank, self.size = rank, size

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard(self, generator: torch.Generator) -> RowShard:
        """``generator`` as this rank's rows of each draw."""
        return RowShard(generator, self.rank, self.size)

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global``."""
        n = n_global // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, detached (a loss denominator)."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def sum_tensors(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor summed over the ranks, through one bucket: the
        tensors flattened into one buffer (their common dtype), one
        ``all_reduce``, and split back."""
        if not tensors:
            return []
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        return [part.view_as(t) for part, t in
                zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]

    def sum_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Scalar metrics summed over the ranks in one ``all_reduce``;
        each is a local numerator over a global denominator, so the sum is
        the global batch's value."""
        names = list(metrics)
        red = self.sum_tensors([metrics[k].float().reshape(1) for k in names])
        return {k: r[0].to(metrics[k].dtype) for k, r in zip(names, red)}

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's ``obj`` (pickled), in rank order, on rank 0; None
        elsewhere."""
        out = [None] * self.size if self.is_main else None
        dist.gather_object(obj, out, dst=0)
        return out


def num_devices(requested: int, device: torch.device) -> int:
    """The world size for ``--num_devices``: 0 means every visible CUDA
    device, as the JAX CLI's 0 means every device; on the CPU it means 1."""
    if requested > 0:
        return requested
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:rank`` on CUDA, else ``device``."""
    device = torch.device(device)
    return torch.device("cuda", rank) if device.type == "cuda" else device


def init_world(rank: int, size: int, init_method: str,
               device: torch.device) -> World:
    """Put the rank in the port's numerics (``utils/numerics.py``), join
    the process group (NCCL on CUDA, gloo on the CPU) and bind the rank's
    device."""
    set_card_numerics()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=size)
    return World(rank, size)


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(rank: int, fn: Callable, size: int, init_method: str,
                device: str, threads: int, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(torch.device(device), rank)
    world = init_world(rank, size, init_method, dev)
    try:
        rc = fn(world, dev, *args)
    finally:
        close_world()
    if rc:
        raise SystemExit(rc)


def spawn(fn: Callable, size: int, device: torch.device, *args,
          threads: int = 0, rendezvous_dir: Optional[str] = None) -> int:
    """Run ``fn(world, device, *args)`` on ``size`` ranks, each a process
    started by ``torch.multiprocessing`` (spawn) with its own device, and
    return 0, or 1 when a rank failed.  The ranks meet through a file in
    ``rendezvous_dir`` (a fresh temporary directory by default), so two
    groups on one machine never share a port.  ``threads`` > 0 sets each
    rank's CPU threads."""
    import torch.multiprocessing as mp

    own = rendezvous_dir is None
    tmp = tempfile.mkdtemp(prefix="scda_ranks_") if own else rendezvous_dir
    init_method = "file://" + os.path.join(os.path.abspath(tmp), "rendezvous")
    try:
        mp.spawn(_rank_entry, nprocs=size, join=True,
                 args=(fn, size, init_method, str(device), threads, args))
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        print(f"data parallel: {e}", flush=True)
        return 1
    finally:
        if own:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    return 0


class ShardedDataLoader(DataLoader):
    """A :class:`DataLoader` whose batches are this rank's rows of the
    global batches: every rank draws the same epoch plan (order and
    flips) from the same seed, and loads and prepares only its rows.
    ``batch_size`` is the global batch and must divide by the world size;
    ``len``, ``fast_forward`` and ``repeat`` are the global loader's."""

    def __init__(self, *args, world: World, **kwargs):
        super().__init__(*args, **kwargs)
        if self.batch_size % world.size:
            raise ValueError(f"batch size {self.batch_size} does not divide "
                             f"by {world.size} ranks")
        self.world = world

    def _make_batch(self, indices, flips):
        rows = self.world.rows(len(indices))
        return super()._make_batch(indices[rows], flips[rows])

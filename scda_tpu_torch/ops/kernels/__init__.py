"""Hand-written CUDA kernels (csrc/) with their plain PyTorch twins.

Each module holds one kernel's wrapper, its twin of the same signature,
and a launch counter on the wrapper (``<wrapper>.launches``).  K2 and K4
also hold a backward kernel, with its own wrapper, twin and counter
(``roi_align_contract_bwd``, ``bottleneck_chain_bwd``), which their
``autograd.Function``s call.  :func:`plain_twins` swaps the forward call
sites only: a swapped-in forward twin is differentiated by autograd, so
the backward kernels do not run inside it.
"""

from __future__ import annotations

import contextlib


def call_sites():
    """(module, name, twin) for each forward wrapper at the name the
    port's modules call it through: the places where a caller swaps a
    wrapper for its plain twin."""
    from scda_tpu_torch.models.backbones import resnet, vgg
    from scda_tpu_torch.ops import nms, roi_ops
    from scda_tpu_torch.ops.kernels import (
        bottleneck_kernel, nms_kernel, roi_align_kernel, stem_kernel,
    )

    return ((vgg, "vgg_stem_fused", stem_kernel.vgg_stem_plain),
            (roi_ops, "roi_align_contract",
             roi_align_kernel.roi_align_contract_plain),
            (resnet, "bottleneck_chain", bottleneck_kernel.bottleneck_chain_plain),
            (nms, "nms_sorted", nms_kernel.nms_sorted_plain))


@contextlib.contextmanager
def plain_twins():
    """Inside the block every kernel's call site takes its plain twin, on
    every device: the reference a kernel path is held against."""
    sites = call_sites()
    saved = [getattr(module, name) for module, name, _ in sites]
    try:
        for module, name, twin in sites:
            setattr(module, name, twin)
        yield
    finally:
        for (module, name, _), orig in zip(sites, saved):
            setattr(module, name, orig)

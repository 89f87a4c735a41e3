#!/usr/bin/env python
"""A/B of the commuted multiscale lateral projection
(cfg.model.ms_proj_after_pool; ``models/faster_rcnn.py``
``pool_multiscale``).

Off, the stride-8 level is projected from 512 to 1024 channels as a
whole map and RoI-Align (kernel K2) pools the projected map; on, K2
pools the RAW 512-channel level and the pooled (R, P, P, 512) tensor is
projected afterwards (one matmul plus a bias x weight-mass correction).
The commute is exact in arithmetic but not in rounding.

End to end, off / on / off: bench_torch.py's res101-ms serving at bs 1
(``res101_ms``) and bs 8 (``res101_bs8``), the knob set by a config
hook.  Per arm img/s (the median of the windows; the host moves it) and
device ms per image (a profiler pass; the stable reading).  The arms'
f32 detections must match at the bar the card meets against the CPU,
and every arm's bf16 detections must be finite with one valid at least
(``bench_torch.ab_agreement``).

Run: python scripts_torch/ms_proj_ab.py [1|8|both] [--device cuda]
         [--iters N] [--repeats N]
(``--device cpu`` runs the plain twins on the CPU: no kernel, slow.)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CONFIGS = {1: "res101_ms", 8: "res101_bs8"}


def run(batch_size: int, device, iters=None, repeats=None,
        cfg_hook=None, inputs=None) -> dict:
    """Serving at ``batch_size`` with ``ms_proj_after_pool`` off, on, off
    on ``inputs`` distinct batches (the bench's 8 by default); ``cfg_hook``
    maps the config first (the CPU tests cut it)."""
    import bench_torch
    from scda_tpu_torch.config import replace_path

    def knob(flag):
        def hook(cfg):
            cfg = cfg_hook(cfg) if cfg_hook else cfg
            return replace_path(cfg, "model.ms_proj_after_pool", flag)
        return hook

    arms = bench_torch.serving_ab(
        CONFIGS[batch_size], device,
        [(f"ms_proj_after_pool={flag}", knob(flag), None)
         for flag in (False, True, False)],
        iters=iters, repeats=repeats or bench_torch.REPEATS, inputs=inputs)
    return bench_torch.ab_agreement(arms, "ms_proj_after_pool")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", nargs="?", default="both",
                   choices=["1", "8", "both"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=None,
                   help="units per window (bench_torch.py's by default)")
    p.add_argument("--repeats", type=int, default=None,
                   help="timed windows (bench_torch.py's 5 by default)")
    args = p.parse_args(argv)

    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    import torch

    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("--device cuda: no CUDA device is available (use --device cpu "
              "for the plain-PyTorch path)", file=sys.stderr)
        return 2
    for bs in (1, 8):
        if args.batch in (str(bs), "both"):
            run(bs, args.device, args.iters, args.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""A/B of kernel K4, the fused bottleneck chain (csrc/bottleneck_chain.cu).

Stage 1: the kernel alone at the production layer3 shape (x (1, 32, 64,
1024), F=256, N=22, seeded as scripts/bottleneck_ab.py seeds it):
its largest error relative to the twin's largest magnitude, and its
time beside the plain twin's and the cuDNN chain's, by CUDA events.
Stage 2: end to end, bench_torch.py's ``res101_ms`` serving config with
K4 on, off, on; "off" swaps only K4's call site for its twin
(``plain_twins("bottleneck_chain")``).  Per arm img/s (the median of
the windows; the host moves it) and device ms per image (a profiler
pass; the stable reading); the arms' f32 detections must match
(``bench_torch.ab_agreement``).

Run: python scripts_torch/bottleneck_ab.py [1|2|both] [--device cuda]
         [--iters N] [--repeats N]
(``--device cpu`` runs the plain twins on the CPU: no kernel, slow.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

LAYER3 = (1, 32, 64, 256, 22)      # B, H, W, F, N
MAX_REL_ERR = 2.0 ** -5            # chip_smoke.py's bf16 gate on K4


def timer(device):
    """Median time of ``fn()`` in ms: CUDA events on the card, the wall
    clock on the CPU."""
    import torch

    from scda_tpu_torch.utils.kernel_probe import time_ms

    if torch.device(device).type == "cuda":
        return lambda fn, repeats: time_ms(fn, repeats)

    def wall(fn, repeats):
        fn()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    return wall


def stage1(device, shape=LAYER3, repeats=20) -> dict:
    """K4 against its twin and the cuDNN chain on seeded inputs."""
    import torch

    from scda_tpu_torch.ops.kernels import bottleneck_kernel as bk
    from scda_tpu_torch.utils.kernel_probe import cudnn_chain

    rng = np.random.RandomState(0)
    b, h, w, f, n = shape
    c = 4 * f

    def t(*dims, std):
        return torch.from_numpy(
            rng.randn(*dims).astype(np.float32) * std).to(device)

    x = t(b, h, w, c, std=0.5)
    ws = (t(n, c, f, std=0.05), t(n, 1, f, std=0.1),
          t(n, 9, f, f, std=0.05), t(n, 1, f, std=0.1),
          t(n, f, c, std=0.05), t(n, 1, c, std=0.1))
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    out = bk.bottleneck_chain(x, *ws)
    if cuda:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ref = bk.bottleneck_chain_plain(x, *ws)
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item() + 1e-6
    time_ms = timer(device)
    res = {"stage": 1, "x": [b, h, w, c], "F": f, "blocks": n,
           "dtype": "bfloat16", "first_call_s": first_s,
           "max_rel_err": err / scale, "max_abs_err": err,
           "tolerance": f"max abs err <= {MAX_REL_ERR} x max|twin|",
           "kernel_ms": time_ms(lambda: bk.bottleneck_chain(x, *ws),
                                repeats),
           "plain_ms": time_ms(lambda: bk.bottleneck_chain_plain(x, *ws),
                               max(repeats // 4, 1))}
    if cuda:
        run, _ = cudnn_chain(x, *ws)
        res["cudnn_ms"] = time_ms(run, repeats)
    print(json.dumps(res), flush=True)
    if not res["max_rel_err"] <= MAX_REL_ERR:
        raise RuntimeError(f"K4 off its twin by {res['max_rel_err']} of the "
                           f"twin's largest magnitude (bound {MAX_REL_ERR})")
    return res


def stage2(device, iters=None, repeats=None, cfg_hook=None,
           name="res101_ms") -> dict:
    """bench_torch.py's ``name`` serving with K4 on / off / on."""
    import bench_torch
    from scda_tpu_torch.ops.kernels import plain_twins

    off = lambda: plain_twins("bottleneck_chain")   # noqa: E731
    arms = bench_torch.serving_ab(
        name, device, [("on", cfg_hook, None), ("off", cfg_hook, off),
                       ("on", cfg_hook, None)],
        iters=iters, repeats=repeats or bench_torch.REPEATS)
    return bench_torch.ab_agreement(arms, "K4")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("stage", nargs="?", default="both",
                   choices=["1", "2", "both"])
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
    if args.stage in ("1", "both"):
        stage1(args.device)
    if args.stage in ("2", "both"):
        stage2(args.device, args.iters, args.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())

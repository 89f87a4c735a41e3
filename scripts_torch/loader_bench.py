"""Host-loader micro-bench: disk canvas cache vs RAM cache vs cold.

The PyTorch port's host prep (``scda_tpu_torch.data.pipeline``, the same
rows as scripts/loader_bench.py): over a synthetic split LARGER than the
RAM cache budget, the RAM u8 cache thrashes and decodes every image
every epoch, while the disk-backed preprocessed store serves canvases
from the second epoch on.  Compare its rates with the card's train rate
at the same batch size (``chip_smoke.py`` reads both in one run).  It
prints the host's CPU count first: the rates scale with the cores.

Usage: python scripts_torch/loader_bench.py [--images 48] [--epochs 3]
       [--size 1024 2048] [--cache_mb 64]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=48)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--size", type=int, nargs=2, default=(1024, 2048))
    p.add_argument("--cache_mb", type=int, default=64,
                   help="RAM cache budget — deliberately smaller than "
                        "the split so the RAM path thrashes")
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--workers", type=int, default=1,
                   help="decode threads; keep 1 on single-core hosts "
                        "(more threads oversubscribe the core)")
    args = p.parse_args()
    print(f"host: {os.cpu_count()} CPUs", flush=True)

    from scda_tpu_torch.config import DataConfig
    from scda_tpu_torch.data.pipeline import DataLoader
    from scda_tpu_torch.data.synthetic import make_memory_dataset

    root = tempfile.mkdtemp(prefix="scda_loaderbench_")
    try:
        print(f"generating {args.images} {args.size[0]}x{args.size[1]} "
              "scenes...", flush=True)
        ds = make_memory_dataset(
            num_images=args.images, image_size=tuple(args.size),
            tmpdir=os.path.join(root, "imgs"),
        )

        def run(tag, **cfg_kw):
            cfg = DataConfig(image_size=(512, 1024), scale=600,
                             max_size=1000, cache_mb=args.cache_mb,
                             num_workers=args.workers, **cfg_kw)
            loader = DataLoader(ds, cfg, args.bs, shuffle=True,
                                augment_flip=True, seed=0)
            rates = []
            for ep in range(args.epochs):
                n = 0
                t0 = time.perf_counter()
                for b in loader:
                    n += b.image.shape[0]
                rates.append(n / (time.perf_counter() - t0))
            print(f"{tag:28s} " + "  ".join(
                f"ep{i}: {r:6.1f} img/s" for i, r in enumerate(rates)),
                flush=True)
            return rates

        run("RAM u8 cache (thrashing)")
        run("disk canvas cache",
            canvas_cache_dir=os.path.join(root, "ccache"))
        store = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(os.path.join(root, "ccache"))
            for f in fs)
        split = sum(os.path.getsize(rec.image_path) for rec in ds.records)
        print(f"store: {store / 1e6:.0f} MB for a {split / 1e6:.0f} MB "
              f"source split ({args.images} images)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()

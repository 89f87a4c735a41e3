#!/usr/bin/env python3
"""Times the ResNet-101 multiscale train step and joint SCDA step of a
checkout on one GPU.

    python3 res101_steps.py [CHECKOUT] [TAG]

CHECKOUT (default: the directory of this file) is a checkout of the
repository whose ``scda_tpu_torch`` and ``chip_smoke.py`` run.  Through
that ``chip_smoke.py``'s ``Port.train_run`` (``cfgs/res101_ms.yml``, bf16,
bs 1, 512x1024, seeded frames), with the launch gates of that checkout:
the source-only step (``init_weights``, 2 warm-up and 10 timed steps) and
the joint SCDA step (``init_params``, fogged target frames, 2 + 10
steps).  For each it prints ``chip_smoke.py``'s ``train`` line (img/s,
peak memory, launches per step) and ``profile`` line (device time per
step by kind of kernel, busy share); TAG names the runs.  To compare two
versions of the port, unpack the older one into a git-ignored directory
(``git archive <commit> | tar -x -C .chipwork/base``) and run this file
for each in turn in one call on one card: base, new, new, base.  It
imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys


def main(argv) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.abspath(argv[0]) if argv else here
    tag = argv[1] if len(argv) > 1 else os.path.basename(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)

    import torch

    if not torch.cuda.is_available():
        print("res101_steps.py: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from scda_tpu_torch.utils.numerics import set_card_numerics

    set_card_numerics()
    from scda_tpu_torch.ops.kernels import _build

    _build.build()
    _build.lib()
    port = cs.Port(torch)
    device = torch.device("cuda", 0)
    frames = cs.make_frames(port.serving_cfgs("vgg16")[0], cs.N_FRAMES,
                            seed=1)
    _, cfg16 = port.train_cfgs("res101", 1,
                               os.path.join("cfgs", "res101_ms.yml"))
    # Launches per step; an older checkout may have no K4 backward wrapper.
    has_bwd = "bottleneck_chain_bwd" in port.wrappers

    want = {k: 0 for k in port.wrappers}
    want.update(nms=1, roi_align=2, roi_align_bwd=2, bottleneck_chain=3)
    if has_bwd:
        want["bottleneck_chain_bwd"] = 2
    model = port.train_model(cfg16, device)
    port.train_run(cfg16, model, port.train_batches(frames, 1, device),
                   f"res101_steps_train_{tag}", 2, 10, want)
    del model
    torch.cuda.empty_cache()

    cfg = port.replace_path(cfg16, "adapt.enabled", True)
    want = {k: 0 for k in port.wrappers}
    want.update(nms=2, roi_align=4, roi_align_bwd=4, bottleneck_chain=6)
    if has_bwd:
        want["bottleneck_chain_bwd"] = 4
    model = port.build_model(cfg.model, cfg.anchors.num_anchors,
                             device="cpu")
    port.init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    model = model.to(device)
    tgt = port.train_batches(
        cs.make_frames(cfg, 2, seed=2, fog=cs.TARGET_FOG)[:2], 1, device)
    port.train_run(cfg, model, port.train_batches(frames, 1, device),
                   f"res101_steps_scda_{tag}", 2, 10, want, tgt_batches=tgt)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

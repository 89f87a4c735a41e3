"""``mfu.train``: the model FLOP/s of the untraced window's train or SCDA
steps over the bf16 peak, in %: source images/s x the model's FLOPs per
source image (``flops.py``: the model's own work, no recomputation) /
989 TFLOP/s."""

from benchmark.metrics import flops, roofline


def read(run):
    if run.kind not in ("train", "scda"):
        return None
    canvas = tuple(run.cfg.data.image_size)
    count = (flops.scda_step_flops_per_src_image if run.kind == "scda"
             else flops.train_flops_per_image)
    try:
        per_image = count(run.cfg, canvas)
    except (KeyError, ValueError):   # a backbone the FLOP count lacks
        return None
    return roofline.mfu_pct(run.img_per_s, per_image)

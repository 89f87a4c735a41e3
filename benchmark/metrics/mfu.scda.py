"""``mfu.scda``: the SCDA step's model FLOPs over the device's busy time,
as a share of the bf16 peak, in %: the model's FLOPs per source image
(``flops.py``: its own work, no recomputation) x the source images of
the traced units / the seconds in which the device ran their work
(``busy_s``) / 989 TFLOP/s.  It bounds ``device_ms_per_img`` from
below: that time is at least the FLOPs over the peak."""

from benchmark.metrics import flops, roofline


def read(run):
    if run.kind != "scda" or not run.trace["busy_s"]:
        return None
    canvas = tuple(run.cfg.data.image_size)
    try:
        per_image = flops.scda_step_flops_per_src_image(run.cfg, canvas)
    except (KeyError, ValueError):   # a backbone the FLOP count lacks
        return None
    images = run.units * run.images_per_unit
    return roofline.mfu_pct(images / run.trace["busy_s"], per_image)

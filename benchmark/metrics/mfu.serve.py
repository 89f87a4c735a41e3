"""``mfu.serve``: the model FLOP/s of the untraced window's served images
over the bf16 peak, in %: images/s x the forward's FLOPs per image
(``flops.py``, test settings) / 989 TFLOP/s."""

from benchmark.metrics import flops, roofline


def read(run):
    if run.kind != "serve":
        return None
    canvas = tuple(run.cfg.data.image_size)
    try:
        per_image = flops.inference_flops_per_image(run.cfg, canvas)
    except (KeyError, ValueError):   # a backbone the FLOP count lacks
        return None
    return roofline.mfu_pct(run.img_per_s, per_image)

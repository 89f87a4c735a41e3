"""``launches_per_img.train``: device operations (kernels, copies, fills)
launched per image, counted exactly in the traced units."""


def read(run):
    if run.kind not in ("train", "scda"):
        return None
    s = run.trace["summary"]
    if "error" in s:
        return None
    return s["kernels_per_unit"] / run.images_per_unit

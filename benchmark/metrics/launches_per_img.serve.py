"""``launches_per_img.serve``: device operations (kernels, copies, fills)
launched per image, counted exactly in the traced units."""


def read(run):
    if run.kind not in ("serve",):
        return None
    s = run.trace["summary"]
    if "error" in s:
        return None
    return s["kernels_per_unit"] / run.images_per_unit

"""``launches_per_img.scda``: device operations (kernels, copies, fills)
launched per source image of an SCDA step, counted exactly in the traced
units.  Each launch costs the device time of its own beside the host's."""


def read(run):
    if run.kind != "scda":
        return None
    s = run.trace["summary"]
    if "error" in s:
        return None
    return s["kernels_per_unit"] / run.images_per_unit

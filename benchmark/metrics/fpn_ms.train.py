"""``fpn_ms.train``: the device ms of the feature pyramid per image: the
work launched inside the program's ``scda.fpn`` spans (the laterals, the
top-down adds, the output convs and P6; their backward runs later, in
``scda.backward``) over the traced units' images.  Nothing where the
program opened no such span."""


def read(run):
    ms = run.trace.get("span_ms", {}).get("scda.fpn")
    if run.kind != "train" or ms is None:
        return None
    return ms / (run.units * run.images_per_unit)

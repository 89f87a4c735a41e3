"""``rpn_levels_ms.train``: the device ms of the RPN over the pyramid per
image: the work launched inside the program's ``scda.rpn`` spans (the
shared head on every level, and the levels' anchors) and ``scda.propose``
spans (each level's proposal call, and the collect) over the traced
units' images.  Nothing where the program opened neither span."""


def read(run):
    spans = run.trace.get("span_ms", {})
    if run.kind != "train" or not {"scda.rpn", "scda.propose"} & set(spans):
        return None
    ms = spans.get("scda.rpn", 0.0) + spans.get("scda.propose", 0.0)
    return ms / (run.units * run.images_per_unit)

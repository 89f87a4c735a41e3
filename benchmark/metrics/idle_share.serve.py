"""``idle_share.serve``: the share of the wall time in which the device ran
no kernel, in %: 1 - (device kernel time of the traced units / their
wall time in the untraced window), as ``profile.summarize`` computes
the busy share."""


def read(run):
    if run.kind not in ("serve",):
        return None
    s = run.trace["summary"]
    if "error" in s:
        return None
    return 100.0 * (1.0 - s["device_busy_share"])

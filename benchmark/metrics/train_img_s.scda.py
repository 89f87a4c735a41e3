"""``train_img_s.scda``: ``train_img_s`` of an SCDA cell, read per layer:
the source images of every step in the untraced window over its length
(host clock).  An SCDA step at batch 1 is paced by the host, whose speed
swings from run to run, so there it is not held to a bound; the cell's
end-to-end metric is ``device_ms_per_img``."""


def read(run):
    if run.kind != "scda":
        return None
    return run.img_per_s

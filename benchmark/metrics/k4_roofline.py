"""``k4_roofline``: the identity tails' forward share of its roofline in
serving, in %.

Bound: ``roofline.chain_bound`` at each call's shapes (layer1 to layer3).
Time: the device time of the kernels launched inside the ``bench.chain``
range around the call site ``models.backbones.resnet.bottleneck_chain``,
per unit; where the trace ties no kernel to the range, the kernels that
``profile.PORT_KERNELS`` names ``K4 bottleneck_chain``."""

from benchmark.metrics import roofline


def read(run):
    if run.kind != "serve" or not run.chain_calls:
        return None
    bound = sum(roofline.chain_bound(c["x"], c["w1"])["bound_ms"]
                for c in run.chain_calls) / run.units
    ms = run.trace["range_ms"].get("bench.chain", 0.0) / run.units
    if ms <= 0:
        port = run.trace["summary"].get("port_kernels", {})
        ms = port.get("K4 bottleneck_chain", {}).get("ms_per_unit", 0.0)
    return roofline.share_pct(bound, ms)

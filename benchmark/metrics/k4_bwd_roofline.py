"""``k4_bwd_roofline``: the identity-tail gradients' share of their
roofline, in %.

Bound: for each ResNet identity tail whose gradients the step needs
(layer2 and layer3; layer1 is frozen), ``roofline.chain_bwd_bound`` at
the call's shapes: the gradients' own work at the bf16 peak.  Time: the
device time of the kernels launched by the autograd node that the call
site ``models.backbones.resnet.bottleneck_chain`` created (the
``bench.chain_bwd`` range), per step; where the trace ties no kernel to
the range, the kernels that ``profile.PORT_KERNELS`` names
``K4 bottleneck_chain_bwd``."""

from benchmark.metrics import roofline


def read(run):
    calls = [c for c in run.chain_calls if c["backward"]]
    if not calls:
        return None
    bound = sum(roofline.chain_bwd_bound(c["x"], c["w1"])["bound_ms"]
                for c in calls) / run.units
    ms = run.trace["range_ms"].get("bench.chain_bwd", 0.0) / run.units
    if ms <= 0:
        port = run.trace["summary"].get("port_kernels", {})
        ms = port.get("K4 bottleneck_chain_bwd", {}).get("ms_per_unit", 0.0)
    return roofline.share_pct(bound, ms)

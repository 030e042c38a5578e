"""feat.composite_bwd_roofline: the joint composite backward's bound at
3 + D channels (counts.composite_bwd_bound_s) over the device time a step
of its two passes, the geometry and the colour."""
from benchmark.metrics.counts import composite_bwd_bound_s, share


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None or not layer.get("feature_dim"):
        return None
    t = layer["trace"].kernel_s("composite_bwd_kernel")
    return share(composite_bwd_bound_s(layer["counts"], layer["channels"], layer["pixels"]),
                 t / layer["steps"])

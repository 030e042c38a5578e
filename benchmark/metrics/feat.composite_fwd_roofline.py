"""feat.composite_fwd_roofline: the joint composite forward's bound at
3 + D channels (counts.composite_fwd_bound_s) over the device time a step
of its two kernels, the walk and the contraction."""
from benchmark.metrics.counts import composite_fwd_bound_s, share


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None or not layer.get("feature_dim"):
        return None
    t = layer["trace"].kernel_s("composite_fwd_kernel", "composite_fwd_contract_kernel")
    return share(composite_fwd_bound_s(layer["counts"], layer["channels"], layer["pixels"]),
                 t / layer["steps"])

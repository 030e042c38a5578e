"""train.composite_bwd_roofline: the composite backward kernel's bound for
the traced steps' views (counts.composite_bwd_bound_s) over its device
time a step."""
from benchmark.metrics.counts import composite_bwd_bound_s, share


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None:
        return None
    t = layer["trace"].kernel_s("composite_bwd_kernel")
    return share(composite_bwd_bound_s(layer["counts"], layer["channels"], layer["pixels"]),
                 t / layer["steps"])

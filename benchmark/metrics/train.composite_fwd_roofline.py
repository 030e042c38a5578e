"""train.composite_fwd_roofline: the composite forward kernel's bound for
the traced steps' views (counts.composite_fwd_bound_s) over its device
time a step."""
from benchmark.metrics.counts import composite_fwd_bound_s, share


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None:
        return None
    t = layer["trace"].kernel_s("composite_fwd_kernel", "composite_fwd_contract_kernel")
    return share(composite_fwd_bound_s(layer["counts"], layer["channels"], layer["pixels"]),
                 t / layer["steps"])

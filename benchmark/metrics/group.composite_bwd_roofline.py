"""group.composite_bwd_roofline: the composite backward's bound at 3 + D
channels (counts.composite_bwd_bound_s, C = 19 at Gaussian Grouping's 16)
over the device time a step of its kernels (`composite_bwd_kernel*`, the
wide one above 8 channels)."""
from benchmark.metrics.counts import composite_bwd_bound_s, share


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None or not layer.get("num_objects"):
        return None
    t = layer["trace"].kernel_s("composite_bwd_kernel")
    return share(composite_bwd_bound_s(layer["counts"], layer["channels"], layer["pixels"]),
                 t / layer["steps"])

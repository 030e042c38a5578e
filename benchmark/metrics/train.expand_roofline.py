"""train.expand_roofline: the pair expand's bound (32 bytes a dense
Gaussian, 12 a budget slot, counts.expand_bound_s) over the device time of
its kernel a step."""
from benchmark.metrics.counts import expand_bound_s, share


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None:
        return None
    t = layer["trace"].kernel_s("expand_kernel")
    return share(expand_bound_s(layer["counts"]["dense"], layer["budget"]), t / layer["steps"])

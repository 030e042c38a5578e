"""feat.segsum_roofline: the segment sum's bound at the joint width (the
live pairs' rows of 6 + 3 + D floats into one row a Gaussian,
counts.segsum_bound_s) over the device time of its kernels a step."""
from benchmark.metrics.counts import segsum_bound_s, share


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None or not layer.get("feature_dim"):
        return None
    t = layer["trace"].kernel_s("segsum_kernel", "bump_epoch")
    c = layer["counts"]
    return share(segsum_bound_s(c["live"], layer["gaussians"] + 1, 6 + layer["channels"]),
                 t / layer["steps"])

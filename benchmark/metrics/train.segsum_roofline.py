"""train.segsum_roofline: the segment sum's bound (the live pairs' gradient
rows of 6 + C floats into one row a Gaussian, counts.segsum_bound_s) over
the device time of its kernels a step."""
from benchmark.metrics.counts import segsum_bound_s, share


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("trace") is None:
        return None
    t = layer["trace"].kernel_s("segsum_kernel", "bump_epoch")
    c = layer["counts"]
    return share(segsum_bound_s(c["live"], layer["gaussians"] + 1, 6 + layer["channels"]),
                 t / layer["steps"])

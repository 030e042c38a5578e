"""distill.data_ms: host milliseconds a step in the dataset's item (the
elastic distortion, voxelization and cut), timed by the benchmark's
wrapper around the dataset it hands to train_distill, over the traced
window's steps."""


def read(rec):
    layer = rec.get("layer")
    if not layer or layer.get("item_ms") is None:
        return None
    return layer["item_ms"]

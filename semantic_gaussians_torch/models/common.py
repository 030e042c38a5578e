"""Helpers shared by the port's 2D model towers.

  * `resize_bilinear`: the JAX package's `jax.image.resize(..., "linear")`
    (half-pixel centres, antialiased when shrinking) as one
    `F.interpolate` call.
  * `random_init_`: seeded random weights for a tower (tests and the
    smoke run build towers at their published widths without checkpoints).
  * `load_torch_state_dict`: a checkpoint file -> {name: tensor} (a plain
    or Lightning state dict or a TorchScript archive).
  * `float32_state`: a state dict's floating-point entries in float32, as
    every tower built from a state dict holds them.
  * `tensor_tree`: a tree of numpy arrays (the JAX package's variables)
    as float32 tensors, the input of every tower's `state_from_flax`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the last two axes of x (N, C, H, W) to `size` (h, w) as
    `jax.image.resize(method="linear")` does: align_corners=False with an
    antialiasing triangle filter where an axis shrinks (without
    `antialias=True` a shrinking resize is 0.2-0.5 off on [0, 1] images)."""
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear",
                         align_corners=False, antialias=True)


def random_init_(module: torch.nn.Module, seed: int = 0, std: float = 0.02,
                 scales: dict | None = None) -> torch.nn.Module:
    """Fill every parameter and buffer of `module` from a seeded CPU
    generator, in state-dict order: a 1-D `*.weight` (a norm's scale) gets
    1 + N(0, std), a `running_var` 1 + |N(0, std)|, every other float entry
    N(0, s) with s = `scales[suffix]` for the first matching name suffix,
    else `std`; integer entries (BatchNorm's count) 0. The same seed gives
    the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    scales = scales or {}
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if not t.is_floating_point():
                t.zero_()
                continue
            s = next((v for k, v in scales.items() if name.endswith(k)), std)
            val = torch.randn(t.shape, generator=gen) * s
            if name.endswith("running_var"):
                val = 1.0 + val.abs()
            elif name.endswith(".weight") and t.ndim == 1:
                val = 1.0 + val
            t.copy_(val.to(t.dtype))
    return module


def float32_state(sd) -> dict:
    """sd with its floating-point entries cast to float32: OpenAI's CLIP
    files hold float16 weights, and the towers run on float32 inputs as
    the JAX package's do (its converters cast every weight to float32)."""
    return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}


def load_torch_state_dict(path, *, full_unpickle: bool = False) -> dict:
    """{name: CPU tensor} from a checkpoint file: a state dict, a Lightning
    checkpoint (its "state_dict") or a TorchScript archive (the OpenAI CLIP
    .pt files). Pickles load with `weights_only=True` (plus
    argparse.Namespace, which holds saved hyper-parameters); a file that
    needs more raises, unless `full_unpickle` (LSeg's Lightning checkpoint,
    whose hyper-parameters and callbacks may pickle library classes) loads
    it in full with a warning."""
    import argparse
    import pickle
    import warnings
    import zipfile

    path = str(path)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            scripted = any(n.endswith("/constants.pkl") for n in z.namelist())
    else:
        scripted = False
    if scripted:
        obj = torch.jit.load(path, map_location="cpu")
    else:
        try:
            with torch.serialization.safe_globals([argparse.Namespace]):
                obj = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as err:
            if not full_unpickle:
                raise
            warnings.warn(f"{path} pickles more than tensors ({str(err).splitlines()[0]}); "
                          "loading it in full as a trusted local file")
            obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def tensor_tree(tree):
    """A nested dict of array-likes (flax variables) -> the same nesting of
    float32 CPU tensors."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: tensor_tree(v) for k, v in tree.items()}
    import numpy as np

    return torch.from_numpy(np.array(tree, dtype=np.float32))

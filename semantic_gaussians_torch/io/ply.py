"""Binary PLY I/O — reference-compatible Gaussian checkpoints, in numpy.

Port of semantic_gaussians_tpu.io.ply (the codec that package falls back to
without its native library). binary_little_endian 1.0, one `vertex` element:
  x y z nx ny nz f_dc_0..2 f_rest_0..(3K-4) opacity scale_0..2 rot_0..3
with f_rest stored CHANNEL-major. `load_gaussian_ply` returns numpy arrays;
`core.gaussians.params_from_numpy` carries them onto a device.
`load_point_cloud` / `save_point_cloud` read and write the scenes'
initial point clouds (x y z, nx ny nz, uchar red green blue).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.gaussians import GaussianParams, round_capacity

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}
_CANONICAL = ["float", "double", "uchar", "char", "short", "ushort", "int", "uint"]


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read a binary/ascii PLY -> {element_name: structured ndarray}."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header if l.startswith("format")).split()[1]
        elements = []  # (name, count, [(prop_name, dtype), ...])
        cur = None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property" and cur is not None:
                if parts[1] == "list":
                    raise NotImplementedError("list properties not supported")
                cur[2].append((parts[2], _PLY_DTYPES[parts[1]]))
        out = {}
        for name, count, props in elements:
            dt = np.dtype([(p, t) for p, t in props])
            if fmt == "ascii":
                arr = np.zeros(count, dtype=dt)
                for i in range(count):
                    row = f.readline().split()
                    for (p, _), v in zip(props, row):
                        arr[p][i] = float(v)
            else:
                arr = np.frombuffer(f.read(count * dt.itemsize), dtype=dt)
            out[name] = arr
        return out


def write_ply(path, vertex: np.ndarray, element: str = "vertex"):
    """Write one structured array as binary_little_endian PLY."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    rev = {_PLY_DTYPES[k]: k for k in _CANONICAL}
    with open(path, "wb") as f:
        lines = ["ply", "format binary_little_endian 1.0",
                 f"element {element} {len(vertex)}"]
        for name in vertex.dtype.names:
            t = vertex.dtype[name].newbyteorder("<").str.lstrip("|<>")
            lines.append(f"property {rev.get('<' + t, rev.get(t, 'float'))} {name}")
        lines.append("end_header")
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(vertex.astype(vertex.dtype.newbyteorder("<")).tobytes())


def save_gaussian_ply(path, params: GaussianParams, alive: Optional[np.ndarray] = None):
    """Write alive Gaussians in the reference's attribute layout."""
    arrays = params.to_numpy()
    cap = arrays["means"].shape[0]
    sel = np.ones(cap, bool) if alive is None else np.asarray(alive, bool)
    xyz = np.asarray(arrays["means"])[sel]
    n = xyz.shape[0]
    f_dc = np.asarray(arrays["sh_dc"])[sel]  # (n, 1, 3)
    f_rest = np.asarray(arrays["sh_rest"])[sel]  # (n, K-1, 3)
    k1 = f_rest.shape[1]
    fields = [(c, "<f4") for c in ("x", "y", "z", "nx", "ny", "nz")]
    fields += [(f"f_dc_{i}", "<f4") for i in range(3)]
    fields += [(f"f_rest_{i}", "<f4") for i in range(3 * k1)]
    fields += [("opacity", "<f4")]
    fields += [(f"scale_{i}", "<f4") for i in range(3)]
    fields += [(f"rot_{i}", "<f4") for i in range(4)]
    v = np.zeros(n, dtype=np.dtype(fields))
    v["x"], v["y"], v["z"] = xyz.T
    dc = f_dc.transpose(0, 2, 1).reshape(n, 3)  # channel-major
    for i in range(3):
        v[f"f_dc_{i}"] = dc[:, i]
    rest = f_rest.transpose(0, 2, 1).reshape(n, 3 * k1)  # channel-major
    for i in range(3 * k1):
        v[f"f_rest_{i}"] = rest[:, i]
    v["opacity"] = np.asarray(arrays["opacity_logits"])[sel, 0]
    sc = np.asarray(arrays["log_scales"])[sel]
    for i in range(3):
        v[f"scale_{i}"] = sc[:, i]
    q = np.asarray(arrays["quats"])[sel]
    for i in range(4):
        v[f"rot_{i}"] = q[:, i]
    write_ply(path, v)


def load_gaussian_ply(
    path, capacity: Optional[int] = None
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Load a reference-format Gaussian PLY -> (GaussianParams fields as
    float32 numpy arrays padded to `capacity`, alive mask)."""
    v = read_ply(path)["vertex"]
    names = v.dtype.names
    n = len(v)
    cols = {p: np.asarray(v[p], np.float32) for p in names}

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1)
    dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=-1)
    rest_names = sorted(
        [p for p in names if p.startswith("f_rest_")],
        key=lambda s: int(s.split("_")[-1]),
    )
    k1 = len(rest_names) // 3
    rest = np.stack([cols[p] for p in rest_names], axis=-1).reshape(n, 3, k1)
    rest = rest.transpose(0, 2, 1)  # -> (n, K-1, 3)
    scales = np.stack([cols[f"scale_{i}"] for i in range(3)], axis=-1)
    quats = np.stack([cols[f"rot_{i}"] for i in range(4)], axis=-1)

    cap = capacity or round_capacity(n)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    arrays = dict(
        means=pad(xyz),
        sh_dc=pad(dc[:, None, :]),
        sh_rest=pad(rest),
        log_scales=pad(scales),
        quats=pad(quats),
        opacity_logits=pad(cols["opacity"][:, None], fill=-20.0),
    )
    return arrays, np.arange(cap) < n


# --------------------------------------------------------------------------
# Point clouds (COLMAP points3D.ply / scene init)
# --------------------------------------------------------------------------
def load_point_cloud(path):
    """(points [N,3], colors [N,3] in 0..1, normals [N,3]) from a PLY."""
    v = read_ply(path)["vertex"]
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    names = v.dtype.names
    if "red" in names:
        cols = (
            np.stack([v["red"], v["green"], v["blue"]], axis=-1).astype(np.float32)
            / 255.0
        )
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in names:
        nrm = np.stack([v["nx"], v["ny"], v["nz"]], axis=-1).astype(np.float32)
    else:
        nrm = np.zeros_like(pts)
    return pts, cols, nrm


def save_point_cloud(path, points, colors=None, normals=None):
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
              ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
              ("red", "u1"), ("green", "u1"), ("blue", "u1")]
    v = np.zeros(n, dtype=np.dtype(fields))
    v["x"], v["y"], v["z"] = np.asarray(points, np.float32).T
    if normals is not None:
        v["nx"], v["ny"], v["nz"] = np.asarray(normals, np.float32).T
    if colors is not None:
        c = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
        v["red"], v["green"], v["blue"] = c.T
    write_ply(path, v)

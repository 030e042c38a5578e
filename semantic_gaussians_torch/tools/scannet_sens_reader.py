"""Export a ScanNet .sens capture to the layout the ScanNet scene loader
reads (io/scene.py: color/ depth/ pose/ intrinsic/).

The port's own copy of the repo's tools/scannet_sens_reader.py (itself
derived from the public ScanNet SensReader), with the same flags, defaults
and output, file for file and byte for byte: every `frame_skip`-th frame's
colour as `color/<i>.jpg` (JPEG quality 95, resized with nearest), its
depth as a true 16-bit `depth/<i>.png` (the capture's `depth_shift` units,
millimetres in ScanNet), its camera-to-world pose as `pose/<i>.txt` (`%f`),
and the four `intrinsic/*.txt` matrices. Host work only (numpy, PIL,
zlib): it takes no device. A compression it cannot decode raises; no
frame is skipped.

    python -m semantic_gaussians_torch.tools.scannet_sens_reader \\
        --input_path <scans>/scene0000_00 --output_path <scenes>/scene0000_00 \\
        [--export_width 648 --export_height 484 --frame_skip 5] [--not_export_*]

.sens v4 container layout (all little-endian):
  u32 version; u64 strlen; char[strlen] sensor_name;
  f32[16] intrinsic_color, extrinsic_color, intrinsic_depth, extrinsic_depth;
  i32 color_compression; i32 depth_compression;
  u32 color_w, color_h, depth_w, depth_h; f32 depth_shift; u64 num_frames;
  then per frame:
  f32[16] camera_to_world; u64 ts_color, ts_depth;
  u64 color_nbytes, depth_nbytes; bytes color; bytes depth.
"""
from __future__ import annotations

import argparse
import io
import struct
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

COLOR_COMPRESSION = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
DEPTH_COMPRESSION = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}

_FRAME_HEAD = struct.Struct("<16f2Q2Q")


class SensFrame:
    """One frame: its camera-to-world pose [4, 4] float32 and its colour
    and depth payloads, still compressed."""

    __slots__ = ("camera_to_world", "color_data", "depth_data")

    def __init__(self, camera_to_world, color_data, depth_data):
        self.camera_to_world = camera_to_world
        self.color_data = color_data
        self.depth_data = depth_data


class SensFile:
    """A .sens v4 file, read in one pass: the header's fields as
    attributes and `frames`, a list of SensFrame."""

    def __init__(self, path):
        with open(path, "rb") as f:
            (version,) = struct.unpack("<I", f.read(4))
            if version != 4:
                raise ValueError(f".sens version {version}, expected 4")
            (strlen,) = struct.unpack("<Q", f.read(8))
            self.sensor_name = f.read(strlen).decode("ascii", "replace")
            mats = np.frombuffer(f.read(4 * 16 * 4), np.float32).reshape(4, 4, 4)
            (self.intrinsic_color, self.extrinsic_color,
             self.intrinsic_depth, self.extrinsic_depth) = (m.copy() for m in mats)
            cc, dc = struct.unpack("<ii", f.read(8))
            self.color_compression = COLOR_COMPRESSION[cc]
            self.depth_compression = DEPTH_COMPRESSION[dc]
            (self.color_width, self.color_height,
             self.depth_width, self.depth_height) = struct.unpack("<4I", f.read(16))
            (self.depth_shift,) = struct.unpack("<f", f.read(4))
            (num_frames,) = struct.unpack("<Q", f.read(8))
            self.frames = []
            for _ in range(num_frames):
                head = _FRAME_HEAD.unpack(f.read(_FRAME_HEAD.size))
                c2w = np.asarray(head[:16], np.float32).reshape(4, 4)
                color_n, depth_n = head[18], head[19]
                self.frames.append(SensFrame(c2w, f.read(color_n), f.read(depth_n)))

    def decode_color(self, frame) -> Image.Image:
        if self.color_compression != "jpeg":
            raise NotImplementedError(self.color_compression)
        return Image.open(io.BytesIO(frame.color_data)).convert("RGB")

    def decode_depth(self, frame) -> np.ndarray:
        """[depth_height, depth_width] uint16 in `depth_shift` units."""
        if self.depth_compression != "zlib_ushort":
            raise NotImplementedError(self.depth_compression)
        raw = zlib.decompress(frame.depth_data)
        return np.frombuffer(raw, np.uint16).reshape(self.depth_height, self.depth_width)


def _write_mat(mat, path):
    with open(path, "w") as f:
        for row in np.asarray(mat):
            f.write(" ".join(f"{v:f}" for v in row) + "\n")


def _scaled_intrinsic(K, out_w, out_h, in_w, in_h):
    """Rescale fx, cx (row 0) and fy, cy (row 1) for an export of
    `out_w` x `out_h`.

    This is the reference's formula, kept as it is: it scales row 0 by
    (out_w - 0.5) / (2 cx) and row 1 by (out_h - 0.5) / (2 cy), that is,
    it takes the stored principal point for half the source extent and
    ignores `in_w` / `in_h`."""
    K = np.array(K, np.float32)
    K[0] = K[0] * (out_w - 0.5) / (K[0, 2] * 2)
    K[1] = K[1] * (out_h - 0.5) / (K[1, 2] * 2)
    return K


def export(sens: SensFile, out: Path, size=None, frame_skip=1,
           color=True, depth=True, poses=True, intrinsics=True):
    """Write every `frame_skip`-th frame of `sens` under `out`. `size` =
    (height, width) of the exported colour and depth images, or None for
    each one's native resolution."""
    idxs = range(0, len(sens.frames), frame_skip)
    if color:
        d = out / "color"
        d.mkdir(parents=True, exist_ok=True)
        for i in idxs:
            img = sens.decode_color(sens.frames[i])
            if size is not None:
                img = img.resize((size[1], size[0]), Image.NEAREST)
            img.save(d / f"{i}.jpg", quality=95)
    if depth:
        d = out / "depth"
        d.mkdir(parents=True, exist_ok=True)
        for i in idxs:
            dep = sens.decode_depth(sens.frames[i])
            im = Image.fromarray(dep.astype(np.int32))  # mode I
            if size is not None:
                im = im.resize((size[1], size[0]), Image.NEAREST)
            np16 = np.asarray(im, np.int32).astype(np.uint16)
            Image.fromarray(np16).save(d / f"{i}.png")  # mode I;16
    if poses:
        d = out / "pose"
        d.mkdir(parents=True, exist_ok=True)
        for i in idxs:
            _write_mat(sens.frames[i].camera_to_world, d / f"{i}.txt")
    if intrinsics:
        d = out / "intrinsic"
        d.mkdir(parents=True, exist_ok=True)
        ic, idp = sens.intrinsic_color, sens.intrinsic_depth
        if size is not None:
            h, w = size
            ic = _scaled_intrinsic(ic, w, h, sens.color_width, sens.color_height)
            idp = _scaled_intrinsic(idp, w, h, sens.depth_width, sens.depth_height)
        _write_mat(ic, d / "intrinsic_color.txt")
        _write_mat(sens.extrinsic_color, d / "extrinsic_color.txt")
        _write_mat(idp, d / "intrinsic_depth.txt")
        _write_mat(sens.extrinsic_depth, d / "extrinsic_depth.txt")


def main(argv=None):
    """Export `<input_path>/<scene>.sens` (the scene named by the input
    folder) to `--output_path`. Returns the SensFile read."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input_path", required=True,
                    help="scene folder containing <scene>.sens")
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--not_export_depth_images", dest="depth", action="store_false")
    ap.add_argument("--not_export_color_images", dest="color", action="store_false")
    ap.add_argument("--not_export_poses", dest="poses", action="store_false")
    ap.add_argument("--not_export_intrinsics", dest="intrinsics", action="store_false")
    ap.add_argument("--export_width", default=648, type=int)
    ap.add_argument("--export_height", default=484, type=int)
    ap.add_argument("--frame_skip", default=5, type=int)
    args = ap.parse_args(argv)

    inp = Path(args.input_path)
    scene = inp.name or inp.parent.name
    sens_path = inp / f"{scene}.sens"
    print(f"loading {sens_path} ...", flush=True)
    sens = SensFile(sens_path)
    print(f"{len(sens.frames)} frames, color {sens.color_width}x{sens.color_height}, "
          f"depth {sens.depth_width}x{sens.depth_height}, shift {sens.depth_shift}")
    export(
        sens, Path(args.output_path),
        size=(args.export_height, args.export_width),
        frame_skip=args.frame_skip,
        color=args.color, depth=args.depth,
        poses=args.poses, intrinsics=args.intrinsics,
    )
    return sens


if __name__ == "__main__":
    main()

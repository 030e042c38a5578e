"""Extract the label-filt PNGs of the exported frames of ScanNet scenes.

The port's own copy of the repo's tools/unzip_label_filt.py: for every
scene under --extract_root that has a color/ export (scannet_sens_reader),
pulls `label-filt/<frame>.png` out of
`<label_root>/<scene>/<scene>_2d-label-filt.zip` into the scene folder,
only for the frames that were exported (the frame_skip subset), not the
whole zip. A frame the zip lacks is named on one line and skipped, as the
root tool does. Host work only.

    python -m semantic_gaussians_torch.tools.unzip_label_filt \\
        --label_root <scans> --extract_root <scenes> [--split train]
"""
from __future__ import annotations

import argparse
import os
import traceback
import zipfile
from pathlib import Path


def extract_scene(scene_dir: Path, label_zip: Path) -> int:
    """Extract the label PNG of each frame in `scene_dir`/color from
    `label_zip`; returns how many were extracted."""
    imgs = sorted(os.listdir(scene_dir / "color"))
    n = 0
    with zipfile.ZipFile(label_zip, "r") as zf:
        for img in imgs:
            member = f"label-filt/{Path(img).stem}.png"
            try:
                zf.extract(member, scene_dir)
                n += 1
            except KeyError:
                print(f"{scene_dir.name}: missing {member}")
            except Exception:
                traceback.print_exc()
                print(scene_dir.name)
    return n


def main(argv=None) -> dict:
    """Extract every scene's labels. Returns {scene name: labels
    extracted} for the scenes that had a label zip."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label_root", required=True,
                    help="root holding <scene>/<scene>_2d-label-filt.zip")
    ap.add_argument("--extract_root", required=True,
                    help="root of exported scenes (each with color/)")
    ap.add_argument("--split", default="", help="optional subdir (train/val)")
    args = ap.parse_args(argv)

    ex_root = Path(args.extract_root) / args.split
    lb_root = Path(args.label_root) / args.split
    scenes = sorted(p for p in ex_root.iterdir() if (p / "color").is_dir())
    counts = {}
    for scene_dir in scenes:
        zip_path = lb_root / scene_dir.name / f"{scene_dir.name}_2d-label-filt.zip"
        if not zip_path.exists():
            print(f"{scene_dir.name}: no label zip at {zip_path}")
            continue
        counts[scene_dir.name] = extract_scene(scene_dir, zip_path)
        print(f"{scene_dir.name}: extracted {counts[scene_dir.name]} labels")
    return counts


if __name__ == "__main__":
    main()

"""Port parity: ScanNet scene preparation and the ScanNet path on the CPU.

A `.sens` v4 capture is written from a seed with numpy (8 frames, 64x48
JPEG colour, 32x24 zlib depth in millimetres, frame 5's pose all -inf as
ScanNet marks lost tracking), with a label-filt zip of 16-bit raw ids
above 255 and a scannetv2-labels TSV. On it: the port's `.sens` reader and
label-filt extractor against the root tools (every file's bytes equal, the
same printed lines); the port's scene loader against the JAX package's
(names, sizes, fovs, R and T bit for bit, the lost frame skipped, the
random-init points3d.ply equal); the port's fusion CLI with
`fusion.depth=image` against the JAX `fuse_scene` given the same depth
paths (the root CLI passes none and raises); the port's eval CLI against
the root eval_segmentation.py with the label-filt ground truth mapped
through the TSV (confusions equal, row sums equal to the ground truth's
class counts). `depth=image` without depth PNGs raises a ValueError that
names the missing file."""
import io
import pathlib
import shutil
import struct
import sys
import zipfile
import zlib
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from semantic_gaussians_tpu.io.ply import save_gaussian_ply as jax_save_ply  # noqa: E402
from semantic_gaussians_tpu.io.scene import load_scene as jax_load_scene  # noqa: E402
from semantic_gaussians_tpu.io.scene import realize_camera as jax_realize  # noqa: E402
from semantic_gaussians_tpu.models.predictors import (  # noqa: E402
    RandomFeatureProvider as JaxRandomProvider,
)
from semantic_gaussians_tpu.pipelines import fusion as jfusion  # noqa: E402
from semantic_gaussians_torch.cli import eval_segmentation as eval_cli  # noqa: E402
from semantic_gaussians_torch.cli import fusion as fusion_cli  # noqa: E402
from semantic_gaussians_torch.config.config import default_config_dir  # noqa: E402
from semantic_gaussians_torch.core.gaussians import params_from_numpy  # noqa: E402
from semantic_gaussians_torch.data.scannet_constants import SCANNET20_CLASS_LABELS  # noqa: E402
from semantic_gaussians_torch.io.ply import load_gaussian_ply as load_gaussian_ply_port  # noqa: E402
from semantic_gaussians_torch.io.scene import load_scene  # noqa: E402
from semantic_gaussians_torch.models.predictors import RandomFeatureProvider  # noqa: E402
from semantic_gaussians_torch.pipelines import fusion as tfusion  # noqa: E402
from semantic_gaussians_torch.pipelines.eval_segmentation import text_feature_matrix  # noqa: E402
from semantic_gaussians_torch.tools import scannet_sens_reader as port_reader  # noqa: E402
from semantic_gaussians_torch.tools import unzip_label_filt as port_unzip  # noqa: E402
from tools import scannet_sens_reader as root_reader  # noqa: E402
from tools import unzip_label_filt as root_unzip  # noqa: E402
from torch_port_common import (  # noqa: E402
    jax_params, np_, scene_arrays, torch_params, write_toy_blender_scene,
)

SCENE = "scene0000_00"
FRAMES, LOST = 8, 5
CW, CH, DW, DH = 64, 48, 32, 24
C = 16
K = len(SCANNET20_CLASS_LABELS)
# Raw label ids above 255: class t of the TSV is raw id RAW[t]; RAW_UNMAPPED
# lies inside the TSV's id range but has no row, raw 0 is ScanNet's
# "unannotated". Both map to unlabeled.
RAW = [300 + 37 * t for t in range(K)]
RAW_UNMAPPED = 300 + 37 * 7 + 5


def _c2w(pos, centre):
    """OpenCV camera-to-world (x right, y down, z forward) at `pos`,
    looking at `centre`."""
    fwd = (centre - pos) / np.linalg.norm(centre - pos)
    right = np.cross([0.0, -1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    m = np.eye(4)
    m[:3, :3] = np.stack([right, down, fwd], axis=1)
    m[:3, 3] = pos
    return m.astype(np.float32)


def _intrinsic(w, h, f):
    return np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


def write_capture(root, seed=0):
    """`<root>/<SCENE>/<SCENE>.sens`, its label-filt zip (frames 0..6; frame
    7 has no member, as a frame without annotation) and the TSV. The
    cameras sit on an arc 4 units from the cloud of `scene_arrays` (centred
    at z = 4) and look at it; depth is ~4 m with a smooth field of
    +-300 mm, 0 on a 2-pixel border and in one block. Returns the scan
    folder."""
    rng = np.random.default_rng(seed)
    scan = root / SCENE
    scan.mkdir(parents=True)
    buf = io.BytesIO()
    name = b"synthetic-structure-sensor"
    buf.write(struct.pack("<I", 4) + struct.pack("<Q", len(name)) + name)
    extr = np.eye(4, dtype=np.float32)
    for m in (_intrinsic(CW, CH, 50.0), extr, _intrinsic(DW, DH, 25.0), extr):
        buf.write(m.astype("<f4").tobytes())
    buf.write(struct.pack("<ii", 2, 1))  # jpeg colour, zlib_ushort depth
    buf.write(struct.pack("<4I", CW, CH, DW, DH))
    buf.write(struct.pack("<f", 1000.0))
    buf.write(struct.pack("<Q", FRAMES))
    centre = np.array([0.0, 0.0, 4.0])
    yy, xx = np.mgrid[0:DH, 0:DW]
    for i in range(FRAMES):
        ang = 0.5 * (i / (FRAMES - 1) - 0.5)
        pos = centre + 4.0 * np.array([np.sin(ang), 0.1 * (-1) ** i, -np.cos(ang)])
        c2w = np.full((4, 4), -np.inf, np.float32) if i == LOST else _c2w(pos, centre)
        buf.write(c2w.astype("<f4").tobytes() + struct.pack("<QQ", 1000 * i, 1000 * i + 7))
        img = rng.integers(0, 256, size=(CH, CW, 3), dtype=np.uint8)
        jb = io.BytesIO()
        Image.fromarray(img, "RGB").save(jb, format="JPEG", quality=90)
        phase = rng.uniform(0, 2 * np.pi, size=2)
        dep = 4000 + 300 * np.sin(xx / 5 + phase[0]) * np.cos(yy / 4 + phase[1])
        dep[:2], dep[-2:], dep[:, :2], dep[:, -2:] = 0, 0, 0, 0
        dep[8:12, 20:26] = 0
        depth = zlib.compress(dep.astype(np.uint16).tobytes())
        buf.write(struct.pack("<QQ", len(jb.getvalue()), len(depth)))
        buf.write(jb.getvalue() + depth)
    (scan / f"{SCENE}.sens").write_bytes(buf.getvalue())

    with zipfile.ZipFile(scan / f"{SCENE}_2d-label-filt.zip", "w") as zf:
        for i in range(FRAMES - 1):
            ids = rng.integers(0, K + 2, size=(CH // 6, CW // 8))
            raw = np.array(RAW + [RAW_UNMAPPED, 0], np.uint16)[ids]
            raw = np.repeat(np.repeat(raw, 12, 0), 16, 1)  # 2x the colour size
            b = io.BytesIO()
            Image.fromarray(raw).save(b, format="PNG")
            zf.writestr(f"label-filt/{i}.png", b.getvalue())
    rows = ["id\traw_category\tscannetid\tcocomapid"]
    rows += [f"{r}\traw{t}\t{t}\t{t}" for t, r in enumerate(RAW)]
    (scan / "scannetv2-labels.modified.tsv").write_text("\n".join(rows) + "\n")
    return scan


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return write_capture(tmp_path_factory.mktemp("scannet_capture") / "scans")


@pytest.fixture(scope="module")
def exported(capture, tmp_path_factory):
    """The capture exported by the port's reader at native size, every
    frame, with its label-filt PNGs extracted by the port's extractor and
    the TSV beside them (as a ScanNet scene folder holds it)."""
    out = tmp_path_factory.mktemp("scannet_export") / SCENE
    port_reader.export(port_reader.SensFile(capture / f"{SCENE}.sens"), out, size=None)
    port_unzip.extract_scene(out, capture / f"{SCENE}_2d-label-filt.zip")
    shutil.copy(capture / "scannetv2-labels.modified.tsv", out)
    return out


def _copy(scene, tmp_path):
    """A fresh copy of an exported scene (the loaders write points3d.ply
    into the scene they load)."""
    dst = tmp_path / SCENE
    shutil.copytree(scene, dst)
    return dst


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ---------------------------------------------------------------- the reader
@pytest.mark.parametrize("frame_skip", [1, 5])
@pytest.mark.parametrize("size", [None, (24, 32)], ids=["native", "24x32"])
def test_reader_matches_root_tool(capture, tmp_path, frame_skip, size):
    """export() of both tools on the same capture: the same files, byte for
    byte (JPEG at quality 95, 16-bit depth PNGs, %f poses and intrinsics)."""
    sens_path = capture / f"{SCENE}.sens"
    port, root = port_reader.SensFile(sens_path), root_reader.SensFile(sens_path)
    for key in ("sensor_name", "color_compression", "depth_compression", "color_width",
                "color_height", "depth_width", "depth_height", "depth_shift"):
        assert getattr(port, key) == getattr(root, key)
    for key in ("intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"):
        np.testing.assert_array_equal(getattr(port, key), getattr(root, key))
    port_reader.export(port, tmp_path / "port", size=size, frame_skip=frame_skip)
    root_reader.export(root, tmp_path / "root", size=size, frame_skip=frame_skip)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "root")
    frames = list(range(0, FRAMES, frame_skip))
    assert sorted(k for k in got if k.startswith("color/")) == sorted(
        f"color/{i}.jpg" for i in frames)
    assert got.keys() == want.keys() and len(got) == 3 * len(frames) + 4
    for k in got:
        assert got[k] == want[k], k
    dep = Image.open(tmp_path / "port" / "depth" / f"{frames[-1]}.png")
    assert dep.mode == "I;16" and dep.size == ((DW, DH) if size is None else size[::-1])
    assert np.isinf(np.loadtxt(tmp_path / "port" / "pose" / f"{LOST}.txt")).all()


def test_reader_main_matches_root_main(capture, tmp_path, capsys):
    """Both command lines on the same capture, with their flags: the same
    files and the same printed lines; the port's main returns the
    SensFile it read."""
    args = ["--input_path", str(capture), "--export_width", "40", "--export_height", "30",
            "--frame_skip", "3", "--not_export_poses"]
    with mock.patch.object(sys, "argv", ["scannet_sens_reader.py", *args,
                                         "--output_path", str(tmp_path / "root")]):
        root_reader.main()
    want_out = capsys.readouterr().out
    sens = port_reader.main([*args, "--output_path", str(tmp_path / "port")])
    assert capsys.readouterr().out == want_out
    assert len(sens.frames) == FRAMES
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "root")
    assert got == want and not any(k.startswith("pose/") for k in got)
    assert Image.open(tmp_path / "port" / "color" / "6.jpg").size == (40, 30)


def test_reader_raises_on_unknown_compression(capture, tmp_path):
    data = bytearray((capture / f"{SCENE}.sens").read_bytes())
    at = 4 + 8 + len(b"synthetic-structure-sensor") + 4 * 64
    data[at + 4:at + 8] = struct.pack("<i", 2)  # depth "occi_ushort"
    (tmp_path / "x.sens").write_bytes(bytes(data))
    sens = port_reader.SensFile(tmp_path / "x.sens")
    with pytest.raises(NotImplementedError, match="occi_ushort"):
        port_reader.export(sens, tmp_path / "out", color=False)


# ---------------------------------------------------------------- label-filt
def test_extractor_matches_root_tool(capture, tmp_path, capsys):
    """Both command lines over an export root: the exported frames' labels
    only (7 of the zip's 7 members for 8 exported frames), the same bytes,
    and the same printed lines, the missing member's among them."""
    sens = port_reader.SensFile(capture / f"{SCENE}.sens")
    for who in ("root", "port"):
        port_reader.export(sens, tmp_path / who / SCENE, size=(24, 32), frame_skip=1,
                           depth=False, poses=False, intrinsics=False)
        (tmp_path / who / "scene0001_00" / "color").mkdir(parents=True)  # no zip
    args = ["--label_root", str(capture.parent)]
    with mock.patch.object(sys, "argv", ["unzip_label_filt.py", *args,
                                         "--extract_root", str(tmp_path / "root")]):
        root_unzip.main()
    want_out = capsys.readouterr().out
    counts = port_unzip.main([*args, "--extract_root", str(tmp_path / "port")])
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert f"{SCENE}: missing label-filt/{FRAMES - 1}.png" in got_out.splitlines()
    assert "scene0001_00: no label zip at" in got_out
    assert counts == {SCENE: FRAMES - 1}
    got = _tree(tmp_path / "port" / SCENE / "label-filt")
    assert got == _tree(tmp_path / "root" / SCENE / "label-filt")
    assert sorted(got) == [f"{i}.png" for i in range(FRAMES - 1)]


def test_extractor_takes_only_exported_frames(capture, tmp_path):
    sens = port_reader.SensFile(capture / f"{SCENE}.sens")
    port_reader.export(sens, tmp_path / SCENE, size=(24, 32), frame_skip=5, depth=False,
                       poses=False, intrinsics=False)
    n = port_unzip.extract_scene(tmp_path / SCENE, capture / f"{SCENE}_2d-label-filt.zip")
    assert n == 2
    assert sorted(p.name for p in (tmp_path / SCENE / "label-filt").iterdir()) == [
        "0.png", "5.png"]
    lab = Image.open(tmp_path / SCENE / "label-filt" / "5.png")
    assert lab.mode == "I;16" and int(np.asarray(lab).max()) > 255


# ---------------------------------------------------------------- the loader
@pytest.mark.parametrize("eval_split", [False, True], ids=["all", "llff_hold"])
def test_load_scene_matches_jax(exported, tmp_path, eval_split):
    """The port's load_scene and the JAX package's on two copies of the
    export: the same cameras (the lost frame skipped), R and T bit for bit,
    and the same random-init points3d.ply written beside them."""
    a, b = tmp_path / "port", tmp_path / "jax"
    got = load_scene(_copy(exported, a), eval_split=eval_split)
    want = jax_load_scene(_copy(exported, b), eval_split=eval_split)
    for split in ("train_cameras", "test_cameras"):
        g, w = getattr(got, split), getattr(want, split)
        assert len(g) == len(w)
        for cg, cw in zip(g, w):
            assert (cg.uid, cg.image_name, cg.width, cg.height) == (
                cw.uid, cw.image_name, cw.width, cw.height)
            assert cg.fov_x == cw.fov_x and cg.fov_y == cw.fov_y
            assert pathlib.Path(cg.image_path).relative_to(a) == pathlib.Path(
                cw.image_path).relative_to(b)
            np.testing.assert_array_equal(cg.R, cw.R)
            np.testing.assert_array_equal(cg.T, cw.T)
    names = [c.image_name for c in got.train_cameras + got.test_cameras]
    assert str(LOST) not in names and len(names) == FRAMES - 1
    assert (len(got.test_cameras) == 1) == eval_split
    ply = (a / SCENE / "points3d.ply").read_bytes()
    assert ply == (b / SCENE / "points3d.ply").read_bytes()
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert len(got.points) == 100_000
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]


# ---------------------------------------------------------------- fusion
def _fusion_overrides(scene, model, out, depth="image"):
    return [f"scene.scene_path={scene}", f"model.model_dir={model}", f"fusion.out_dir={out}",
            "fusion.model_2d=random", f"fusion.embedding_dim={C}", f"fusion.img_dim=[{CW},{CH}]",
            "fusion.every_k_views=2", f"fusion.depth={depth}", "fusion.cut_boundary=2",
            "fusion.visibility_threshold=0.2"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    arrays, alive = scene_arrays(n=1500, seed=31, dead=40)
    arrays["opacity_logits"] += 2.0
    out = tmp_path_factory.mktemp("scannet_model")
    jax_save_ply(out / "point_cloud" / "iteration_30" / "point_cloud.ply",
                 jax_params(arrays), alive)
    return out


def test_fusion_cli_depth_image_matches_jax(exported, model_dir, tmp_path, monkeypatch):
    """`fusion.depth=image` through the port's CLI (chunked: 4 views, one
    chunk) reads `<scene>/depth/<name>.png` (32x24, resized to 64x48 with
    nearest); the JAX fuse_scene given those paths agrees: visited masks
    equal, features within rtol 1e-6."""
    scene = _copy(exported, tmp_path)
    seen = {}

    def spy(*args, **kw):
        seen["kw"] = kw
        seen["out"] = tfusion.fuse_scene(*args, **kw)
        return seen["out"]

    monkeypatch.setattr(fusion_cli, "fuse_scene", spy)
    summary = fusion_cli.main([str(default_config_dir() / "fusion_scannet.yaml"), "--device",
                               "cpu", *_fusion_overrides(scene, model_dir, tmp_path / "fused")])
    tf, tv = (np_(t) for t in seen["out"])
    depth_paths = seen["kw"]["depth_paths"]
    names = [c.image_name for c in load_scene(scene, eval_split=False).train_cameras]
    assert depth_paths == [str(scene / "depth" / f"{n}.png") for n in names]
    assert summary["views"] == 4 and summary["visited"] == int(tv.sum())

    info = jax_load_scene(scene, eval_split=False)
    from semantic_gaussians_tpu.io.ply import load_gaussian_ply

    params, alive = load_gaussian_ply(model_dir / "point_cloud" / "iteration_30" /
                                      "point_cloud.ply")
    jf, jv = jfusion.fuse_scene(
        params, alive, [jax_realize(c, with_image=False) for c in info.train_cameras],
        JaxRandomProvider(embedding_dim=C),
        jfusion.FusionConfig(img_dim=(CW, CH), every_k_views=2, depth="image",
                             visibility_threshold=0.2, cut_boundary=2),
        image_paths=[c.image_path for c in info.train_cameras], depth_paths=depth_paths,
        backend="pallas")
    np.testing.assert_array_equal(tv, np_(jv))
    np.testing.assert_allclose(tf, np_(jf), rtol=1e-6, atol=1e-7)
    alive = np_(alive).astype(bool)
    assert 100 < tv.sum() < alive.sum() and not tv[~alive].any()
    # the sensor's zero (invalid) depth and the occlusion test keep points
    # out: with no depth at all more are visited
    arrays, alive_np = load_gaussian_ply_port(model_dir / "point_cloud" / "iteration_30" /
                                              "point_cloud.ply")
    _, none_visited = tfusion.fuse_scene(
        params_from_numpy(arrays, "cpu"), torch.from_numpy(alive_np), _port_cameras(scene),
        RandomFeatureProvider(embedding_dim=C),
        tfusion.FusionConfig(img_dim=(CW, CH), every_k_views=2, depth="none", cut_boundary=2),
        image_paths=[c.image_path for c in info.train_cameras])
    assert int(none_visited.sum()) > int(tv.sum())


def _port_cameras(scene):
    from semantic_gaussians_torch.io.scene import realize_camera

    return [realize_camera(c, with_image=False)
            for c in load_scene(scene, eval_split=False).train_cameras]


def test_fusion_cli_depth_image_without_depth_raises(tmp_path):
    """A Blender scene has no depth/ folder: `fusion.depth=image` raises a
    ValueError naming the first missing PNG before any view is fused (the
    model directory is not even read)."""
    write_toy_blender_scene(tmp_path / "toy_scene", views=3, w=CW, h=CH)
    missing = tmp_path / "toy_scene" / "depth" / "r_0.png"
    with pytest.raises(ValueError, match=f"{missing}"):
        fusion_cli.main([str(default_config_dir() / "fusion_scannet.yaml"), "--device", "cpu",
                         *_fusion_overrides(tmp_path / "toy_scene", tmp_path / "no_model",
                                            tmp_path / "fused")])


def test_fuse_scene_depth_image_needs_paths():
    arrays, alive = scene_arrays(n=64, seed=3)
    cams = _toy_cameras()
    with pytest.raises(ValueError, match="needs depth_paths"):
        tfusion.fuse_scene(torch_params(arrays), torch.from_numpy(alive), cams,
                           RandomFeatureProvider(4), tfusion.FusionConfig(depth="image"))


def _toy_cameras():
    from semantic_gaussians_torch.utils.camera import make_camera

    return [make_camera(np.eye(3), np.zeros(3), 1.2, 1.0, CW, CH)]


# ---------------------------------------------------------------- evaluation
@pytest.fixture(scope="module")
def fused_dir(model_dir, tmp_path_factory):
    """Class-structured fused features on the model's Gaussians: x-slabs
    of the ScanNet-20 classes, each its text feature plus noise."""
    from semantic_gaussians_tpu.io.ply import load_gaussian_ply

    params, alive = load_gaussian_ply(model_dir / "point_cloud" / "iteration_30" /
                                      "point_cloud.ply")
    means = np_(params.means)
    text = text_feature_matrix(RandomFeatureProvider(C), SCANNET20_CLASS_LABELS)
    cls = np.digitize(means[:, 0], np.linspace(-1.5, 1.5, K - 1))
    rng = np.random.default_rng(41)
    feats = (text[cls + 1] + 0.1 * rng.normal(size=(len(means), C))).astype(np.float32)
    out = tmp_path_factory.mktemp("scannet_fused")
    tfusion.save_fused_features(out / SCENE / "0.pt", feats, np_(alive).astype(bool))
    return out


@pytest.mark.parametrize("pred_on_3d", ["true", "false"], ids=["onehot", "features"])
def test_eval_cli_label_filt_matches_root_cli(exported, model_dir, fused_dir, tmp_path,
                                              monkeypatch, pred_on_3d):
    """Mode 2d with `scene.dataset_name=scannet20` and no eval.label_dir:
    the ground truth is `<scene>/label-filt/<frame>.png` (16 bits, 128x96,
    resized to 64x48 with nearest) mapped through the scene's TSV. The
    port's CLI and the root eval_segmentation.py give equal confusions,
    whose row sums are the class counts of the ground truth mapped here
    with numpy (an 8-bit read would lose the raw ids above 255)."""
    import eval_segmentation as root_eval
    from semantic_gaussians_tpu.pipelines import eval_segmentation as jeval

    scene = _copy(exported, tmp_path)
    overrides = [f"scene.scene_path={scene}", f"model.model_dir={model_dir}",
                 f"fusion.out_dir={fused_dir}", f"fusion.embedding_dim={C}",
                 "scene.dataset_name=scannet20", "eval.eval_mode=2d", f"eval.width={CW}",
                 f"eval.height={CH}", f"eval.pred_on_3d={pred_on_3d}"]
    seen = {}

    def spy(*args, **kw):
        seen["root"] = jeval_views(*args, **kw)
        return seen["root"]

    jeval_views = jeval.eval_views
    monkeypatch.setattr(jeval, "eval_views", spy)
    monkeypatch.chdir(tmp_path)  # the root CLI appends to ./eval_result.log
    yaml = REPO / "semantic_gaussians_tpu/config/yamls/eval.yaml"
    with mock.patch.object(sys, "argv", ["eval_segmentation.py", str(yaml), *overrides,
                                         "pipeline.backend=pallas"]):
        root_eval.main()
    miou, _, conf = eval_cli.main([str(default_config_dir() / "eval.yaml"), "--device", "cpu",
                                   *overrides, f"eval.log_file={tmp_path / 'port.log'}"])
    want = seen["root"][2]
    assert conf.shape == (K, K + 1)
    np.testing.assert_array_equal(conf, want)
    assert 0 < miou <= 1

    evaluated = [c.image_name for c in load_scene(scene, eval_split=False).train_cameras][::10]
    lut = {r: t for t, r in enumerate(RAW)}
    counts = np.zeros(K, np.int64)
    for name in evaluated:
        raw = np.asarray(Image.open(scene / "label-filt" / f"{name}.png").resize(
            (CW, CH), Image.NEAREST)).astype(np.int64)
        assert raw.max() > 255
        gt = np.vectorize(lambda r: lut.get(r, K))(raw)
        counts += np.bincount(gt.ravel(), minlength=K + 1)[:K]
    np.testing.assert_array_equal(conf.sum(axis=1), counts)
    assert counts.sum() > 0.5 * len(evaluated) * CW * CH


# ---------------------------------------------------------------- COLMAP
# The two COLMAP model writers of tests/test_colmap.py (copied, not
# imported): a text model with an empty POINTS2D line, and a binary one.
def _write_text_model(d, empty_points_line=True):
    (d / "cameras.txt").write_text(
        "# Camera list\n"
        "1 PINHOLE 640 480 500.0 510.0 320.0 240.0\n"
        "2 SIMPLE_PINHOLE 320 240 260.0 160.0 120.0\n"
    )
    lines = [
        "# Image list",
        "1 0.9961947 0.08715574 0.0 0.0 0.1 -0.2 0.3 1 a.png",
        "10.5 20.5 7 30.0 40.0 -1",
        "2 1.0 0.0 0.0 0.0 0.5 0.6 0.7 2 b.png",
        "" if empty_points_line else "1.0 2.0 3",
    ]
    (d / "images.txt").write_text("\n".join(lines) + "\n")
    (d / "points3D.txt").write_text(
        "# 3D points\n"
        "7 1.0 2.0 3.0 255 128 0 0.5 1 0 2 1\n"
        "9 -1.0 0.0 4.0 0 255 64 1.25 1 1\n"
    )


def _write_binary_model(d):
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 640, 480))  # PINHOLE
        f.write(struct.pack("<dddd", 500.0, 510.0, 320.0, 240.0))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<dddd", 0.9961947, 0.08715574, 0.0, 0.0))
        f.write(struct.pack("<ddd", 0.1, -0.2, 0.3))
        f.write(struct.pack("<i", 1))
        f.write(b"a.png\x00")
        f.write(struct.pack("<Q", 1))  # one 2D point
        f.write(struct.pack("<ddq", 10.5, 20.5, 7))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<QdddBBBd", 7, 1.0, 2.0, 3.0, 255, 128, 0, 0.5))
        f.write(struct.pack("<Q", 2))  # track of length 2
        f.write(struct.pack("<iiii", 1, 0, 2, 1))


def _same(got, want):
    """Equal values, field by field, through tuples, dicts and arrays."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("kind", ["text", "binary"])
@pytest.mark.parametrize("reader", ["cameras", "images", "points3d"])
def test_colmap_readers_match_jax(tmp_path, kind, reader):
    from semantic_gaussians_tpu.io import colmap as jcolmap
    from semantic_gaussians_torch.io import colmap as tcolmap

    (_write_text_model if kind == "text" else _write_binary_model)(tmp_path)
    fname = {"cameras": "cameras", "images": "images", "points3d": "points3D"}[reader]
    path = tmp_path / f"{fname}.{'txt' if kind == 'text' else 'bin'}"
    fn = f"read_{reader}_{kind}"
    _same(getattr(tcolmap, fn)(path), getattr(jcolmap, fn)(path))
    if reader == "cameras":
        for cam in getattr(tcolmap, fn)(path).values():
            assert tcolmap.intrinsics_to_fov(cam) == jcolmap.intrinsics_to_fov(cam)


def _colmap_layout(root, layout):
    """A COLMAP scene: the text model at sparse/, the binary one at
    sparse/0, the text model with its points3D.txt replaced by a PLY, or
    the binary one with no points at all (random init)."""
    from semantic_gaussians_torch.io.ply import save_point_cloud

    sparse = root / ("sparse" if layout in ("text", "text_ply") else "sparse/0")
    sparse.mkdir(parents=True)
    if layout.startswith("text"):
        _write_text_model(sparse, empty_points_line=layout == "text")
    else:
        _write_binary_model(sparse)
    if layout == "text_ply":
        (sparse / "points3D.txt").unlink()
        rng = np.random.default_rng(5)
        save_point_cloud(sparse / "points3D.ply", rng.normal(size=(50, 3)).astype(np.float32),
                         rng.uniform(size=(50, 3)).astype(np.float32))
    if layout == "binary_random":
        (sparse / "points3D.bin").unlink()
    return root


@pytest.mark.parametrize("layout", ["text", "binary", "text_ply", "binary_random"])
@pytest.mark.parametrize("eval_split", [False, True], ids=["all", "llff_hold"])
def test_load_scene_colmap_matches_jax(tmp_path, layout, eval_split):
    """load_scene on a COLMAP layout in both packages: the same cameras (R
    and T bit for bit, fovs, sizes, image paths), points, colours and
    normalization; downscale halves the sizes alike. A one-image model
    with its image held out raises in both."""
    root = _colmap_layout(tmp_path / "scene", layout)
    if eval_split and layout.startswith("binary"):
        # one image, held out for test: no training camera to normalise by
        for load in (load_scene, jax_load_scene):
            with pytest.raises(ValueError, match="need at least one array"):
                load(root, eval_split=True)
        return
    for downscale in (1.0, 2.0):
        got = load_scene(root, eval_split=eval_split, downscale=downscale)
        want = jax_load_scene(root, eval_split=eval_split, downscale=downscale)
        for split in ("train_cameras", "test_cameras"):
            assert len(getattr(got, split)) == len(getattr(want, split))
            for cg, cw in zip(getattr(got, split), getattr(want, split)):
                _same(tuple(cg), tuple(cw))
        for k in ("points", "colors", "normals"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        _same(got.nerf_normalization, want.nerf_normalization)
        assert got.ply_path == want.ply_path
        cams = sorted(got.train_cameras + got.test_cameras, key=lambda c: c.uid)
        assert len(cams) == (1 if layout.startswith("binary") else 2)
        assert cams[0].width == 640 / downscale
    assert len(got.points) == {"text": 2, "binary": 1, "text_ply": 50,
                               "binary_random": 100_000}[layout]

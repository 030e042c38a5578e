"""Port parity: Gaussian PLY checkpoints, fused-feature .pt files, the
numpy carry-across of GaussianParams, point-cloud PLYs and Blender scene
loading, all bit for bit."""
import numpy as np
import pytest
import torch

from semantic_gaussians_tpu.io.ply import load_gaussian_ply as jax_load
from semantic_gaussians_tpu.io.ply import save_gaussian_ply as jax_save
from semantic_gaussians_tpu.pipelines.fusion import load_fused_features as jax_load_feats
from semantic_gaussians_tpu.pipelines.fusion import save_fused_features as jax_save_feats
from semantic_gaussians_torch.core.gaussians import FIELDS, params_from_numpy
from semantic_gaussians_torch.io.ply import load_gaussian_ply as torch_load
from semantic_gaussians_torch.io.ply import save_gaussian_ply as torch_save
from semantic_gaussians_torch.pipelines.fusion import load_fused_features as torch_load_feats
from semantic_gaussians_torch.pipelines.fusion import save_fused_features as torch_save_feats
from torch_port_common import jax_params, np_, scene_arrays


def _assert_same(jax_loaded, torch_loaded):
    (jp, jalive), (arrays, talive) = jax_loaded, torch_loaded
    np.testing.assert_array_equal(np_(jalive), talive)
    for f in FIELDS:
        a, b = np_(getattr(jp, f)), arrays[f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=f)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ply_loads_bit_identical(tmp_path, writer):
    arrays, alive = scene_arrays(n=300, seed=4, dead=20)
    path = tmp_path / "point_cloud.ply"
    if writer == "jax":
        jax_save(path, jax_params(arrays), alive)
    else:
        torch_save(path, params_from_numpy(arrays, "cpu"), alive)
    _assert_same(jax_load(path), torch_load(path))
    _assert_same(jax_load(path, capacity=512), torch_load(path, capacity=512))


def test_ply_roundtrip_keeps_alive_rows(tmp_path):
    arrays, alive = scene_arrays(n=100, seed=5, dead=10)
    path = tmp_path / "p.ply"
    torch_save(path, params_from_numpy(arrays, "cpu"), alive)
    loaded, loaded_alive = torch_load(path, capacity=100)
    assert loaded_alive.sum() == alive.sum()
    for f in FIELDS:
        np.testing.assert_array_equal(loaded[f][:90], arrays[f][alive])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_fused_features_roundtrip(tmp_path, writer):
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(200, 16)).astype(np.float32)
    visited = rng.uniform(size=200) < 0.7
    path = tmp_path / "0.pt"
    (jax_save_feats if writer == "jax" else torch_save_feats)(path, feats, visited)
    jf, jm = jax_load_feats(path, capacity=256)
    tf, tm = torch_load_feats(path, capacity=256)
    np.testing.assert_array_equal(np_(jm), np_(tm))
    np.testing.assert_array_equal(np_(jf), np_(tf))
    # half-precision storage of the visited rows, zeros elsewhere
    np.testing.assert_array_equal(
        np_(tf)[:200][visited], feats[visited].astype(np.float16).astype(np.float32)
    )
    assert not np_(tf)[~np_(tm)].any()


def test_params_from_numpy_exact():
    arrays, _ = scene_arrays(n=64, seed=7)
    jp = jax_params(arrays)
    tp = params_from_numpy({f: np_(getattr(jp, f)) for f in FIELDS}, "cpu")
    for f in FIELDS:
        t = getattr(tp, f)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(np_(getattr(jp, f)), np_(t))
    for prop in ("scales", "opacity", "sh_coeffs"):
        np.testing.assert_allclose(np_(getattr(jp, prop)), np_(getattr(tp, prop)), rtol=1e-6)
    assert tp.max_sh_degree == jp.max_sh_degree == 3
    with pytest.raises(KeyError):
        params_from_numpy({"means": arrays["means"]}, "cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_point_cloud_roundtrip(tmp_path, writer):
    from semantic_gaussians_tpu.io.ply import load_point_cloud as jax_load_pc
    from semantic_gaussians_tpu.io.ply import save_point_cloud as jax_save_pc
    from semantic_gaussians_torch.io.ply import load_point_cloud as torch_load_pc
    from semantic_gaussians_torch.io.ply import save_point_cloud as torch_save_pc

    rng = np.random.default_rng(12)
    pts = rng.normal(size=(150, 3)).astype(np.float32)
    cols = rng.uniform(size=(150, 3)).astype(np.float32)
    nrm = rng.normal(size=(150, 3)).astype(np.float32)
    path = tmp_path / "points3d.ply"
    (jax_save_pc if writer == "jax" else torch_save_pc)(path, pts, cols, nrm)
    for a, b in zip(jax_load_pc(path), torch_load_pc(path)):
        np.testing.assert_array_equal(a, b)
    got_pts, got_cols, got_nrm = torch_load_pc(path)
    np.testing.assert_array_equal(got_pts, pts)
    np.testing.assert_array_equal(got_nrm, nrm)
    np.testing.assert_allclose(got_cols, cols, atol=1 / 255)


def test_load_scene_blender_cameras_match_jax(tmp_path):
    """A Blender layout written here loads into the same camera list, scene
    extent and point cloud in both packages, and realize_camera gives the
    same matrices and image."""
    import json

    from semantic_gaussians_tpu.io.scene import load_scene as jax_load_scene
    from semantic_gaussians_tpu.io.scene import realize_camera as jax_realize
    from semantic_gaussians_torch.cli.view_server import encode_png
    from semantic_gaussians_torch.io.ply import save_point_cloud
    from semantic_gaussians_torch.io.scene import load_scene, realize_camera

    rng = np.random.default_rng(13)
    (tmp_path / "train").mkdir()
    frames = []
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = rng.normal(size=3) * 2
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w[:3, :3] = q * np.sign(np.linalg.det(q))
        img = rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)
        (tmp_path / "train" / f"r_{i}.png").write_bytes(encode_png(img))
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (tmp_path / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    save_point_cloud(tmp_path / "points3d.ply", rng.normal(size=(50, 3)),
                     rng.uniform(size=(50, 3)))
    want, got = jax_load_scene(tmp_path), load_scene(tmp_path)
    assert len(got.train_cameras) == len(want.train_cameras) == 3 and not got.test_cameras
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    for gc, wc in zip(got.train_cameras, want.train_cameras):
        for k in ("R", "T"):
            np.testing.assert_array_equal(getattr(gc, k), getattr(wc, k))
        assert (gc.fov_x, gc.fov_y, gc.width, gc.height, gc.image_name) == (
            wc.fov_x, wc.fov_y, wc.width, wc.height, wc.image_name)
        tcam, jcam = realize_camera(gc), jax_realize(wc)
        for k in ("world_view", "full_proj", "camera_center", "image"):
            np.testing.assert_array_equal(np_(getattr(tcam, k)), np_(getattr(jcam, k)))

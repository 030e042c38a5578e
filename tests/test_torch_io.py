"""Port parity: Gaussian PLY checkpoints, fused-feature .pt files, the
numpy carry-across of GaussianParams, point-cloud PLYs, Blender scene
loading, dynamic-scene params.npz and the weight-free 2D feature providers,
all bit for bit."""
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


# ---------------------------------------------------------------- dynamic scenes
def _write_dynamic_npz(path, t=3, n=90, seed=14, iso_scales=False, flat_opacity=False):
    rng = np.random.default_rng(seed)
    np.savez(
        path,
        means3D=rng.normal(size=(t, n, 3)).astype(np.float32),
        rgb_colors=rng.uniform(size=(t, n, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(t, n, 4)).astype(np.float32),
        logit_opacities=rng.normal(size=(n,) if flat_opacity else (n, 1)).astype(np.float32),
        log_scales=rng.normal(size=(n, 1 if iso_scales else 3)).astype(np.float32),
        seg_colors=rng.uniform(size=(n, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("iso_scales,flat_opacity", [(False, False), (True, True)])
def test_dynamic_npz_matches_jax(tmp_path, iso_scales, flat_opacity):
    """params.npz loads into the same scene, and params_at(t) gives the same
    leaves bit for bit, in both packages; `from_numpy` carries a JAX scene
    over."""
    from semantic_gaussians_tpu.io.dynamic_npz import load_dynamic_npz as jax_load_dyn
    from semantic_gaussians_torch.io.dynamic_npz import DynamicScene, load_dynamic_npz

    path = tmp_path / "params.npz"
    _write_dynamic_npz(path, iso_scales=iso_scales, flat_opacity=flat_opacity)
    want, got = jax_load_dyn(path), load_dynamic_npz(path)
    assert got.capacity == want.capacity == 4096 and got.num_timesteps == 3
    carried = DynamicScene.from_numpy(
        {k: np.asarray(getattr(want, k)) for k in
         ("means", "colors", "rotations", "opacity_logits", "log_scales", "is_fg")},
        want.capacity)
    np.testing.assert_array_equal(np_(got.foreground_mask()), np_(want.foreground_mask()))
    for t, deg in ((0, 0), (2, 0), (1, 3)):
        jp, jalive = want.params_at(t, sh_degree=deg)
        for scene in (got, carried):
            tp, talive = scene.params_at(t, sh_degree=deg)
            np.testing.assert_array_equal(np_(talive), np_(jalive))
            for f in FIELDS:
                a, b = np_(getattr(jp, f)), np_(getattr(tp, f))
                assert a.shape == b.shape and b.dtype == np.float32, f
                np.testing.assert_array_equal(a, b, err_msg=f)
    assert load_dynamic_npz(path, capacity=128).params_at(0)[0].capacity == 128


# ---------------------------------------------------------------- 2D providers
def test_random_provider_matches_jax():
    from semantic_gaussians_tpu.models.predictors import RandomFeatureProvider as JaxProvider
    from semantic_gaussians_torch.models.predictors import RandomFeatureProvider

    a, b = JaxProvider(12, feat_hw=(30, 40)), RandomFeatureProvider(12, feat_hw=(30, 40))
    for size in ((64, 48), (40, 30), None):
        np.testing.assert_array_equal(
            b.extract_image_feature("scene/color/17.jpg", size),
            a.extract_image_feature("scene/color/17.jpg", size))
    assert b.extract_image_feature("x", (64, 48)).shape == (48, 64, 12)
    np.testing.assert_array_equal(
        b.extract_text_feature(["wall", "a chair"]), a.extract_text_feature(["wall", "a chair"]))


@pytest.mark.parametrize("ext", ["npy", "npz", "pt", "pt_dict"])
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_precomputed_provider_matches_jax(tmp_path, ext, layout):
    """.npy / .npz / .pt (a tensor, or a dict with `feat`) exports load to
    the same [H, W, C] float32 map in both packages: CHW detected through
    embedding_dim, nearest resize to the asked size; the port's .pt branch
    loads with weights_only=True."""
    from semantic_gaussians_tpu.models.predictors import (
        PrecomputedFeatureProvider as JaxProvider,
    )
    from semantic_gaussians_torch.models.predictors import PrecomputedFeatureProvider

    rng = np.random.default_rng(15)
    feat = rng.normal(size=(24, 32, 8)).astype(np.float16)
    stored = feat if layout == "hwc" else np.moveaxis(feat, -1, 0)
    if ext == "npy":
        np.save(tmp_path / "frame7.npy", stored)
    elif ext == "npz":
        np.savez(tmp_path / "frame7.npz", feat=stored)
    else:
        t = torch.from_numpy(np.ascontiguousarray(stored))
        torch.save({"feat": t} if ext == "pt_dict" else t, tmp_path / "frame7.pt")
    a, b = JaxProvider(str(tmp_path), 8), PrecomputedFeatureProvider(tmp_path, 8)
    for size in ((32, 24), (64, 48), None):
        got = b.extract_image_feature("/data/color/frame7.jpg", size)
        np.testing.assert_array_equal(got, a.extract_image_feature("/data/color/frame7.jpg", size))
        assert got.dtype == np.float32
        assert got.shape == ((24, 32, 8) if size is None else (size[1], size[0], 8))
    np.testing.assert_array_equal(b.extract_image_feature("frame7", None), feat.astype(np.float32))
    half = PrecomputedFeatureProvider(tmp_path, 8, dtype="float16").extract_image_feature(
        "frame7", (64, 48))
    assert half.dtype == np.float16  # the stored precision, same values
    np.testing.assert_array_equal(half.astype(np.float32), b.extract_image_feature("frame7", (64, 48)))
    with pytest.raises(FileNotFoundError):
        b.extract_image_feature("frame8.jpg", None)
    with pytest.raises(NotImplementedError):
        b.extract_text_feature(["wall"])


def test_make_predictor_dispatch(tmp_path, monkeypatch):
    from semantic_gaussians_torch.config.config import DotDict
    from semantic_gaussians_torch.models import predictors as tp

    cfg = DotDict.wrap({"feature_dir": str(tmp_path), "embedding_dim": 32})
    for name in ("precomputed", "openseg"):
        p = tp.make_predictor(name, cfg)
        assert isinstance(p, tp.PrecomputedFeatureProvider) and p.embedding_dim == 32
    assert tp.make_predictor("random", cfg).embedding_dim == 32
    assert tp.make_predictor("precomputed", cfg).dtype == np.float32
    assert tp.make_predictor("precomputed", dict(cfg, feat_dtype="float16")).dtype == np.float16
    # the model towers: on CUDA unless the CPU is asked for; local checkpoints
    missing = dict(cfg, lseg_checkpoint=str(tmp_path / "none.ckpt"),
                   sam_checkpoint=str(tmp_path / "none.pth"),
                   clip_checkpoint=str(tmp_path / "none.pt"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("lseg", "samclip", "vlpart"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tp.make_predictor(name, missing)
        with pytest.raises(FileNotFoundError):
            tp.make_predictor(name, missing, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.TorchCLIPTextEncoder("/no/such/checkpoint")
    with pytest.raises(FileNotFoundError):
        tp.TorchCLIPTextEncoder("/no/such/checkpoint", device="cpu")
    with pytest.raises(ValueError, match="unknown model_2d"):
        tp.make_predictor("dinov9", cfg)

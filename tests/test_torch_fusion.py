"""Port parity: 2D -> 3D fusion. The same numpy inputs go through the JAX
package (semantic_gaussians_tpu, on the CPU) and the port's plain torch
functions: the point -> pixel mapping with occlusion and the surface
z-buffer are exact; fused features agree at a float tolerance in the
`image`, `surface` and `none` depth modes with identical visited masks; in
`render` mode the two renderers' depths differ in the last bits, so rows
whose occlusion test flips are counted and bounded; checkpoints with
`n_split_points` hold the same random subsets index for index; the fusion
CLI on the CPU is held against the root fusion.py on one toy scene."""
import pathlib
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from semantic_gaussians_tpu.data import fusion_utils as jfu  # noqa: E402
from semantic_gaussians_tpu.io.ply import save_gaussian_ply as jax_save_ply  # noqa: E402
from semantic_gaussians_tpu.models.predictors import (  # noqa: E402
    RandomFeatureProvider as JaxRandomProvider,
)
from semantic_gaussians_tpu.pipelines import fusion as jfusion  # noqa: E402
from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera  # noqa: E402
from semantic_gaussians_torch.cli import fusion as fusion_cli  # noqa: E402
from semantic_gaussians_torch.config.config import default_config_dir  # noqa: E402
from semantic_gaussians_torch.data import fusion_utils as tfu  # noqa: E402
from semantic_gaussians_torch.models.predictors import RandomFeatureProvider  # noqa: E402
from semantic_gaussians_torch.pipelines import fusion as tfusion  # noqa: E402
from semantic_gaussians_torch.utils.camera import make_camera as torch_camera  # noqa: E402
from torch_port_common import (  # noqa: E402
    jax_params, np_, scene_arrays, torch_params, write_toy_blender_scene,
)

W, H, C = 64, 48, 16
IMG = (W, H)


def _scene(n=1500, seed=21, dead=60):
    arrays, alive = scene_arrays(n=n, seed=seed, dead=dead)
    arrays["opacity_logits"] += 2.0  # near-opaque: the median depth reads a surface
    return arrays, alive


def _cams(k=3):
    """k views side by side, each as (JAX camera, port camera)."""
    out = []
    for i in range(k):
        args = (np.eye(3), np.array([0.25 * (i - 1), 0.0, 0.0]), 1.2, 1.0, W, H)
        out.append((jax_camera(*args), torch_camera(*args)))
    return out


def _intrinsics(tcam):
    return tfusion._intrinsic_for(tcam, IMG)


# ---------------------------------------------------------------- mapping
def test_compute_mapping_toy_cases():
    coords = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, -1.0]])
    w2c = torch.eye(4)
    K = torch.tensor([[50.0, 0, 32.0], [0, 50.0, 24.0], [0, 0, 1]])
    depth = torch.full((48, 64), 2.0)
    m = tfu.compute_mapping(w2c, coords, K, (64, 48), depth, 0.05, 0)
    assert m.dtype == torch.int32 and m[0].tolist() == [24, 32, 1] and m[1, 2] == 0
    assert tfu.compute_mapping(w2c, coords, K, (64, 48), depth * 0.5, 0.05, 0)[0, 2] == 0
    assert tfu.compute_mapping(w2c, coords, K, (64, 48), None, 0.05, 0)[0, 2] == 1
    assert tfu.compute_mapping(w2c, coords, K, (64, 48), None, 0.05, 30)[0, 2] == 0


@pytest.mark.parametrize("cut_bound", [0, 5])
@pytest.mark.parametrize("with_depth", [False, True], ids=["no_depth", "occlusion"])
def test_compute_mapping_exact(with_depth, cut_bound):
    """Exact: pixel rows, columns and masks, for points in front of, behind
    and next to the camera plane (|z| < 1e-8 included)."""
    rng = np.random.default_rng(22)
    arrays, _ = _scene()
    pts = arrays["means"].copy()
    pts[:40, 2] = rng.normal(size=40) * 1e-9  # on the camera plane
    pts[40:80, 2] *= -1  # behind
    pts[80:120] *= 1e3  # far outside the image
    jcam, tcam = _cams(1)[0]
    K = _intrinsics(tcam)
    depth = None
    if with_depth:
        depth = rng.uniform(2.5, 5.5, size=(H, W)).astype(np.float32)
        depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    want = jfu.compute_mapping(
        jcam.world_view, jnp.asarray(pts), jnp.asarray(K), IMG,
        None if depth is None else jnp.asarray(depth), 0.3, cut_bound)
    got = tfu.compute_mapping(
        tcam.world_view, torch.from_numpy(pts), torch.from_numpy(K), IMG,
        None if depth is None else torch.from_numpy(depth), 0.3, cut_bound)
    np.testing.assert_array_equal(np_(got), np_(want))
    assert 100 < int(got[:, 2].sum()) < len(pts)


def test_surface_depth_exact():
    arrays, alive = _scene()
    jcam, tcam = _cams(1)[0]
    K = _intrinsics(tcam)
    for valid in (None, alive):
        want = jfu.surface_depth(
            jcam.world_view, jnp.asarray(arrays["means"]), jnp.asarray(K), IMG, 2,
            valid=None if valid is None else jnp.asarray(valid))
        got = tfu.surface_depth(
            tcam.world_view, torch.from_numpy(arrays["means"]), torch.from_numpy(K), IMG, 2,
            valid=None if valid is None else torch.from_numpy(valid))
        np.testing.assert_array_equal(np_(got), np_(want))
        assert got.shape == (H, W) and (np_(got) > 0).sum() > 200
    toy = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, 4.0], [0.5, 0.0, 2.0]])
    K = torch.tensor([[50.0, 0, 32.0], [0, 50.0, 24.0], [0, 0, 1]])
    assert tfu.surface_depth(torch.eye(4), toy, K, (64, 48))[24, 32] == 2.0


def test_adjust_intrinsic_matches_jax():
    K = np.array([[100.0, 0, 50], [0, 100, 40], [0, 0, 1]])
    for dims in (((100, 80), (50, 40)), ((100, 80), (100, 80)), ((640, 480), (648, 484))):
        np.testing.assert_array_equal(tfu.adjust_intrinsic(K, *dims), jfu.adjust_intrinsic(K, *dims))
    assert tfu.adjust_intrinsic(K, (100, 80), (50, 40))[0, 0] == 50.0


# ---------------------------------------------------------------- fuse_scene
def _fuse_both(depth_mode, tmp_path, feat_dtype="float32", chunk_views=0, vis=0.3):
    arrays, alive = _scene()
    cams = _cams(3)
    paths = [f"view{i}" for i in range(3)]
    depth_paths = None
    if depth_mode == "image":
        from PIL import Image

        rng = np.random.default_rng(23)
        depth_paths = []
        for i in range(3):
            d = rng.uniform(3000, 5000, size=(H, W)).astype(np.uint16)
            depth_paths.append(str(tmp_path / f"d{i}.png"))
            Image.fromarray(d).save(depth_paths[-1])
    kw = dict(img_dim=IMG, every_k_views=1, depth=depth_mode, visibility_threshold=vis,
              cut_boundary=2, feat_dtype=feat_dtype)
    jf, jv = jfusion.fuse_scene(
        jax_params(arrays), jnp.asarray(alive), [c for c, _ in cams],
        JaxRandomProvider(embedding_dim=C), jfusion.FusionConfig(chunk_views=chunk_views, **kw),
        image_paths=paths, depth_paths=depth_paths, backend="pallas")
    tf, tv = tfusion.fuse_scene(
        torch_params(arrays), torch.from_numpy(alive), [c for _, c in cams],
        RandomFeatureProvider(embedding_dim=C), tfusion.FusionConfig(chunk_views=4, **kw),
        image_paths=paths, depth_paths=depth_paths)
    return (np_(jf), np_(jv)), (np_(tf), np_(tv)), alive


@pytest.mark.parametrize("depth_mode", ["none", "surface", "image"])
def test_fuse_scene_matches_jax(depth_mode, tmp_path):
    """Masks exact; features are means of at most 3 gathered float32 rows:
    rtol 1e-6."""
    (jf, jv), (tf, tv), alive = _fuse_both(depth_mode, tmp_path)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-7)
    assert tf.dtype == np.float32 and tf.shape == (len(alive), C)
    assert tv.sum() > 100 and not tv[~alive].any() and not tf[~tv].any()


def test_fuse_scene_chunked_jax_gives_the_same(tmp_path):
    """The JAX package's chunked scan (chunk_views=2) against the port's
    chunk of 4 (the 3 views and one zero-weight slot)."""
    (jf, jv), (tf, tv), _ = _fuse_both("surface", tmp_path, chunk_views=2)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-7)


def test_fuse_scene_half_feature_maps(tmp_path):
    """float16 maps: gathered narrow, accumulated in float32; equal to JAX's
    at rtol 1e-6 and to the float32 fusion within fp16 rounding (2e-3)."""
    (jf, jv), (tf, tv), _ = _fuse_both("none", tmp_path, feat_dtype="float16")
    _, (tf32, tv32), _ = _fuse_both("none", tmp_path)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, tv32)
    assert tf.dtype == np.float32
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tf, tf32, atol=2e-3)
    assert np.abs(tf - tf32).max() > 0


def test_fuse_scene_render_depth_mode(tmp_path):
    """depth='render': the port's depth differs from JAX's in the last bits,
    so a point within that of |d - z| = vis * d can flip. Flipped rows are
    at most 0.5% of the visited; the others' features agree at 1e-5."""
    (jf, jv), (tf, tv), _ = _fuse_both("render", tmp_path, vis=0.05)
    assert jv.sum() > 100
    flipped = tv != jv
    assert flipped.sum() <= 0.005 * jv.sum()
    # a row whose visit count differs in one view has another mean: compare
    # the rows that agree to 1e-5 and bound the rest
    close = np.isclose(tf, jf, rtol=1e-5, atol=1e-5).all(axis=1)
    assert (~close).sum() <= 0.005 * jv.sum()


def test_unknown_depth_mode_raises():
    arrays, alive = _scene(n=64, dead=0)
    with pytest.raises(ValueError, match="unknown depth mode"):
        tfusion.fuse_scene(torch_params(arrays), torch.from_numpy(alive), [_cams(1)[0][1]],
                           RandomFeatureProvider(4), tfusion.FusionConfig(depth="lidar"))


# ---------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("n_split,files", [(999_999_999, 1), (50, 1), (50, 3), (10**9, 2)])
def test_save_fused_features_subsets_match_jax(tmp_path, n_split, files):
    """The random point subsets are numpy's `default_rng(seed).choice` in
    both packages: the same files, masks equal index for index, rows equal."""
    rng = np.random.default_rng(24)
    feats = rng.normal(size=(300, C)).astype(np.float32)
    visited = rng.uniform(size=300) < 0.6
    for name, save in (("jax", jfusion.save_fused_features), ("torch", tfusion.save_fused_features)):
        save(tmp_path / name / "0.pt", feats, visited, n_split_points=n_split,
             num_rand_file_per_scene=files, seed=7)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == (["0.pt"] if files == 1 else [f"0_{k}.pt" for k in range(files)])
    masks = []
    for n in names:
        a = torch.load(tmp_path / "jax" / n, weights_only=True)
        b = torch.load(tmp_path / "torch" / n, weights_only=True)
        assert torch.equal(a["mask_full"], b["mask_full"]) and torch.equal(a["feat"], b["feat"])
        assert b["feat"].dtype == torch.float16
        assert int(b["mask_full"].sum()) == min(n_split, int(visited.sum()))
        assert not (b["mask_full"].numpy() & ~visited).any()
        masks.append(b["mask_full"].numpy())
        loaded, mask = tfusion.load_fused_features(tmp_path / "torch" / n, capacity=320)
        np.testing.assert_array_equal(np_(mask)[:300], masks[-1])
        np.testing.assert_array_equal(
            np_(loaded)[:300][masks[-1]], feats[masks[-1]].astype(np.float16).astype(np.float32))
    if n_split == 50 and files == 3:
        assert not np.array_equal(masks[0], masks[1])  # each file draws anew


# ---------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fusion_cli")
    write_toy_blender_scene(tmp / "toy_scene", w=W, h=H)
    arrays, alive = _scene()
    jax_save_ply(tmp / "model" / "point_cloud" / "iteration_30" / "point_cloud.ply",
                 jax_params(arrays), alive)
    return tmp


def _overrides(toy, out, depth):
    return [f"scene.scene_path={toy / 'toy_scene'}", f"model.model_dir={toy / 'model'}",
            f"fusion.out_dir={out}", "fusion.model_2d=random", f"fusion.embedding_dim={C}",
            f"fusion.img_dim=[{W},{H}]", "fusion.every_k_views=2", f"fusion.depth={depth}",
            "fusion.cut_boundary=2", "fusion.num_rand_file_per_scene=2",
            # subsets only where the visited sets are equal (their draws depend on them)
            f"fusion.n_split_points={400 if depth == 'surface' else 10**9}",
            "fusion.visibility_threshold=0.2"]


@pytest.mark.parametrize("depth", ["surface", "render"])
def test_fusion_cli_matches_root_cli(toy, depth, capsys):
    """`python -m semantic_gaussians_torch.cli.fusion --device cpu` against
    the root fusion.py (Pallas in interpret mode) on one toy scene: the same
    files; with depth=surface the masks are equal and the half-precision
    rows within one fp16 step (1e-3); with depth=render flipped rows are at
    most 1% of the visited and the common rows agree as closely."""
    import fusion as root_fusion

    jax_out, torch_out = toy / f"jax_{depth}", toy / f"torch_{depth}"
    yaml = REPO / "semantic_gaussians_tpu/config/yamls/fusion_scannet.yaml"
    with mock.patch.object(sys, "argv", ["fusion.py", str(yaml), *_overrides(toy, jax_out, depth),
                                         "pipeline.backend=pallas"]):
        root_fusion.main()
    jax_visited = int(capsys.readouterr().out.rsplit("fused ", 1)[1].split()[0])
    summary = fusion_cli.main([str(default_config_dir() / "fusion_scannet.yaml"), "--device", "cpu",
                               *_overrides(toy, torch_out, depth)])
    assert summary["views"] == 3 and summary["device"] == "cpu"
    assert summary["out_path"] == torch_out / "toy_scene" / "0.pt"
    names = sorted(p.name for p in (torch_out / "toy_scene").iterdir())
    assert names == sorted(p.name for p in (jax_out / "toy_scene").iterdir()) == ["0_0.pt", "0_1.pt"]
    assert summary["visited"] > (400 if depth == "surface" else 200)
    for n in names:
        a = tfusion.load_fused_features(jax_out / "toy_scene" / n)
        b = tfusion.load_fused_features(torch_out / "toy_scene" / n)
        flipped = np_(a[1] != b[1])
        if depth == "surface":
            assert summary["visited"] == jax_visited and not flipped.any()
            assert int(b[1].sum()) == 400
        else:
            assert flipped.sum() <= 0.01 * jax_visited
        both = np_(a[1] & b[1])
        close = np.isclose(np_(b[0])[both], np_(a[0])[both], atol=1e-3).all(axis=1)
        assert (~close).sum() <= (0 if depth == "surface" else 0.01 * jax_visited)


def test_fusion_cli_precomputed_half_maps(toy):
    """model_2d=precomputed with float16 .npy exports and feat_dtype=float16
    (the maps stay half precision from the file to the gather) against the
    random provider's float32 maps they were exported from: the same
    visited count, rows within fp16 rounding (3e-3)."""
    scene = toy / "toy_scene"
    provider = RandomFeatureProvider(embedding_dim=C)
    feature_dir = toy / "exports"
    feature_dir.mkdir()
    for i in range(6):
        path = scene / "train" / f"r_{i}.png"
        np.save(feature_dir / f"r_{i}.npy",
                provider.extract_image_feature(str(path), IMG).astype(np.float16))
    cfg = str(default_config_dir() / "fusion_scannet.yaml")
    ref = fusion_cli.main([cfg, "--device", "cpu", *_overrides(toy, toy / "ref_f32", "surface")])
    got = fusion_cli.main([
        cfg, *_overrides(toy, toy / "pre_f16", "surface"), "fusion.device=cpu",
        "fusion.model_2d=precomputed", f"fusion.feature_dir={feature_dir}",
        "fusion.feat_dtype=float16"])
    assert got["visited"] == ref["visited"] and got["device"] == "cpu"
    a = tfusion.load_fused_features(ref["out_path"].with_name("0_0.pt"))
    b = tfusion.load_fused_features(got["out_path"].with_name("0_0.pt"))
    assert torch.equal(a[1], b[1])
    np.testing.assert_allclose(np_(b[0]), np_(a[0]), atol=3e-3)

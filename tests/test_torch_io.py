"""Port parity: Gaussian PLY checkpoints, fused-feature .pt files and the
numpy carry-across of GaussianParams, all bit for bit."""
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

"""Port parity: the JAX package's last small functions. The same numpy
inputs, made from a seed, go through the JAX function and its port:
rotmat_to_quat (up to sign, atol 1e-6) and unstrip_symmetric (exact),
config.resolve, ops.projection.mark_visible (bit for bit on the JAX test's
four points and on random points that straddle the near plane and the
+/-1.3 NDC box) and pipelines.distill.distill_scene_features (at the UNet
test's 1e-4 of the output's largest magnitude)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_gaussians_tpu.config import config as jcfg
from semantic_gaussians_tpu.data.feature_dataset import DistillItem as JaxItem
from semantic_gaussians_tpu.models import unet3d as JU
from semantic_gaussians_tpu.ops.projection import mark_visible as jax_mark_visible
from semantic_gaussians_tpu.pipelines.distill import (
    distill_scene_features as jax_distill_scene_features,
)
from semantic_gaussians_tpu.utils import transforms as JT
from semantic_gaussians_torch.config import config as tcfg
from semantic_gaussians_torch.data.feature_dataset import DistillItem
from semantic_gaussians_torch.models import unet3d as TU
from semantic_gaussians_torch.ops.projection import NEAR_CULL_Z, mark_visible
from semantic_gaussians_torch.pipelines.distill import distill_scene_features
from semantic_gaussians_torch.utils import transforms as TT
from torch_port_common import cameras, np_


# ------------------------------------------------------------ transforms
def _random_rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)


def _canonical(q):
    """q and -q are one rotation: the sign that makes the largest-magnitude
    component positive."""
    big = np.take_along_axis(q, np.abs(q).argmax(-1)[:, None], -1)
    return q * np.sign(big)


def test_rotmat_to_quat_matches_jax():
    R = _random_rotations(1000, seed=60)
    # the four branches of the construction: traces near -1 (180-degree
    # turns about each axis) as well as the generic ones
    R[:3] = np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])
    got = np_(TT.rotmat_to_quat(torch.from_numpy(R)))
    want = np.asarray(JT.rotmat_to_quat(jnp.asarray(R)))
    assert got.shape == (1000, 4) and got.dtype == np.float32
    np.testing.assert_allclose(_canonical(got), _canonical(want), atol=1e-6, rtol=0)
    # and it inverts quat_to_rotmat (at the JAX package's round-trip atol)
    back = np_(TT.quat_to_rotmat(torch.from_numpy(got)))
    np.testing.assert_allclose(back, R, atol=1e-4)


def test_unstrip_symmetric_matches_jax_exactly():
    v = np.random.default_rng(61).normal(size=(7, 5, 6)).astype(np.float32)
    got = np_(TT.unstrip_symmetric(torch.from_numpy(v)))
    want = np.asarray(JT.unstrip_symmetric(jnp.asarray(v)))
    assert got.shape == (7, 5, 3, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np_(TT.strip_symmetric(torch.from_numpy(got))), v)


# ------------------------------------------------------------ config.resolve
_TREE = {"a": {"b": {"c": 3, "none": None}, "list": [1, 2]}, "top": "x", "zero": 0}
_LOOKUPS = [
    (("a", "b", "c"), None), (("a", "b"), None), (("top",), None), (("zero",), 5),
    (("a", "b", "none"), 7),  # a present None is returned, not the default
    (("a", "missing"), None), (("a", "missing"), "dflt"), (("nope", "b"), 1),
    (("top", "b"), "d"),  # a string is not a dict node
    (("a", "list", "0"), "d"), (("a", "b", "c", "d"), 9),  # an int is not a dict node
    ((), None),
]


@pytest.mark.parametrize("keys,default", _LOOKUPS, ids=[".".join(k) or "root" for k, _ in _LOOKUPS])
def test_resolve_matches_jax(keys, default):
    got = tcfg.resolve(tcfg.DotDict.wrap(_TREE), *keys, default=default)
    want = jcfg.resolve(jcfg.DotDict.wrap(_TREE), *keys, default=default)
    assert got == want
    if keys == ("a", "b"):
        assert got == {"c": 3, "none": None}


def test_resolve_reads_a_loaded_config(tmp_path):
    y = tmp_path / "c.yaml"
    y.write_text("fusion:\n  model_2d: lseg\n  img_dim: [640, 480]\n")
    t = tcfg.load_config(y, ["fusion.embedding_dim=512"])
    j = jcfg.load_config(y, ["fusion.embedding_dim=512"])
    for keys in (("fusion", "model_2d"), ("fusion", "embedding_dim"), ("fusion", "img_dim"),
                 ("fusion", "depth")):
        assert tcfg.resolve(t, *keys, default="none") == jcfg.resolve(j, *keys, default="none")


# ------------------------------------------------------------ mark_visible
def test_mark_visible_on_the_jax_tests_points():
    from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
    from semantic_gaussians_torch.utils.camera import make_camera as torch_camera

    args = (np.eye(3), np.zeros(3), 1.2, 1.0, 64, 48)
    jcam, tcam = jax_camera(*args), torch_camera(*args)
    pts = np.array([[0, 0, 3.0], [0, 0, -3.0], [100.0, 0, 3.0], [0, 0, 0.1]], np.float32)
    got = np_(mark_visible(torch.from_numpy(pts), tcam.world_view, tcam.full_proj))
    want = np.asarray(jax_mark_visible(jnp.asarray(pts), jcam.world_view, jcam.full_proj))
    assert got.dtype == bool and got.tolist() == want.tolist() == [True, False, False, False]


@pytest.mark.parametrize("pose", ["identity", "turned"])
def test_mark_visible_matches_jax_bit_for_bit(pose):
    """4,096 points: a third at view depths around the near plane, the rest
    at NDC coordinates around +/-1.3, some behind the camera."""
    rng = np.random.default_rng(62)
    n = 4096
    jcam, tcam = cameras(w=128, h=96, fov_x=1.2, fov_y=0.9)
    if pose == "turned":
        from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
        from semantic_gaussians_torch.utils.camera import make_camera as torch_camera

        a = 0.4
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        args = (R, np.array([0.2, -0.1, 0.5]), 1.2, 0.9, 128, 96)
        jcam, tcam = jax_camera(*args), torch_camera(*args)
    wv = np_(tcam.world_view).astype(np.float64)
    tan = np.array([np.tan(0.6), np.tan(0.45)])
    z = np.where(np.arange(n) < n // 3,
                 NEAR_CULL_Z + rng.normal(0, 0.05, n),  # straddle the near plane
                 rng.uniform(-2.0, 8.0, n))
    ndc = rng.uniform(-1.6, 1.6, (n, 2))
    ndc[::7] = np.sign(ndc[::7]) * (1.3 + rng.normal(0, 1e-3, ndc[::7].shape))
    view = np.concatenate([ndc * tan * np.abs(z)[:, None], z[:, None]], -1)
    # view -> world through the inverse of world_view
    world = (view - wv[:3, 3]) @ np.linalg.inv(wv[:3, :3]).T
    pts = world.astype(np.float32)
    got = np_(mark_visible(torch.from_numpy(pts), tcam.world_view, tcam.full_proj))
    want = np.asarray(jax_mark_visible(jnp.asarray(pts), jcam.world_view, jcam.full_proj))
    np.testing.assert_array_equal(got, want)
    assert 0.2 * n < got.sum() < 0.8 * n  # both sides of every test are taken


# ------------------------------------------------------------ distill_scene_features
def test_distill_scene_features_matches_jax():
    """MinkUNet14A (56 -> 24) on 300 voxels of a 384 budget, JAX's weights
    carried across: the eval-mode output within 1e-4 of its largest
    magnitude, padded voxels zero."""
    rng = np.random.default_rng(63)
    budget, v, cin, cout = 384, 300, 56, 24
    coords = np.zeros((budget, 3), np.int32)
    coords[:v] = rng.permutation(np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"),
                                          -1).reshape(-1, 3))[:v]
    mask = np.arange(budget) < v
    feats = (rng.normal(size=(budget, cin)) * mask[:, None]).astype(np.float32)
    gt = np.zeros((budget, cout), np.float32)
    fields = dict(coords=coords, feats=feats, gt=gt, gt_mask=mask.copy(), mask=mask,
                  num_voxels=v)
    model = JU.mink_unet(cin, cout, "MinkUNet14A")
    topo = jax.jit(JU.build_topology)(jnp.asarray(coords), jnp.asarray(mask))
    variables = model.init(jax.random.PRNGKey(3), jnp.asarray(feats), topo)
    # non-trivial running statistics, so that eval mode reads them
    variables = dict(variables, batch_stats=jax.tree.map(
        lambda x: x + 0.1 * jnp.abs(jnp.asarray(rng.normal(size=x.shape), x.dtype)),
        variables["batch_stats"]))
    want = np.asarray(jax_distill_scene_features(model, variables, JaxItem(**fields)))

    tmodel = TU.mink_unet(cin, cout, "MinkUNet14A")
    tmodel.load_state_dict(TU.unet_state_from_flax(jax.tree.map(np.asarray, variables), tmodel))
    tmodel.train()  # distill_scene_features must switch it to eval mode
    got = np_(distill_scene_features(tmodel, DistillItem(**fields)))
    assert got.shape == want.shape == (budget, cout)
    assert not tmodel.training
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert not got[~mask].any() and np.abs(got[mask]).sum() > 0

"""The port's LSeg (semantic_gaussians_torch.models.lseg) against the JAX
package's (tiny configs, CPU), weights carried both ways: the port's
random init -> state_dict() -> params_from_lseg_state_dict (with the
BatchNorm statistics), and a JAX init -> state_from_flax -> the port.
Towers at rtol 2e-4 / atol 2e-5 (test_lseg.py:132); fused features at
1e-4 with identical visited masks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_common  # noqa: F401  (one torch thread per worker)
from semantic_gaussians_tpu.models import lseg as jls
from semantic_gaussians_torch.models import lseg as tls
from semantic_gaussians_torch.models.common import random_init_
from torch_port_common import np_

RTOL, ATOL = 2e-4, 2e-5
CFG = dict(patch=16, width=64, layers=4, heads=4, taps=(0, 1, 2, 3), native_grid=4,
           reassemble_ch=(16, 24, 32, 32), features=24, out_ch=8)


def both_nets(direction, seed=0):
    """(JAX variables, port LSegNet in eval mode) with the same weights."""
    if direction == "port_to_jax":
        net = random_init_(tls.LSegNet(tls.LSegConfig(**CFG)), seed=seed, std=0.05)
        sd = {k: v.numpy() for k, v in net.state_dict().items()}
        return jls.params_from_lseg_state_dict(sd, jls.LSegConfig(**CFG)), net.eval()
    var = jax.jit(jls.LSegNet(jls.LSegConfig(**CFG)).init)(jax.random.PRNGKey(seed),
                                                           jnp.zeros((1, 32, 32, 3)))
    # move the BatchNorm statistics and scales off their init (0 / 1)
    r = np.random.default_rng(seed + 1)
    var = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * np.abs(r.normal(size=a.shape))).astype(np.float32), var)
    net = tls.LSegNet(tls.LSegConfig(**CFG))
    net.load_state_dict(tls.state_from_flax(var))
    return var, net.eval()


@pytest.mark.parametrize("hw", [(64, 96), (32, 32), (64, 64)], ids=["grow", "shrink", "native"])
def test_vit_backbone_matches_jax(rng, hw):
    """Each tap's tokens; the position embedding's grid resized to the
    input's (grown, shrunk with antialias, or kept)."""
    var, net = both_nets("port_to_jax", seed=1)
    x = rng.normal(size=(1, *hw, 3)).astype(np.float32)
    vit = jls.ViTTapped(patch=16, width=64, layers=4, heads=4, taps=(0, 1, 2, 3), native_grid=4)
    outs, grid = vit.apply({"params": var["params"]["vit"]}, jnp.asarray(x))
    with torch.no_grad():
        got, tgrid = net.pretrained.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tgrid == grid == (hw[0] // 16, hw[1] // 16)
    for a, b in zip(got, outs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_lseg_net_matches_jax(rng, direction):
    var, net = both_nets(direction, seed=2)
    x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jls.LSegNet(jls.LSegConfig(**CFG)).apply)(var, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 96, 8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


def test_state_from_flax_roundtrip():
    var, _ = both_nets("jax_to_port", seed=3)
    back = jls.params_from_lseg_state_dict(
        {k: v.numpy() for k, v in tls.state_from_flax(var).items()}, jls.LSegConfig(**CFG))
    assert jax.tree.structure(back) == jax.tree.structure(var)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(var)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resize_bilinear_align_corners_matches_jax(rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jls.resize_bilinear_ac(jnp.asarray(x), 10, 14))
    got = tls.resize_bilinear_ac(torch.from_numpy(x).permute(0, 3, 1, 2), 10, 14)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-6)


def test_split_checkpoint_sorts_the_public_keys():
    """A public-layout checkpoint: the network's keys load with
    load_state_dict, the bundled CLIP's go to the text tower, the keys no
    forward pass reads are left out and named, anything else raises."""
    net = tls.LSegNet(tls.LSegConfig(**CFG))
    sd = {"net." + k: v for k, v in net.state_dict().items()}
    extra = {
        "net.scratch.refinenet4.resConfUnit1.conv1.weight": torch.zeros(1),
        "net.pretrained.model.norm.weight": torch.zeros(1),
        "net.pretrained.model.head.weight": torch.zeros(1),
        "net.logit_scale": torch.zeros(()),
        "net.clip_pretrained.token_embedding.weight": torch.zeros(3, 2),
        "net.clip_pretrained.visual.proj": torch.zeros(2, 2),
        "net.clip_pretrained.logit_scale": torch.zeros(()),
    }
    net_sd, clip_sd, ignored = tls.split_checkpoint(dict(sd, **extra))
    net.load_state_dict(net_sd)
    assert sorted(clip_sd) == ["logit_scale", "token_embedding.weight", "visual.proj"]
    assert ignored == sorted(["scratch.refinenet4.resConfUnit1.conv1.weight",
                              "pretrained.model.norm.weight", "pretrained.model.head.weight",
                              "logit_scale", "clip_pretrained.visual.proj",
                              "clip_pretrained.logit_scale"])
    assert list(tls.clip_text_state_from_lseg(dict(sd, **extra))) == ["token_embedding.weight"]
    assert tls.LSegConfig.from_state_dict(net_sd) == tls.LSegConfig(**dict(CFG, heads=1))
    with pytest.raises(ValueError, match="unexpected keys"):
        tls.split_checkpoint(dict(sd, **{"net.auxlayer.weight": torch.zeros(1)}))


@pytest.mark.parametrize("mode", ["single", "sliding", "sliding_one_crop"])
def test_lseg_predictor_matches_jax(rng, mode):
    """The predictor's whole image path (PIL resize, normalize, pre-scale,
    net, align-corners resize back, L2 norm) on the same weights; sliding:
    a 1x2 crop grid with an overlap seam (crop 64, base 96), or one padded
    pass (crop 128)."""
    var, net = both_nets("port_to_jax", seed=4)
    crop = 128 if mode == "sliding_one_crop" else 64
    jp = jls.LSegPredictor(cfg=jls.LSegConfig(**CFG), variables=var, base_size=96, crop_size=crop)
    tp = tls.LSegPredictor(net=net, base_size=96, crop_size=crop, device="cpu")
    img = (rng.uniform(size=(80, 120, 3)) * 255).astype(np.uint8)
    sliding = mode != "single"
    got = tp.extract_image_feature(img, (120, 80), sliding=sliding)
    want = jp.extract_image_feature(img, (120, 80), sliding=sliding)
    assert got.shape == (80, 120, 8) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


SMALL = dict(patch=16, width=128, layers=4, heads=2, taps=(0, 1, 2, 3), native_grid=4,
             reassemble_ch=(16, 24, 32, 32), features=24, out_ch=512)


def _bundled_checkpoint_case(tmp_path, rng, clip_dtype):
    """A Lightning-style checkpoint (`state_dict` of `net.*` keys with a
    ViT-B/32 CLIP under `net.clip_pretrained.*` in clip_dtype) loaded by
    both packages' predictors: the image features and the bundled text
    tower's features agree. Returns the port's predictor."""
    from semantic_gaussians_torch.models.clip_text import CLIPTextTower
    from semantic_gaussians_torch.tools.random_checkpoints import write_bpe

    net = random_init_(tls.LSegNet(tls.LSegConfig(**SMALL)), seed=5, std=0.05)
    text = random_init_(CLIPTextTower(), seed=6)
    sd = {"net." + k: v for k, v in net.state_dict().items()}
    sd.update({"net.clip_pretrained." + k: v.to(clip_dtype)
               for k, v in text.state_dict().items()})
    sd["net.clip_pretrained.logit_scale"] = torch.tensor(4.6, dtype=clip_dtype)
    torch.save({"state_dict": sd, "epoch": 200}, tmp_path / "lseg.ckpt")
    bpe = write_bpe(tmp_path / "bpe.txt.gz", ["wall", "table"])

    tp = tls.LSegPredictor(tmp_path / "lseg.ckpt", bpe_path=str(bpe), base_size=96, device="cpu")
    jp = jls.LSegPredictor(str(tmp_path / "lseg.ckpt"), cfg=jls.LSegConfig(**SMALL),
                           base_size=96, bpe_path=str(bpe))
    img = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(tp.extract_image_feature(img, (64, 48)),
                               jp.extract_image_feature(img, (64, 48)), rtol=0, atol=1e-4)
    labels = ["wall", "table", "a wall"]
    np.testing.assert_allclose(tp.extract_text_feature(labels), jp.extract_text_feature(labels),
                               rtol=RTOL, atol=ATOL)
    return tp


def test_lseg_checkpoint_with_bundled_text_tower(tmp_path, rng):
    """The port reads the network's config from the checkpoint's weights
    and matches the JAX predictor on them."""
    tp = _bundled_checkpoint_case(tmp_path, rng, torch.float32)
    assert tp.cfg == tls.LSegConfig(**SMALL) and tp.embedding_dim == 512


def test_lseg_checkpoint_with_float16_text_tower(tmp_path, rng):
    """LSeg's bundled CLIP saved in half precision (as `clip.load` on a
    card builds it): the port's text tower takes the weights in float32,
    as the JAX converter does, and matches the JAX predictor."""
    tp = _bundled_checkpoint_case(tmp_path, rng, torch.float16)
    assert {p.dtype for p in tp.text_encoder.tower.state_dict().values()} == {torch.float32}


def test_load_torch_state_dict_unpickles_in_full_only_when_asked(tmp_path):
    """Tensors and argparse.Namespace hyper-parameters load weights-only; a
    file that pickles another class raises, unless `full_unpickle` (LSeg's
    Lightning checkpoint) loads it, with a warning."""
    import argparse
    import fractions
    import pickle

    from semantic_gaussians_torch.models.common import load_torch_state_dict

    sd = {"w": torch.ones(2, dtype=torch.float16), "n": torch.arange(3)}
    torch.save({"state_dict": sd, "hparams": argparse.Namespace(lr=1e-3)}, tmp_path / "ns.ckpt")
    got = load_torch_state_dict(tmp_path / "ns.ckpt")
    assert got.keys() == sd.keys() and torch.equal(got["w"], sd["w"])
    torch.save({"state_dict": sd, "hparams": fractions.Fraction(1, 3)}, tmp_path / "other.ckpt")
    with pytest.raises(pickle.UnpicklingError):
        load_torch_state_dict(tmp_path / "other.ckpt")
    with pytest.warns(UserWarning, match="pickles more than tensors"):
        got = load_torch_state_dict(tmp_path / "other.ckpt", full_unpickle=True)
    assert got.keys() == sd.keys() and torch.equal(got["w"], sd["w"])


def test_lseg_predictor_feeds_fusion(tmp_path, rng):
    """LSeg per-pixel maps -> fuse_scene in both packages on one scene and
    the same weights: identical visited masks, features within 1e-4."""
    from semantic_gaussians_tpu.core.gaussians import init_from_pcd as jax_init_from_pcd
    from semantic_gaussians_tpu.pipelines.fusion import FusionConfig as JaxFusionConfig
    from semantic_gaussians_tpu.pipelines.fusion import fuse_scene as jax_fuse
    from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
    from semantic_gaussians_torch.core.gaussians import init_from_pcd
    from semantic_gaussians_torch.pipelines.fusion import FusionConfig, fuse_scene
    from semantic_gaussians_torch.utils.camera import make_camera

    var, net = both_nets("port_to_jax", seed=7)
    jp = jls.LSegPredictor(cfg=jls.LSegConfig(**CFG), variables=var, base_size=64)
    tp = tls.LSegPredictor(net=net, base_size=64, device="cpu")
    img = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
    path = tmp_path / "view0.png"
    Image.fromarray(img).save(path)
    n, cap = 60, 64
    pts = (rng.normal(size=(n, 3)) * 0.3 + [0, 0, 2.5]).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    cam = (np.eye(3), np.zeros(3), 1.2, 1.0, 64, 48)
    jf, jv = jax_fuse(*jax_init_from_pcd(pts, cols, capacity=cap), [jax_camera(*cam)], jp,
                      JaxFusionConfig(img_dim=(64, 48), depth=None, every_k_views=1),
                      image_paths=[str(path)], backend="dense")
    params, alive = init_from_pcd(pts, cols, capacity=cap)
    tf, tv = fuse_scene(params, alive, [make_camera(*cam)], tp,
                        FusionConfig(img_dim=(64, 48), depth=None, every_k_views=1),
                        image_paths=[str(path)])
    assert tf.shape == (cap, 8) and bool(tv.any())
    np.testing.assert_array_equal(np_(tv), np_(jv))
    np.testing.assert_allclose(np_(tf), np_(jf), rtol=0, atol=1e-4)
    assert np.isfinite(np_(tf)).all()

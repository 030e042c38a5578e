"""The port's SAM (semantic_gaussians_torch.models.sam) against the JAX
package's (tiny configs, CPU), weights carried both ways: the port's
random init -> state_dict() -> params_from_sam_state_dict, and a JAX init
-> state_from_flax -> the port. Attention and decoder pieces at the JAX
package's rtol 1e-4 / atol 1e-5 (test_sam.py:76), whole towers at 2e-4 /
2e-5, resizes at 2e-5 on [0, 1] inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per worker)
from semantic_gaussians_tpu.models import sam as jsam
from semantic_gaussians_torch.models import sam as tsam
from semantic_gaussians_torch.models.common import random_init_, resize_bilinear
from test_sam import _fake_sam_state_dict

CFG_J, CFG_T = jsam.SamConfig.tiny(), tsam.SamConfig.tiny()


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def jax_init(seed=0):
    x = jnp.zeros((1, CFG_J.img_size, CFG_J.img_size, 3))
    return jsam.Sam(CFG_J).init(jax.random.PRNGKey(seed), x, jnp.zeros((1, 1, 2)),
                                jnp.ones((1, 1), jnp.int32))


def port_init(seed=0):
    return random_init_(tsam.Sam(CFG_T), seed=seed, std=0.2, scales=tsam.init_scales()).eval()


def both_models(direction, seed=0):
    """(JAX variables, port model) holding the same weights."""
    if direction == "port_to_jax":
        model = port_init(seed)
        return jsam.params_from_sam_state_dict(model.state_dict(), CFG_J), model
    var = jax_init(seed)
    model = tsam.Sam(CFG_T)
    model.load_state_dict(tsam.state_from_flax(var))
    return var, model.eval()


def test_window_partition_matches_jax(rng):
    x = rng.normal(size=(2, 7, 9, 4)).astype(np.float32)
    wins, pad_hw = tsam.window_partition(torch.from_numpy(x), 3)
    jwins, jpad = jsam.window_partition(jnp.asarray(x), 3)
    assert pad_hw == jpad == (9, 9)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
    back = tsam.window_unpartition(wins, 3, pad_hw, (7, 9))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("length", [9, 5, 15], ids=["exact", "grow", "shrink"])
def test_get_rel_pos_matches_jax(rng, length):
    """The table rows for q = k = 5; a table of another length than 9 is
    resized first (the branch a checkpoint of another size reaches)."""
    table = rng.uniform(size=(length, 8)).astype(np.float32)
    got = tsam.get_rel_pos(5, 5, torch.from_numpy(table)).numpy()
    want = np.asarray(jsam.get_rel_pos(5, 5, jnp.asarray(table)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    if length == 9:
        for i in range(5):
            for j in range(5):
                np.testing.assert_array_equal(got[i, j], table[i - j + 4])


@pytest.mark.parametrize("shape,size", [
    ((968, 1296), (765, 1024)), ((700, 700), (336, 336)), ((24, 24), (16, 20)),
    ((484, 648), (765, 1024)), ((48, 56), (64, 64)),
])
def test_resize_bilinear_matches_jax_image_resize(rng, shape, size):
    """`resize_bilinear` against jax.image.resize(..., "linear") on [0, 1]
    images, shrinking (antialiased) and growing."""
    img = rng.uniform(size=(*shape, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (*size, 3), method="linear"))
    got = resize_bilinear(torch.from_numpy(img).permute(2, 0, 1)[None], size)[0]
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape", [(48, 56), (40, 64), (64, 30)])
def test_preprocess_image_matches_jax(rng, shape):
    """Resize the long side, normalize, zero-pad: within the resize's 2e-5
    on [0, 1], i.e. 255 * 2e-5 / 57 ~ 1e-4 after normalization."""
    img = (rng.uniform(size=(*shape, 3)) * 255).astype(np.uint8)
    got, rhw = tsam.preprocess_image(img, 64)
    want, jrhw = jsam.preprocess_image(img, 64)
    assert rhw == jrhw
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_vitdet_attention_matches_jax(rng, direction):
    dim, heads, h = 16, 2, 3
    x = rng.normal(size=(1, h, h, dim)).astype(np.float32)
    jattn = jsam.VitDetAttention(dim, heads)
    attn = tsam.VitDetAttention(dim, heads, h)
    if direction == "port_to_jax":
        random_init_(attn, seed=1, std=0.3)
        sd = _np(attn.state_dict())
        var = {"params": {"qkv": {"kernel": sd["qkv.weight"].T, "bias": sd["qkv.bias"]},
                          "proj": {"kernel": sd["proj.weight"].T, "bias": sd["proj.bias"]},
                          "rel_pos_h": sd["rel_pos_h"], "rel_pos_w": sd["rel_pos_w"]}}
    else:
        var = jattn.init(jax.random.PRNGKey(1), jnp.asarray(x))
        # the init's relative tables are zero: move every leaf off it
        var = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(2), a.shape),
                           var)
        p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), var["params"])
        attn.load_state_dict({"qkv.weight": p["qkv"]["kernel"].T, "qkv.bias": p["qkv"]["bias"],
                              "proj.weight": p["proj"]["kernel"].T, "proj.bias": p["proj"]["bias"],
                              "rel_pos_h": p["rel_pos_h"], "rel_pos_w": p["rel_pos_w"]})
    want = np.asarray(jattn.apply(var, jnp.asarray(x)))
    with torch.no_grad():
        got = attn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_vitdet_attention_matches_torch_mha_when_relpos_zero(rng):
    dim, heads, h, w = 16, 2, 3, 4
    attn = random_init_(tsam.VitDetAttention(dim, heads, 4), seed=3, std=0.3)
    with torch.no_grad():
        attn.rel_pos_h.zero_()
        attn.rel_pos_w.zero_()
    x = torch.from_numpy(rng.normal(size=(1, h, w, dim)).astype(np.float32))
    tx = x.reshape(h * w, 1, dim)
    want, _ = torch.nn.functional.multi_head_attention_forward(
        tx, tx, tx, dim, heads, attn.qkv.weight, attn.qkv.bias, None, None, False, 0.0,
        attn.proj.weight, attn.proj.bias)
    with torch.no_grad():
        torch.testing.assert_close(attn(x), want.reshape(1, h, w, dim), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_sam_matches_jax(rng, direction):
    """Encoder embedding, point-prompt masks and IoU (multimask) and box
    prompts through the whole tiny model."""
    var, model = both_models(direction, seed=4)
    jm = jsam.Sam(CFG_J)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    pts = rng.uniform(0, 64, (5, 1, 2)).astype(np.float32)
    lbl = np.ones((5, 1), np.int32)
    boxes = np.sort(rng.uniform(0, 64, (3, 4)).astype(np.float32).reshape(3, 2, 2), axis=1)
    boxes = boxes.transpose(0, 2, 1).reshape(3, 4)[:, [0, 2, 1, 3]]
    emb_j = jm.apply(var, jnp.asarray(x), method=jsam.Sam.encode_image)
    masks_j, iou_j = jm.apply(var, emb_j[0], jnp.asarray(pts), jnp.asarray(lbl),
                              method=jsam.Sam.predict_points)
    bm_j, biou_j = jm.apply(var, emb_j[0], jnp.asarray(boxes), method=jsam.Sam.predict_boxes)
    with torch.no_grad():
        emb = model.encode_image(torch.from_numpy(x))
        masks, iou = model.predict_points(emb[0], torch.from_numpy(pts), torch.from_numpy(lbl))
        bm, biou = model.predict_boxes(emb[0], torch.from_numpy(boxes))
    g = CFG_T.grid
    assert masks.shape == (5, 4, 4 * g, 4 * g) and bm.shape == (3, 4 * g, 4 * g)
    for got, want in ((emb, emb_j), (masks, masks_j), (iou, iou_j), (bm, bm_j), (biou, biou_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_state_dict_is_the_public_layout():
    """The port's state_dict() has exactly the keys and shapes of the
    public layout the JAX converter reads (the JAX tests' generator, itself
    held against sam_vit_b); a checkpoint's mask-prompt convs are left out
    knowingly; the config is read back from the weights."""
    fake = _fake_sam_state_dict(CFG_J, np.random.default_rng(0))
    ours = tsam.Sam(CFG_T).state_dict()
    assert sorted(ours) == sorted(fake)
    assert all(tuple(ours[k].shape) == tuple(fake[k].shape) for k in ours)
    extra = {"prompt_encoder.mask_downscaling.0.weight": torch.zeros(4, 1, 2, 2)}
    model = tsam.Sam.from_state_dict(dict(fake, **extra), CFG_T)
    torch.testing.assert_close(model.state_dict()["image_encoder.blocks.0.attn.qkv.weight"],
                               fake["image_encoder.blocks.0.attn.qkv.weight"])
    assert tsam.SamConfig.from_state_dict(fake, decoder_heads=2) == CFG_T
    for cfg in (tsam.SamConfig.vit_b(), tsam.SamConfig.vit_h()):
        with torch.device("meta"):
            sd = tsam.Sam(cfg).state_dict()
        assert tsam.SamConfig.from_state_dict(sd) == cfg


def test_state_from_flax_roundtrip():
    """JAX init -> state_from_flax -> params_from_sam_state_dict gives the
    JAX tree back leaf for leaf (the transposed convs' flip undone and
    redone)."""
    var = jax_init(5)
    back = jsam.params_from_sam_state_dict(tsam.state_from_flax(var), CFG_J)
    assert jax.tree.structure(back) == jax.tree.structure(var)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(var)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tiny_sam_shapes_and_finiteness(rng):
    model = port_init(6)
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(0, 64, (4, 1, 2)).astype(np.float32))
    with torch.no_grad():
        masks, iou = model(x, pts, torch.ones((4, 1), dtype=torch.int32))
    assert masks.shape == (4, 4, 32, 32) and iou.shape == (4, 4)
    assert torch.isfinite(masks).all() and torch.isfinite(iou).all()

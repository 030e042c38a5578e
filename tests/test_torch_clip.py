"""The port's CLIP towers, tokenizer and text encoders against the JAX
package's (semantic_gaussians_tpu.models.clip_text / clip_vision), with
weights carried both ways: the port's random init -> state_dict() -> the
JAX converter, and a JAX init -> state_from_flax -> the port."""
import json

import jax
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per worker)
from semantic_gaussians_tpu.data.scannet_constants import (
    COCOMAP_CLASS_LABELS, SCANNET20_CLASS_LABELS,
)
from semantic_gaussians_tpu.models import clip_text as jct
from semantic_gaussians_tpu.models import clip_vision as jcv
from semantic_gaussians_torch.models import clip_text as tct
from semantic_gaussians_torch.models import clip_vision as tcv
from semantic_gaussians_torch.models.common import random_init_
from semantic_gaussians_torch.tools.random_checkpoints import write_bpe

RTOL, ATOL = 2e-4, 2e-5  # the JAX package's tower tolerance (test_clip_text.py:58)


def _ids(rng, vocab, rows=(5, 12, 30), ctx=77):
    """Token rows SOT ... EOT, zero-padded, EOT the largest id of a row."""
    ids = np.zeros((len(rows), ctx), np.int64)
    for i, n in enumerate(rows):
        ids[i, 0] = vocab - 2
        ids[i, 1:n] = rng.integers(1, vocab - 2, size=n - 1)
        ids[i, n] = vocab - 1
    return ids


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_text_tower_matches_jax(direction, rng):
    kw = dict(vocab_size=1000, width=64, layers=3, heads=4, embed_dim=32)
    jtower = jct.CLIPTextTower(**kw)
    ids = _ids(rng, 1000)
    if direction == "port_to_jax":
        tower = random_init_(tct.CLIPTextTower(**kw), seed=1)
        params = jct.params_from_torch_state_dict(_np(tower.state_dict()))
    else:
        params = jtower.init(jax.random.PRNGKey(1), ids[:1].astype(np.int32))
        tower = tct.CLIPTextTower(**kw)
        tower.load_state_dict(tct.state_from_flax(params))
    want = np.asarray(jtower.apply(params, ids.astype(np.int32)))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_text_tower_takes_its_widths_from_the_state_dict(rng):
    """A ViT-L/14 text tower (768 wide, 12 heads, 768 out): the port reads
    the widths from the state dict and matches the JAX tower built with
    them explicitly; the JAX encoder's default tower (ViT-B/32, 512 wide)
    cannot take these weights (predictors.py:162, :178; clip_text.py:342)."""
    ref = random_init_(tct.CLIPTextTower(width=768, layers=2, heads=12, embed_dim=768), seed=2)
    sd = ref.state_dict()
    tower = tct.CLIPTextTower.from_state_dict(dict(sd, **{"visual.proj": torch.zeros(3),
                                                          "logit_scale": torch.zeros(())}))
    blk = tower.transformer.resblocks[0].attn
    assert (tower.token_embedding.weight.shape, blk.heads, tower.embed_dim,
            len(tower.transformer.resblocks)) == ((49408, 768), 12, 768, 2)
    ids = _ids(rng, 49408, rows=(4, 9))
    params = jct.params_from_torch_state_dict(_np(sd))
    want = np.asarray(jct.CLIPTextTower(width=768, layers=2, heads=12, embed_dim=768).apply(
        params, ids.astype(np.int32)))
    with torch.no_grad():
        np.testing.assert_allclose(tower(torch.from_numpy(ids)).numpy(), want,
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(Exception, match="49408, 512"):
        jct.JaxCLIPTextEncoder(params=params).encode_tokens(ids)


def test_encoder_normalizes_and_matches_jax():
    tower = random_init_(tct.CLIPTextTower(vocab_size=100, width=32, layers=2, heads=2,
                                           embed_dim=16), seed=3)
    enc = tct.CLIPTextEncoder(tower=tower, device="cpu")
    jenc = jct.JaxCLIPTextEncoder(
        tower=jct.CLIPTextTower(vocab_size=100, width=32, layers=2, heads=2, embed_dim=16),
        params=jct.params_from_torch_state_dict(_np(tower.state_dict())))
    ids = np.zeros((2, 77), np.int64)
    ids[:, 0] = 98
    ids[0, 1] = 99
    ids[1, 1:4] = [5, 7, 99]
    feats = enc.encode_tokens(ids)
    assert feats.shape == (2, 16)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(feats, jenc.encode_tokens(ids), rtol=RTOL, atol=ATOL)


def _tiny_hf_text(seed=0):
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    torch.manual_seed(seed)
    return CLIPTextModelWithProjection(CLIPTextConfig(
        vocab_size=1000, hidden_size=64, intermediate_size=256, num_hidden_layers=3,
        num_attention_heads=4, max_position_embeddings=77, projection_dim=32,
        hidden_act="quick_gelu", bos_token_id=998, eos_token_id=999, pad_token_id=0)).eval()


def test_hf_and_openai_names_agree(rng):
    """A Hugging Face text tower's keys mapped onto the port's
    (hf_to_openai) give the HF model's text_embeds and the JAX package's
    own HF conversion."""
    model = _tiny_hf_text()
    sd = tct.hf_to_openai(model.state_dict())
    tower = tct.CLIPTextTower(vocab_size=1000, width=64, layers=3, heads=4, embed_dim=32)
    tower.load_state_dict(sd)
    ids = _ids(rng, 1000)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids)).text_embeds.numpy()
        got = tower(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, hf, rtol=RTOL, atol=ATOL)
    p_hf = jct.params_from_torch_state_dict(_np(model.state_dict()))
    p_oa = jct.params_from_torch_state_dict(_np(sd))
    for a, b in zip(jax.tree.leaves(p_hf), jax.tree.leaves(p_oa)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_load_checkpoint_formats(tmp_path, suffix):
    """The JAX package's flattened .npz of variables and a torch state
    dict both load to the port's tower weights."""
    jtower = jct.CLIPTextTower(vocab_size=50, width=32, layers=2, heads=2, embed_dim=16)
    params = jtower.init(jax.random.PRNGKey(4), np.zeros((1, 77), np.int32))
    want = tct.state_from_flax(params)
    path = tmp_path / f"text{suffix}"
    if suffix == ".npz":
        flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
        np.savez(path, **flat)
    else:
        torch.save(want, path)
    got = tct.load_checkpoint(path)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert jct.load_checkpoint(path)["params"].keys() == params["params"].keys()


# --------------------------------------------------------------- tokenizer


@pytest.fixture(scope="module")
def bpe_file(tmp_path_factory):
    words = sorted({w for lab in SCANNET20_CLASS_LABELS + COCOMAP_CLASS_LABELS
                    for w in lab.split()} | {"a", "photo", "of", "the"})
    return str(write_bpe(tmp_path_factory.mktemp("bpe") / "bpe_test.txt.gz", words))


ODD_STRINGS = ("Café crème", "naïve résumé", "3 chairs, 12 tables!", "door #7 (left)",
               "it's a shelf's edge", "l'été", "TV-stand_2", "  many   spaces\tand\ttabs ",
               "&amp; html &lt;tags&gt;", "emoji 🙂 lamp", "中文 table", "x__y", "'s'", "")
# Where stdlib `re` and `regex` split differently (clip_text.py docstring):
# numeric characters that are not decimal digits, and ASCII separators.
RE_DIFFERS = ("x² table", "x½ cup", "Ⅻth chapter", "①door", "a\x1cb")


@pytest.mark.parametrize("texts", [
    SCANNET20_CLASS_LABELS, COCOMAP_CLASS_LABELS,
    tuple(f"a {lab}" for lab in SCANNET20_CLASS_LABELS + COCOMAP_CLASS_LABELS),
    ODD_STRINGS,
], ids=["scannet20", "cocomap", "prompts", "odd"])
def test_tokenizer_ids_match_jax(bpe_file, texts):
    want = jct.tokenize(list(texts), bpe_file)
    np.testing.assert_array_equal(tct.tokenize(list(texts), bpe_file), want)
    jt, tt = jct.SimpleTokenizer(bpe_file), tct.SimpleTokenizer(bpe_file)
    assert tt.encoder == jt.encoder
    for t in texts:
        assert tt.encode(t) == jt.encode(t), t


def test_tokenizer_named_differences(bpe_file):
    """The strings on which stdlib `re` splits otherwise than `regex`: the
    port's ids differ from the JAX package's on each (and only there)."""
    jt, tt = jct.SimpleTokenizer(bpe_file), tct.SimpleTokenizer(bpe_file)
    for t in RE_DIFFERS:
        assert tt.encode(t) != jt.encode(t), t


def test_tokenize_truncates_at_the_context(bpe_file):
    long = " ".join(["table"] * 100)
    got = tct.tokenize([long], bpe_file, 16)
    np.testing.assert_array_equal(got, jct.tokenize([long], bpe_file, 16))
    assert got[0, -1] == tct.EOT_TOKEN and got[0, 0] == tct.SOT_TOKEN


# ------------------------------------------------ TorchCLIPTextEncoder (HF)


@pytest.fixture(scope="module")
def hf_vocab(tmp_path_factory, bpe_file):
    """vocab.json / merges.txt of the test merges (CLIP's layout)."""
    tok = jct.SimpleTokenizer(bpe_file)
    d = tmp_path_factory.mktemp("hfvocab")
    (d / "vocab.json").write_text(json.dumps(tok.encoder), encoding="utf-8")
    merges = sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges)
                                  + "\n", encoding="utf-8")
    return d, len(tok.encoder)


@pytest.mark.parametrize("weights", ["safetensors", "bin"])
def test_torch_clip_text_encoder_matches_jax(tmp_path, hf_vocab, weights):
    """A tiny random Hugging Face CLIPModel saved with its tokenizer: the
    port's reader (no transformers) against the JAX package's
    TorchCLIPTextEncoder (transformers) on the label sets."""
    from transformers import (CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPProcessor,
                              CLIPTokenizer)

    from semantic_gaussians_tpu.models.predictors import TorchCLIPTextEncoder as JaxEncoder
    from semantic_gaussians_torch.models.predictors import TorchCLIPTextEncoder

    vocab_dir, n_vocab = hf_vocab
    torch.manual_seed(5)
    cfg = CLIPConfig(
        text_config=dict(vocab_size=n_vocab, hidden_size=64, intermediate_size=256,
                         num_hidden_layers=2, num_attention_heads=4, hidden_act="quick_gelu",
                         bos_token_id=n_vocab - 2, eos_token_id=n_vocab - 1,
                         pad_token_id=n_vocab - 1),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                           num_attention_heads=2, image_size=32, patch_size=16),
        projection_dim=24)
    model = CLIPModel(cfg).eval()
    model.save_pretrained(tmp_path, safe_serialization=weights == "safetensors")
    tok = CLIPTokenizer(str(vocab_dir / "vocab.json"), str(vocab_dir / "merges.txt"))
    CLIPProcessor(image_processor=CLIPImageProcessor(), tokenizer=tok).save_pretrained(tmp_path)
    assert (tmp_path / ("model.safetensors" if weights == "safetensors"
                        else "pytorch_model.bin")).exists()

    labels = list(SCANNET20_CLASS_LABELS + COCOMAP_CLASS_LABELS)
    want = JaxEncoder(str(tmp_path), 24).extract_text_feature(labels)
    got = TorchCLIPTextEncoder(tmp_path, 24, device="cpu").extract_text_feature(labels)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_read_safetensors_matches_the_library(tmp_path):
    from safetensors.torch import save_file

    from semantic_gaussians_torch.models.predictors import read_safetensors

    g = torch.Generator().manual_seed(6)
    tensors = {"f32": torch.randn((3, 5), generator=g),
               "f16": torch.randn((4,), generator=g).half(),
               "bf16": torch.randn((2, 3), generator=g).bfloat16(),
               "i64": torch.arange(7), "scalar": torch.tensor(2.5)}
    save_file(tensors, str(tmp_path / "m.safetensors"), metadata={"format": "pt"})
    got = read_safetensors(tmp_path / "m.safetensors")
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


# --------------------------------------------------------------- image tower

VISION = dict(image_size=16, patch=8, width=12, layers=2, heads=2, embed_dim=6)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_vision_tower_matches_jax(direction, rng):
    jtower = jcv.CLIPVisionTower(**VISION)
    x = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    if direction == "port_to_jax":
        tower = random_init_(tcv.CLIPVisionTower(**VISION), seed=7)
        sd = {"visual." + k: v for k, v in _np(tower.state_dict()).items()}
        params = jcv.params_from_torch_state_dict(sd, jtower)
    else:
        params = jtower.init(jax.random.PRNGKey(7), x)
        tower = tcv.CLIPVisionTower(**VISION)
        tower.load_state_dict(tcv.state_from_flax(params))
    want = jcv.JaxCLIPImageEncoder(tower=jtower, params=params).encode_image(x)
    got = tcv.CLIPImageEncoder(tower, device="cpu").encode_image(x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_vision_tower_from_a_full_clip_state_dict(rng):
    """A full OpenAI-layout CLIP state dict (text keys, `visual.*`,
    logit_scale): the image tower's widths come from its `visual.*` keys,
    the text tower's from the rest."""
    vis = random_init_(tcv.CLIPVisionTower(**dict(VISION, width=64, heads=1)), seed=8)
    txt = random_init_(tct.CLIPTextTower(vocab_size=60, width=64, layers=1, heads=1,
                                         embed_dim=6), seed=9)
    full = dict(txt.state_dict(), logit_scale=torch.tensor(4.6),
                **{"visual." + k: v for k, v in vis.state_dict().items()})
    v2 = tcv.CLIPVisionTower.from_state_dict(full)
    assert (v2.image_size, v2.embed_dim, len(v2.transformer.resblocks)) == (16, 6, 2)
    t2 = tct.CLIPTextTower.from_state_dict(full)
    assert t2.embed_dim == 6 and t2.token_embedding.weight.shape == (60, 64)
    x = torch.from_numpy(rng.uniform(size=(2, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(v2(x), vis(x), rtol=0, atol=0)


def test_float16_torchscript_clip_archive_matches_jax(tmp_path, rng):
    """An OpenAI CLIP .pt as published: a TorchScript archive of float16
    weights. The port's encoders load it with the weights in float32 and
    match the JAX package's encoders loaded from the same file (its
    converters cast every weight to float32)."""
    tkw = dict(vocab_size=60, width=64, layers=2, heads=1, embed_dim=6)
    vkw = dict(VISION, width=64, heads=1)
    txt = random_init_(tct.CLIPTextTower(**tkw), seed=11)
    vis = random_init_(tcv.CLIPVisionTower(**vkw), seed=12)

    class OpenAICLIP(torch.nn.Module):  # the module layout of OpenAI's clip.model.CLIP
        def __init__(self):
            super().__init__()
            self.visual, self.transformer = vis, txt.transformer
            self.token_embedding, self.ln_final = txt.token_embedding, txt.ln_final
            self.positional_embedding = txt.positional_embedding
            self.text_projection = txt.text_projection
            self.logit_scale = torch.nn.Parameter(torch.tensor(4.6))

        def forward(self, x):
            return x * self.logit_scale.exp()

    path = tmp_path / "ViT-tiny.pt"
    torch.jit.save(torch.jit.trace(OpenAICLIP().half(), torch.ones(2, dtype=torch.float16)),
                   path)
    assert {v.dtype for v in torch.jit.load(path).state_dict().values()} == {torch.float16}
    text = tct.CLIPTextEncoder(path, device="cpu")
    image = tcv.CLIPImageEncoder(checkpoint_path=path, device="cpu")
    for tower in (text.tower, image.tower):
        assert {p.dtype for p in tower.state_dict().values()} == {torch.float32}
    ids = _ids(rng, 60, rows=(4, 9))
    jtext = jct.JaxCLIPTextEncoder(str(path), tower=jct.CLIPTextTower(**tkw))
    np.testing.assert_allclose(text.encode_tokens(ids), jtext.encode_tokens(ids),
                               rtol=RTOL, atol=ATOL)
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    jimage = jcv.JaxCLIPImageEncoder(tower=jcv.CLIPVisionTower(**vkw), checkpoint_path=str(path))
    np.testing.assert_allclose(image.encode_image(x), jimage.encode_image(x),
                               rtol=RTOL, atol=ATOL)


def test_vision_attention_matches_torch_mha(rng):
    """The packed attention equals torch's multi_head_attention_forward
    with the same weights (the JAX package's test_sam.py check)."""
    dim, heads, t = 16, 2, 5
    attn = random_init_(tct.PackedAttention(dim, heads), seed=10, std=0.3)
    x = torch.from_numpy(rng.normal(size=(1, t, dim)).astype(np.float32))
    want, _ = torch.nn.functional.multi_head_attention_forward(
        x.transpose(0, 1), x.transpose(0, 1), x.transpose(0, 1), dim, heads,
        attn.in_proj_weight, attn.in_proj_bias, None, None, False, 0.0,
        attn.out_proj.weight, attn.out_proj.bias)
    with torch.no_grad():
        torch.testing.assert_close(attn(x), want.transpose(0, 1), rtol=1e-4, atol=1e-5)

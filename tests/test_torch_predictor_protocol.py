"""Predictor2D: the port declares the JAX package's protocol (the same
members), every port provider meets it (isinstance on the runtime-
checkable protocol, and the same call shapes), and make_predictor is
annotated with it. The towers are built from small random checkpoints in
their public layouts on the CPU."""
import inspect
import typing

import numpy as np
import pytest

from semantic_gaussians_tpu.models import predictors as J
from semantic_gaussians_torch.models import predictors as T
from test_torch_predictors2d import _tower_cfg, checkpoints  # noqa: F401  (a fixture)


def _members(proto):
    return {m for m in dir(proto) if not m.startswith("_")} | set(
        typing.get_type_hints(proto))


def test_protocol_has_the_jax_members():
    assert _members(T.Predictor2D) == _members(J.Predictor2D) == {
        "embedding_dim", "extract_image_feature", "extract_text_feature"}
    for name in ("extract_image_feature", "extract_text_feature"):
        got = inspect.signature(getattr(T.Predictor2D, name))
        want = inspect.signature(getattr(J.Predictor2D, name))
        assert list(got.parameters) == list(want.parameters)
    assert inspect.signature(T.make_predictor).return_annotation in (T.Predictor2D,
                                                                     "Predictor2D")


def _check(p, dim):
    assert isinstance(p, T.Predictor2D)
    assert p.embedding_dim == dim
    for name in ("extract_image_feature", "extract_text_feature"):
        params = list(inspect.signature(getattr(p, name)).parameters.values())
        assert len(params) >= (2 if name == "extract_image_feature" else 1)
        assert all(q.default is not inspect.Parameter.empty for q in params[
            (2 if name == "extract_image_feature" else 1):])


def test_random_and_precomputed_providers(tmp_path):
    p = T.make_predictor("random", {"embedding_dim": 24})
    _check(p, 24)
    feat = p.extract_image_feature("a/b.png", (20, 10))
    assert feat.shape == (10, 20, 24)
    np.testing.assert_array_equal(feat, J.RandomFeatureProvider(24).extract_image_feature(
        "a/b.png", (20, 10)))
    np.save(tmp_path / "v.npy", np.ones((4, 6, 24), np.float32))
    q = T.make_predictor("precomputed", {"feature_dir": str(tmp_path), "embedding_dim": 24})
    _check(q, 24)
    assert q.extract_image_feature("x/v.png", (6, 4)).shape == (4, 6, 24)


@pytest.mark.parametrize("name", ["lseg", "samclip", "vlpart", "vlpart_native"])
def test_tower_providers_meet_the_protocol(checkpoints, name):  # noqa: F811
    base = name.split("_")[0]
    p = T.make_predictor(base, _tower_cfg(checkpoints, base, native=name.endswith("native")),
                         device="cpu")
    _check(p, 16)
    assert p.extract_text_feature(["chair"]).shape == (1, 16)


def test_text_encoders_meet_the_protocol(checkpoints):  # noqa: F811
    from semantic_gaussians_torch.models.clip_text import CLIPTextEncoder
    from semantic_gaussians_torch.models.common import load_torch_state_dict

    enc = CLIPTextEncoder(state_dict=load_torch_state_dict(checkpoints / "clip.pt"),
                          bpe_path=str(checkpoints / "bpe.txt.gz"), device="cpu")
    _check(enc, 16)
    with pytest.raises(NotImplementedError):
        enc.extract_image_feature("x.png", (4, 4))
    assert isinstance(T.TorchCLIPTextEncoder, type) and issubclass(
        T.TorchCLIPTextEncoder, object)
    for cls in (T.TorchCLIPTextEncoder, T.PrecomputedFeatureProvider, T.RandomFeatureProvider):
        assert {"extract_image_feature", "extract_text_feature"} <= set(dir(cls))

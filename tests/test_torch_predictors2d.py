"""The port's 2D providers (SAMCLIP, VLPart, the detection exports,
make_predictor and the CLIs' model_2d) against the JAX package's, on the
CPU with tiny towers. Where a threshold of the logits decides a mask, both
packages are given the port's masks (the float part is held in
test_torch_automask.py); features then agree at 1e-4, with unit norm
where covered, and fused point masks are identical."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_port_common  # noqa: F401  (one torch thread per worker)
from semantic_gaussians_tpu.models import automask as jam
from semantic_gaussians_tpu.models import clip_vision as jcv
from semantic_gaussians_tpu.models import samclip as jsc
from semantic_gaussians_tpu.models import sam as jsam
from semantic_gaussians_tpu.models import vlpart as jvl
from semantic_gaussians_torch.models import automask as tam
from semantic_gaussians_torch.models import clip_vision as tcv
from semantic_gaussians_torch.models import samclip as tsc
from semantic_gaussians_torch.models import vlpart as tvl
from semantic_gaussians_torch.models.common import random_init_
from semantic_gaussians_torch.models.predictors import RandomFeatureProvider
from test_torch_automask import CFG_J, port_sam
from torch_port_common import np_, write_toy_blender_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
VISION = dict(image_size=16, patch=8, width=12, layers=1, heads=2, embed_dim=6)
AMG = dict(points_per_side=3, points_per_batch=4, pred_iou_thresh=-1e9,
           stability_score_thresh=-1.0, min_mask_region_area=0)
VOCAB = ["chair", "table", "lamp", "sofa"]


def towers(seed=0):
    """(port SAM, port CLIP image tower, the JAX variables of both)."""
    sam = port_sam(seed)
    vis = random_init_(tcv.CLIPVisionTower(**VISION), seed=seed + 1, std=0.2).eval()
    jsam_var = jsam.params_from_sam_state_dict(sam.state_dict(), CFG_J)
    jvis_var = jcv.params_from_torch_state_dict(
        {"visual." + k: v for k, v in vis.state_dict().items()}, jcv.CLIPVisionTower(**VISION))
    return sam, vis, jsam_var, jvis_var


@pytest.mark.parametrize("bbox", [(3, 2, 5, 20), (1, 4, 30, 6), (5, 5, 0, 0), (0, 0, 40, 34)],
                         ids=["tall", "wide", "empty", "shrink"])
def test_pad_square_crop_matches_jax(rng, bbox):
    img = rng.uniform(size=(34, 40, 3)).astype(np.float32)
    seg = rng.uniform(size=(34, 40)) > 0.3
    got = tsc.pad_square_crop(img, seg, bbox, 16).numpy()
    np.testing.assert_allclose(got, jsc.pad_square_crop(img, seg, bbox, 16), rtol=0, atol=2e-5)


def test_sum_crop_features_matches_masked_adds(rng):
    """One matrix product against the JAX package's masked add per mask,
    in descending-area order, then the L2 norm (+1e-8)."""
    masks = rng.uniform(size=(40, 24, 30)) > 0.7
    masks[3] = False
    embs = rng.normal(size=(40, 12)).astype(np.float32)
    want = np.zeros((24, 30, 12), np.float32)
    for m, e in zip(masks, embs):
        want[m] += e
    want /= np.linalg.norm(want, axis=-1, keepdims=True) + 1e-8
    got = tsc.sum_crop_features(torch.from_numpy(masks), torch.from_numpy(embs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _samclip_pair(monkeypatch, seed):
    """The port's and the JAX package's SAMCLIP predictors on the same
    weights; the JAX one is handed the masks the port's generator made."""
    sam, vis, jsam_var, jvis_var = towers(seed)
    tp = tsc.SAMCLIPPredictor(sam_model=sam, clip_encoder=tcv.CLIPImageEncoder(vis, device="cpu"),
                              amg=tam.AutoMaskConfig(**AMG), device="cpu")
    jp = jsc.SAMCLIPPredictor(
        sam_cfg=CFG_J, sam_variables=jsam_var, amg=jam.AutoMaskConfig(**AMG),
        clip_encoder=jcv.JaxCLIPImageEncoder(tower=jcv.CLIPVisionTower(**VISION),
                                             params=jvis_var))
    shared = []
    generate = tp.mask_generator.generate

    def recording(image):
        out = generate(image)
        shared.append(out)
        return out

    monkeypatch.setattr(tp.mask_generator, "generate", recording)
    monkeypatch.setattr(jp.mask_generator, "generate", lambda image: shared.pop(0))
    return tp, jp


@pytest.mark.parametrize("img_size", [None, (48, 32)], ids=["native", "resized"])
def test_samclip_features_match_jax(monkeypatch, rng, img_size):
    tp, jp = _samclip_pair(monkeypatch, seed=1)
    img = (rng.uniform(size=(40, 52, 3)) * 255).astype(np.uint8)
    got = tp.extract_image_feature(img, img_size)
    want = jp.extract_image_feature(img, img_size)
    assert got.shape == ((40, 52, 6) if img_size is None else (32, 48, 6))
    norms = np.linalg.norm(got, axis=-1)
    assert (norms > 0.5).any()
    np.testing.assert_allclose(norms[norms > 0.5], 1.0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _fusion_scene(rng, tmp_path):
    img = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
    path = tmp_path / "view0.png"
    Image.fromarray(img).save(path)
    n, cap = 60, 64
    pts = (rng.normal(size=(n, 3)) * 0.3 + [0, 0, 2.5]).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    return str(path), pts, cols, cap, (np.eye(3), np.zeros(3), 1.2, 1.0, 64, 48)


def _fuse_both(tp, jp, path, pts, cols, cap, cam):
    from semantic_gaussians_tpu.core.gaussians import init_from_pcd as jax_init_from_pcd
    from semantic_gaussians_tpu.pipelines.fusion import FusionConfig as JaxFusionConfig
    from semantic_gaussians_tpu.pipelines.fusion import fuse_scene as jax_fuse
    from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
    from semantic_gaussians_torch.core.gaussians import init_from_pcd
    from semantic_gaussians_torch.pipelines.fusion import FusionConfig, fuse_scene
    from semantic_gaussians_torch.utils.camera import make_camera

    params, alive = init_from_pcd(pts, cols, capacity=cap)
    tf, tv = fuse_scene(params, alive, [make_camera(*cam)], tp,
                        FusionConfig(img_dim=(64, 48), depth=None, every_k_views=1),
                        image_paths=[path])
    jf, jv = jax_fuse(*jax_init_from_pcd(pts, cols, capacity=cap), [jax_camera(*cam)], jp,
                      JaxFusionConfig(img_dim=(64, 48), depth=None, every_k_views=1),
                      image_paths=[path], backend="dense")
    assert tf.shape == (cap, 6) and bool(tv.any()) and np.isfinite(np_(tf)).all()
    np.testing.assert_array_equal(np_(tv), np_(jv))
    np.testing.assert_allclose(np_(tf), np_(jf), rtol=0, atol=1e-4)


def test_samclip_predictor_feeds_fusion(monkeypatch, rng, tmp_path):
    tp, jp = _samclip_pair(monkeypatch, seed=2)
    _fuse_both(tp, jp, *_fusion_scene(rng, tmp_path))


def _detector(image):
    h, w = image.shape[:2]
    boxes = np.array([[2, 2, w * 0.6, h * 0.6], [w * 0.3, h * 0.3, w - 2, h - 2],
                      [1, h * 0.5, w * 0.5, h - 1]], np.float32)
    return boxes, np.array([0.9, 0.5, 0.2], np.float32), np.array([1, 3, 0])


def _vlpart_pair(monkeypatch, seed, detector=_detector, **kw):
    """The port's and the JAX package's VLPart predictors on the same SAM
    weights and text features; the JAX one's resample returns the port's
    resampled box logits."""
    sam, _, jsam_var, _ = towers(seed)
    text = RandomFeatureProvider(6)
    tp = tvl.VLPartPredictor(detector, sam_model=sam, text_encoder=text, vocabulary=VOCAB,
                             device="cpu", **kw)
    jp = jvl.VLPartPredictor(detector, sam_cfg=CFG_J, sam_variables=jsam_var, text_encoder=text,
                             vocabulary=VOCAB, **kw)
    shared = []
    resample = tvl.resample_logits

    def recording(*a):
        out = resample(*a)
        shared.append(out.numpy())
        return out

    monkeypatch.setattr(tvl, "resample_logits", recording)
    monkeypatch.setattr(jax.image, "scale_and_translate",
                        lambda *a, **k: jnp.asarray(shared.pop(0)))
    return tp, jp


@pytest.mark.parametrize("img_size,min_hole", [(None, 0), ((36, 24), 0), ((52, 40), 30)],
                         ids=["native", "nearest", "holes"])
def test_vlpart_features_match_jax(monkeypatch, rng, img_size, min_hole):
    tp, jp = _vlpart_pair(monkeypatch, 3, box_threshold=0.3, min_hole_area=min_hole)
    img = (rng.uniform(size=(40, 52, 3)) * 255).astype(np.uint8)
    got = tp.extract_image_feature(img, img_size)
    want = jp.extract_image_feature(img, img_size)
    assert got.shape == ((40, 52, 6) if img_size is None else (img_size[1], img_size[0], 6))
    norms = np.linalg.norm(got, axis=-1)
    assert ((norms < 1e-4) | (np.abs(norms - 1) < 1e-3)).all() and (norms > 0.5).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_vlpart_drops_weak_detections(monkeypatch, rng):
    def weak(image):
        b, s, c = _detector(image)
        return b, s * 0.1, c

    tp, _ = _vlpart_pair(monkeypatch, 4, detector=weak)
    img = (rng.uniform(size=(40, 52, 3)) * 255).astype(np.uint8)
    feats = tp.extract_image_feature(img, (24, 36))
    assert feats.shape == (36, 24, 6) and (feats == 0).all()
    with pytest.raises(ValueError, match="set_predefined_cls"):
        tvl.VLPartPredictor(weak, sam_model=port_sam(0), device="cpu").extract_image_feature(img)


def test_vlpart_predictor_feeds_fusion(monkeypatch, rng, tmp_path):
    tp, jp = _vlpart_pair(monkeypatch, 5, min_hole_area=0)
    _fuse_both(tp, jp, *_fusion_scene(rng, tmp_path))


def test_detection_export_schema_roundtrip(tmp_path, rng):
    """save_detections <-> PrecomputedDetections in both directions across
    the two packages, empty exports, and the schema's refusals."""
    boxes = np.sort(rng.uniform(0, 100, (5, 4)).astype(np.float32), axis=-1)
    scores = rng.uniform(0.3, 1.0, 5).astype(np.float32)
    classes = rng.integers(0, 19, 5)
    tvl.save_detections(tmp_path / "a" / "frame_000.npz", boxes, scores, classes)
    jvl.save_detections(tmp_path / "b" / "frame_000.npz", boxes, scores, classes)
    for reader, d in ((jvl.PrecomputedDetections, "a"), (tvl.PrecomputedDetections, "b"),
                      (tvl.PrecomputedDetections, "a")):
        det = reader(tmp_path / d)
        det.set_current("color/frame_000.jpg")
        b, s, c = det(np.zeros((4, 4, 3), np.uint8))
        np.testing.assert_array_equal(b, boxes)
        np.testing.assert_array_equal(s, scores)
        np.testing.assert_array_equal(c, classes.astype(np.int64))
        assert c.dtype == np.int64 and b.dtype == np.float32 and s.dtype == np.float32
    tvl.save_detections(tmp_path / "a" / "empty.npz", np.zeros((0, 4)), [], [])
    det = tvl.PrecomputedDetections(tmp_path / "a")
    det.set_current("empty.png")
    b, s, c = det(np.zeros((4, 4, 3), np.uint8))
    assert b.shape == (0, 4) and len(s) == 0 and len(c) == 0
    with pytest.raises(ValueError, match="ragged"):
        tvl.save_detections(tmp_path / "bad.npz", boxes, scores[:3], classes)
    with pytest.raises(ValueError, match="xyxy"):
        tvl.save_detections(tmp_path / "bad.npz", boxes[:, [2, 1, 0, 3]], scores, classes)
    with pytest.raises(ValueError, match="set_current"):
        tvl.PrecomputedDetections(tmp_path)(np.zeros((4, 4, 3), np.uint8))


def test_native_detector_matches_jax(monkeypatch, rng):
    """SAM proposals x CLIP classification on the same weights and the same
    proposals: boxes and classes exact, scores within 1e-4; then through
    the whole VLPart predictor."""
    sam, vis, jsam_var, jvis_var = towers(6)
    text = RandomFeatureProvider(6)
    tgen = tam.SamAutoMask(sam, tam.AutoMaskConfig(**AMG))
    shared = []
    generate = tgen.generate

    def recording(image):
        out = generate(image)
        shared.append(out)
        return out

    monkeypatch.setattr(tgen, "generate", recording)
    tdet = tvl.NativeOpenVocabDetector(tgen, tcv.CLIPImageEncoder(vis, device="cpu"), text,
                                       vocabulary=VOCAB)
    jgen = jam.SamAutoMask(CFG_J, jsam_var, jam.AutoMaskConfig(**AMG))
    monkeypatch.setattr(jgen, "generate", lambda image: shared.pop(0))
    jdet = jvl.NativeOpenVocabDetector(
        jgen, jcv.JaxCLIPImageEncoder(tower=jcv.CLIPVisionTower(**VISION), params=jvis_var), text,
        vocabulary=VOCAB)
    np.testing.assert_allclose(tdet.text_features, jdet.text_features, rtol=1e-6)
    img = (rng.uniform(size=(40, 52, 3)) * 255).astype(np.uint8)
    (b, s, c), (jb, js, jc) = tdet(img), jdet(img)
    assert not shared and len(jb) == len(b)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-4)
    if len(b):
        assert (b[:, 0] <= b[:, 2]).all() and (b[:, [0, 2]] <= 52).all()
        assert ((0 <= c) & (c < 4)).all() and (s > 0).all() and (s <= 1).all()
    tp = tvl.VLPartPredictor(tdet, sam_model=sam, text_encoder=text, vocabulary=VOCAB,
                             box_threshold=0.0, min_hole_area=0, device="cpu")
    feats = tp.extract_image_feature(img, (36, 24))
    norms = np.linalg.norm(feats, axis=-1)
    assert feats.shape == (24, 36, 6) and ((norms < 1e-4) | (np.abs(norms - 1) < 1e-3)).all()


# ------------------------------------------------- make_predictor and the CLIs

SMALL_SAM = dict(img_size=64, patch=8, embed_dim=64, depth=2, num_heads=2, window=2,
                 global_blocks=(1,), out_chans=16, decoder_dim=16, decoder_heads=8,
                 decoder_mlp=32)
SMALL_TEXT = dict(width=64, layers=1, heads=1, embed_dim=16)
SMALL_VISION = dict(image_size=16, patch=8, width=64, layers=1, heads=1, embed_dim=16)
SMALL_LSEG = dict(patch=16, width=64, layers=4, heads=1, taps=(0, 1, 2, 3), native_grid=4,
                  reassemble_ch=(16, 24, 32, 32), features=24, out_ch=16)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Small random checkpoints in the public layouts, a BPE file of the
    label words and the detections of a toy scene's views."""
    from semantic_gaussians_torch.data.scannet_constants import COCOMAP_CLASS_LABELS
    from semantic_gaussians_torch.models.lseg import LSegConfig
    from semantic_gaussians_torch.models.sam import SamConfig
    from semantic_gaussians_torch.tools import random_checkpoints as rc

    d = tmp_path_factory.mktemp("ckpt")
    rc.write_sam(d / "sam.pth", SamConfig(**SMALL_SAM), seed=1)
    rc.write_clip(d / "clip.pt", SMALL_TEXT, SMALL_VISION, seed=2)
    rc.write_lseg(d / "lseg.ckpt", LSegConfig(**SMALL_LSEG), SMALL_TEXT, seed=3)
    words = {w for lab in COCOMAP_CLASS_LABELS for w in lab.split()} | {"a", "other"}
    rc.write_bpe(d / "bpe.txt.gz", sorted(words))
    write_toy_blender_scene(d / "toy_scene", views=4, w=64, h=48)
    for i in range(4):
        tvl.save_detections(d / "dets" / f"r_{i}.npz", [[2, 2, 40, 30], [20, 10, 62, 46]],
                            [0.9, 0.6], [1, 4])
    return d


def _tower_cfg(d, name, native=False):
    cfg = {"lseg_checkpoint": str(d / "lseg.ckpt"), "sam_checkpoint": str(d / "sam.pth"),
           "clip_checkpoint": str(d / "clip.pt"), "bpe_path": str(d / "bpe.txt.gz"),
           "vocabulary": ["chair", "table", "lamp", "sofa", "door"]}
    if name == "vlpart" and not native:
        cfg["detections_dir"] = str(d / "dets")
    return cfg


@pytest.mark.parametrize("name", ["lseg", "samclip", "vlpart", "vlpart_native"])
def test_make_predictor_builds_each_tower(checkpoints, name):
    """make_predictor on the CPU from checkpoint files: the configs come
    from the weights, text features are unit rows, image features unit
    where covered (the random towers may cover nothing)."""
    from semantic_gaussians_torch.models.predictors import make_predictor

    base = name.split("_")[0]
    p = make_predictor(base, _tower_cfg(checkpoints, base, native=name.endswith("native")),
                       device="cpu")
    assert p.embedding_dim == 16
    t = p.extract_text_feature(["chair", "a table"])
    assert t.shape == (2, 16)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, rtol=1e-5)
    feat = p.extract_image_feature(str(checkpoints / "toy_scene" / "train" / "r_0.png"), (64, 48))
    assert feat.shape == (48, 64, 16) and feat.dtype == np.float32 and np.isfinite(feat).all()
    norms = np.linalg.norm(feat, axis=-1)
    assert ((norms < 1e-4) | (np.abs(norms - 1) < 1e-3)).all()
    if name in ("lseg", "vlpart"):
        assert (norms > 0.5).all() if name == "lseg" else (norms > 0.5).any()


def _toy_model(d):
    from semantic_gaussians_torch.core.gaussians import params_from_numpy
    from semantic_gaussians_torch.io.ply import save_gaussian_ply
    from torch_port_common import scene_arrays

    ply = d / "model" / "point_cloud" / "iteration_1" / "point_cloud.ply"
    if not ply.exists():
        arrays, _ = scene_arrays(n=400, seed=11)
        arrays["opacity_logits"] += 2.0
        save_gaussian_ply(ply, params_from_numpy(arrays, "cpu"))
    return d / "model"


@pytest.mark.parametrize("name", ["lseg", "samclip", "vlpart"])
def test_fusion_cli_runs_each_tower(checkpoints, name):
    """`cli.fusion --device cpu` with fusion.model_2d=<tower> and the YAML's
    checkpoint keys, depth=render: the fused .pt reloads, features finite
    and no longer than a unit vector (means of unit rows)."""
    from semantic_gaussians_torch.cli import fusion as fusion_cli
    from semantic_gaussians_torch.config.config import default_config_dir
    from semantic_gaussians_torch.pipelines.fusion import load_fused_features

    d = checkpoints
    out = d / f"fused_{name}"
    keys = _tower_cfg(d, name)
    overrides = [f"scene.scene_path={d / 'toy_scene'}", f"model.model_dir={_toy_model(d)}",
                 f"fusion.out_dir={out}", f"fusion.model_2d={name}", "fusion.embedding_dim=16",
                 "fusion.img_dim=[64,48]", "fusion.every_k_views=2", "fusion.depth=render",
                 "fusion.cut_boundary=2", "fusion.visibility_threshold=0.2"]
    overrides += [f"fusion.{k}={v}" for k, v in keys.items() if k != "vocabulary"]
    overrides.append("fusion.vocabulary=[" + ",".join(keys["vocabulary"]) + "]")
    summary = fusion_cli.main([str(default_config_dir() / "fusion_scannet.yaml"),
                               "--device", "cpu", *overrides])
    assert summary["views"] == 2
    feats, visited = load_fused_features(summary["out_path"])
    assert feats.shape[1] == 16 and int(visited.sum()) == summary["visited"]
    assert torch.isfinite(feats).all()
    assert (feats.norm(dim=-1) <= 1 + 1e-3).all()
    if name == "lseg":  # LSeg covers every pixel
        assert summary["visited"] > 0


def test_eval_cli_pretrained_with_lseg(checkpoints, tmp_path):
    """`cli.eval_segmentation --device cpu` in mode pretrained with
    eval.model_2d=lseg: text and per-view features from the checkpoint."""
    from semantic_gaussians_torch.cli import eval_segmentation as eval_cli
    from semantic_gaussians_torch.config.config import default_config_dir

    d = checkpoints
    labels = tmp_path / "labels"
    labels.mkdir()
    rng = np.random.default_rng(12)
    Image.fromarray(rng.integers(0, 21, size=(48, 64), dtype=np.uint8)).save(labels / "r_0.png")
    res = eval_cli.main([
        str(default_config_dir() / "eval.yaml"), "--device", "cpu",
        f"scene.scene_path={d / 'toy_scene'}", f"model.model_dir={_toy_model(d)}",
        "eval.eval_mode=pretrained", "eval.model_2d=lseg", f"eval.label_dir={labels}",
        "eval.width=64", "eval.height=48", f"eval.lseg_checkpoint={d / 'lseg.ckpt'}",
        f"eval.bpe_path={d / 'bpe.txt.gz'}", f"eval.log_file={tmp_path / 'log.txt'}",
        "fusion.embedding_dim=16"])
    miou, macc, confusion = res
    assert np.isfinite(miou) and np.isfinite(macc)
    assert int(np.asarray(confusion).sum()) > 0


@pytest.mark.parametrize("name", ["fusion_scannet", "fusion_mipnerf360", "fusion_mvimgnet",
                                  "fusion_panoptic", "eval"])
def test_port_yamls_carry_the_jax_keys(name):
    """Each port YAML, loaded through the port's load_config, has every key
    of the JAX package's file with its value, but for the renderer backend
    (the port's tiled kernels for JAX's Pallas); its own additions are the
    device, the map precision, the tower keys, the eval log and label-map
    paths and the eval voxel budget."""
    from semantic_gaussians_torch.config.config import default_config_dir, load_config

    port = load_config(default_config_dir() / f"{name}.yaml", []).to_dict()
    jax_cfg = yaml.safe_load((REPO / "semantic_gaussians_tpu/config/yamls" /
                              f"{name}.yaml").read_text())

    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, f"{pre}{k}.") if isinstance(v, dict) else {pre + k: v})
        return out

    fp, fj = flat(port), flat(jax_cfg)
    assert set(fj) <= set(fp), sorted(set(fj) - set(fp))
    for k, v in fj.items():
        assert fp[k] == (v if k != "pipeline.backend" else "tiled"), k
    allowed = {"fusion.device", "fusion.feat_dtype", "fusion.chunk_views", "fusion.bpe_path",
               "fusion.vocabulary", "eval.device", "eval.model_2d", "eval.lseg_checkpoint",
               "eval.sam_checkpoint", "eval.clip_checkpoint", "eval.bpe_path",
               "eval.detections_dir", "eval.vocabulary", "eval.labelmap_dir", "eval.log_file",
               "distill.voxel_budget"}
    assert set(fp) - set(fj) <= allowed, sorted(set(fp) - set(fj) - allowed)


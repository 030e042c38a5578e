"""Port parity: open-vocabulary evaluation. The same numpy inputs go
through the JAX package (on the CPU, Pallas in interpret mode) and the
port: metrics and label mapping are exact; predicted label images agree on
at least 99.9% of the pixels in both prediction paths; `eval_views`
confusions differ by at most that share; the eval CLI on the CPU is held
against the root eval_segmentation.py in all five modes: in 3d and
2d_and_3d (concat and argmax) on the same distilled checkpoint, the
per-Gaussian features fed to evaluation agree within 1e-4 x their largest
magnitude and the confusion matrices are equal."""
import pathlib
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from semantic_gaussians_tpu.data import scannet_constants as jconst  # noqa: E402
from semantic_gaussians_tpu.io.ply import save_gaussian_ply as jax_save_ply  # noqa: E402
from semantic_gaussians_tpu.models.predictors import (  # noqa: E402
    RandomFeatureProvider as JaxRandomProvider,
)
from semantic_gaussians_tpu.pipelines import eval_segmentation as jeval  # noqa: E402
from semantic_gaussians_tpu.utils import metrics as jmetrics  # noqa: E402
from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera  # noqa: E402
from semantic_gaussians_torch.cli import eval_segmentation as eval_cli  # noqa: E402
from semantic_gaussians_torch.config.config import default_config_dir  # noqa: E402
from semantic_gaussians_torch.data import scannet_constants as tconst  # noqa: E402
from semantic_gaussians_torch.models.predictors import RandomFeatureProvider  # noqa: E402
from semantic_gaussians_torch.pipelines import eval_segmentation as teval  # noqa: E402
from semantic_gaussians_torch.pipelines.fusion import save_fused_features  # noqa: E402
from semantic_gaussians_torch.utils import metrics as tmetrics  # noqa: E402
from semantic_gaussians_torch.utils.camera import make_camera as torch_camera  # noqa: E402
from torch_port_common import (  # noqa: E402
    jax_params, np_, scene_arrays, torch_params, write_toy_blender_scene,
)

W, H, D = 64, 48, 16
LABELS = ("wall", "floor", "chair", "table", "door")


# ---------------------------------------------------------------- metrics
def test_confusion_and_report_match_numpy(tmp_path):
    rng = np.random.default_rng(31)
    k = 6
    pred = rng.integers(0, k + 1, size=(H, W))
    gt = rng.integers(0, k + 1, size=(H, W))
    gt[gt == 2] = 3  # a class with no ground truth is skipped in the means
    want = jmetrics.confusion_matrix(pred, gt, k)
    np.testing.assert_array_equal(tmetrics.confusion_matrix(pred, gt, k), want)
    dev = tmetrics.confusion_matrix_device(
        torch.from_numpy(pred).to(torch.int32), torch.from_numpy(gt), k)
    assert dev.dtype == torch.int64 and dev.shape == (k, k + 1)
    np.testing.assert_array_equal(np_(dev), want)
    np.testing.assert_array_equal(
        np_(dev), np.asarray(jmetrics.confusion_matrix_device(jnp.asarray(pred), jnp.asarray(gt), k)))
    names = [f"class{i}" for i in range(k)]
    for i in range(k):
        assert tmetrics.get_iou(i, want) == jmetrics.get_iou(i, want)
    logs = tmp_path / "t.log", tmp_path / "j.log"
    got = tmetrics.evaluate_confusion(want, names, dataset="toy", log_file=str(logs[0]))
    ref = jmetrics.evaluate_confusion(want, names, dataset="toy", log_file=str(logs[1]))
    assert got == ref and 0 < got[0] < 1
    assert logs[0].read_text() == logs[1].read_text()
    assert "class2        : -" in logs[0].read_text()
    assert tmetrics.evaluate_confusion(np.zeros((k, k + 1), np.int64), names) == (0.0, 0.0)


def test_label_constants_and_mapping_match_jax(tmp_path):
    assert tconst.SCANNET20_CLASS_LABELS == jconst.SCANNET20_CLASS_LABELS
    assert tconst.COCOMAP_CLASS_LABELS == jconst.COCOMAP_CLASS_LABELS
    np.testing.assert_array_equal(tconst.COLORMAP, jconst.COLORMAP)
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("id\traw_category\tscannetid\tcocomapid\n1\twall\t0\t0\n2\tchair\t4\t4\n"
                   "5\tx\t\t7\nbad\ty\t3\t3\n9\tlamp\t18\t18\n")
    for label_to in ("scannetid", "cocomapid"):
        got = tconst.read_label_mapping(tsv, label_to=label_to)
        assert got == jconst.read_label_mapping(tsv, label_to=label_to) and got[2] == 4
    mapping = tconst.read_label_mapping(tsv, label_to="cocomapid")
    raw = np.random.default_rng(32).integers(-1, 14, size=(H, W))
    np.testing.assert_array_equal(
        tconst.map_label_image(raw, mapping, 20), jconst.map_label_image(raw, mapping, 20))
    lbl = np.array([[0, 1], [19, 5]])
    np.testing.assert_array_equal(tconst.render_palette(lbl, 19), jconst.render_palette(lbl, 19))
    assert (tconst.render_palette(lbl, 19)[1, 0] == 0).all()


# ---------------------------------------------------------------- prediction
def _planted(n=1200, seed=33):
    """Gaussians carrying text features of spatially coherent classes plus
    noise, the text matrix, and a camera pair."""
    arrays, alive = scene_arrays(n=n, seed=seed, dead=50)
    rng = np.random.default_rng(seed)
    text = teval.text_feature_matrix(RandomFeatureProvider(D), LABELS)
    np.testing.assert_array_equal(text, jeval.text_feature_matrix(JaxRandomProvider(D), LABELS))
    cls = np.digitize(arrays["means"][:, 0], [-1.0, -0.3, 0.3, 1.0])  # 5 slabs along x
    feats = (text[cls + 1] + 0.15 * rng.normal(size=(n, D))).astype(np.float32)
    args = (np.eye(3), np.zeros(3), 1.2, 1.0, W, H)
    return arrays, alive, feats, text, cls, (jax_camera(*args), torch_camera(*args))


@pytest.mark.parametrize("pred_on_3d", [True, False], ids=["onehot_render", "feature_render"])
def test_predict_label_image_matches_jax(pred_on_3d):
    """Label images agree on >= 99.9% of the pixels (an argmax can tie-break
    differently where two renders differ in the last bits)."""
    arrays, alive, feats, text, _, (jcam, tcam) = _planted()
    want = np_(jeval.predict_label_image(
        jcam, jax_params(arrays), jnp.asarray(alive), jnp.asarray(feats), jnp.asarray(text),
        pred_on_3d=pred_on_3d, backend="pallas"))
    got = teval.predict_label_image(
        tcam, torch_params(arrays), torch.from_numpy(alive), torch.from_numpy(feats),
        torch.from_numpy(text), pred_on_3d=pred_on_3d)
    assert got.dtype == torch.int32 and got.shape == (H, W)
    assert (np_(got) == want).mean() >= 0.999
    assert len(np.unique(want)) >= 4 and want.max() <= len(LABELS)


@pytest.mark.parametrize("pred_on_3d", [True, False], ids=["onehot_render", "feature_render"])
def test_eval_views_matches_jax(pred_on_3d, tmp_path):
    """Two views, ground truth rendered from the planted classes: the
    confusion sums differ by at most 0.1% of the pixels, mIoU by 0.005, and
    the planted classes are found (mIoU > 0.8)."""
    arrays, alive, feats, text, cls, _ = _planted()
    cams = [(jax_camera(np.eye(3), np.array([dx, 0, 0]), 1.2, 1.0, W, H),
             torch_camera(np.eye(3), np.array([dx, 0, 0]), 1.2, 1.0, W, H)) for dx in (0.0, 0.4)]
    tparams, talive = torch_params(arrays), torch.from_numpy(alive)
    eye = np.eye(len(LABELS) + 1, dtype=np.float32)
    gts = [np_(teval.predict_label_image(tc, tparams, talive, torch.from_numpy(eye[cls + 1]),
                                         torch.from_numpy(eye), pred_on_3d=True))
           for _, tc in cams]
    jm, ja, jconf = jeval.eval_views(
        [c for c, _ in cams], gts, jax_params(arrays), jnp.asarray(alive), jnp.asarray(feats),
        text, LABELS, pred_on_3d=pred_on_3d, backend="pallas", chunk_views=2)
    log = tmp_path / "eval.log"
    tm, ta, tconf = teval.eval_views(
        [c for _, c in cams], gts, tparams, talive, torch.from_numpy(feats), text, LABELS,
        pred_on_3d=pred_on_3d, log_file=str(log))
    assert tconf.shape == jconf.shape == (len(LABELS), len(LABELS) + 1)
    assert tconf.dtype == np.int64
    assert np.abs(tconf - jconf).sum() <= 2 * 0.001 * 2 * W * H
    assert abs(tm - jm) <= 0.005 and abs(ta - ja) <= 0.005 and tm > 0.8
    assert f"mean IoU: {tm:.4f}" in log.read_text()


def test_ensembles_match_jax():
    rng = np.random.default_rng(34)
    f2 = rng.normal(size=(200, D)).astype(np.float32)
    f3 = rng.normal(size=(200, D)).astype(np.float32)
    text = teval.text_feature_matrix(RandomFeatureProvider(D), LABELS)
    got = teval.ensemble_features(torch.from_numpy(f2), torch.from_numpy(f3))
    want = jeval.ensemble_features(jnp.asarray(f2), jnp.asarray(f3))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-6, atol=1e-7)
    assert got.shape == (200, 2 * D)
    with pytest.raises(ValueError, match="argmax"):
        teval.ensemble_features(torch.from_numpy(f2), torch.from_numpy(f3), mode="argmax")
    cls = teval.ensemble_argmax_class(
        torch.from_numpy(f2), torch.from_numpy(f3), torch.from_numpy(text))
    np.testing.assert_array_equal(
        np_(cls), np_(jeval.ensemble_argmax_class(jnp.asarray(f2), jnp.asarray(f3), jnp.asarray(text))))


@pytest.mark.parametrize("num_valid", [None, 30])
def test_voxel_feats_to_gaussians_matches_jax(num_valid):
    rng = np.random.default_rng(35)
    vf = rng.normal(size=(40 if num_valid is None else 30, 8)).astype(np.float32)
    inverse = rng.integers(0, 40, size=120)
    want = jeval.voxel_feats_to_gaussians(vf, inverse, 100, 128, num_valid=num_valid)
    got = teval.voxel_feats_to_gaussians(vf, inverse, 100, 128, num_valid=num_valid)
    np.testing.assert_array_equal(np_(got), np_(want))
    assert got.shape == (128, 8) and not np_(got)[100:].any()
    if num_valid is not None:
        assert not np_(got)[:100][inverse[:100] >= num_valid].any()


def test_accumulator_adds_views():
    rng = np.random.default_rng(36)
    acc, ref = teval.EvalAccumulator(4), jeval.EvalAccumulator(4)
    for _ in range(3):
        pred, gt = rng.integers(0, 5, size=(2, H, W))
        acc.add_view(pred, gt)
        ref.add_view(pred, gt)
    np.testing.assert_array_equal(acc.confusion, ref.confusion)
    assert acc.report(LABELS[:4], stdout=False) == ref.report(LABELS[:4], stdout=False)


# ---------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """An 11-view toy scene (evaluation takes every 10th view: two of them)
    with raw label images and a label TSV, a model PLY, fused features,
    and predicted label maps (one .pt, one .png)."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("torch_eval_cli")
    scene = tmp / "toy_scene"
    write_toy_blender_scene(scene, views=11, w=W, h=H)
    rng = np.random.default_rng(37)
    arrays, alive = scene_arrays(n=1200, seed=38, dead=50)
    jax_save_ply(tmp / "model" / "point_cloud" / "iteration_30" / "point_cloud.ply",
                 jax_params(arrays), alive)
    text = teval.text_feature_matrix(RandomFeatureProvider(D), tconst.COCOMAP_CLASS_LABELS)
    cls = np.digitize(arrays["means"][:, 0], np.linspace(-1.5, 1.5, 19))  # 20 slabs
    feats = (text[cls + 1] + 0.1 * rng.normal(size=(1200, D))).astype(np.float32)
    save_fused_features(tmp / "fusion" / "toy_scene" / "0.pt", feats, alive)
    # raw ids 1..21 map to train ids 0..20 (20 = unlabeled); raw 0 and 30 are unmapped
    rows = ["id\traw_category\tscannetid\tcocomapid"] + [f"{i + 1}\tc{i}\t{i}\t{i}" for i in range(20)]
    (scene / "scannetv2-labels.modified.tsv").write_text("\n".join(rows) + "\n")
    (scene / "label-filt").mkdir()
    (tmp / "labelmaps").mkdir()
    for i in (0, 10):
        raw = np.repeat(np.repeat(rng.integers(0, 22, size=(H // 8, W // 8)), 8, 0), 8, 1)
        raw[:4, :4] = 30
        Image.fromarray(raw.astype(np.uint8)).save(scene / "label-filt" / f"r_{i}.png")
        lm = np.where(rng.uniform(size=(H, W)) < 0.8, np.clip(raw - 1, 0, 20), 3).astype(np.uint8)
        if i == 0:
            torch.save(torch.from_numpy(lm.astype(np.int64)), tmp / "labelmaps" / f"r_{i}.pt")
        else:
            Image.fromarray(lm).save(tmp / "labelmaps" / f"r_{i}.png")
    return tmp


def _overrides(toy, mode, extra=()):
    return [f"scene.scene_path={toy / 'toy_scene'}", f"model.model_dir={toy / 'model'}",
            f"fusion.out_dir={toy / 'fusion'}", f"fusion.embedding_dim={D}",
            f"eval.eval_mode={mode}", f"eval.width={W}", f"eval.height={H}", *extra]


@pytest.mark.parametrize("mode,extra,tol", [
    ("2d", ("eval.pred_on_3d=true",), 0.005),
    ("2d", ("eval.pred_on_3d=false",), 0.005),
    ("pretrained", (), 1e-4),
    ("labelmap", (), 1e-4),
], ids=["2d_onehot", "2d_features", "pretrained", "labelmap"])
def test_eval_cli_matches_root_cli(toy, mode, extra, tol, capsys, monkeypatch, tmp_path):
    """`python -m semantic_gaussians_torch.cli.eval_segmentation --device cpu`
    against the root eval_segmentation.py: mIoU and mAcc equal to the four
    decimals the root CLI prints in the host-only modes, within 0.005 where
    both render (argmax ties)."""
    import eval_segmentation as root_eval

    if mode == "labelmap":
        extra = (*extra, f"eval.labelmap_dir={toy / 'labelmaps'}")
    monkeypatch.chdir(tmp_path)  # the root CLI appends to ./eval_result.log
    yaml = REPO / "semantic_gaussians_tpu/config/yamls/eval.yaml"
    with mock.patch.object(sys, "argv", ["eval_segmentation.py", str(yaml),
                                         *_overrides(toy, mode, extra), "pipeline.backend=pallas"]):
        root_eval.main()
    last = capsys.readouterr().out.strip().splitlines()[-1].split()
    want_miou, want_macc = float(last[1]), float(last[3])
    log = tmp_path / "port.log"
    miou, macc, conf = eval_cli.main([
        str(default_config_dir() / "eval.yaml"), "--device", "cpu",
        *_overrides(toy, mode, extra), f"eval.log_file={log}"])
    assert conf.shape == (20, 21) and conf.sum() > 0.8 * 2 * W * H
    assert abs(miou - want_miou) <= tol and abs(macc - want_macc) <= tol
    assert 0 < miou <= 1
    port_lines = log.read_text().splitlines()
    root_lines = (tmp_path / "eval_result.log").read_text().splitlines()
    assert port_lines[0] == root_lines[0] and len(port_lines) == len(root_lines) == 22
    if tol < 1e-3:
        assert port_lines == root_lines


@pytest.fixture(scope="module")
def distilled(toy):
    """A MinkUNet14A (56 -> D) checkpoint of random weights in the JAX
    package's format, written by the port, with BN statistics and a head
    bias away from their init so that every layer shapes the output."""
    from semantic_gaussians_torch.models.unet3d import mink_unet
    from semantic_gaussians_torch.pipelines.distill import save_distill_checkpoint

    model = mink_unet(56, D, "MinkUNet14A", seed=5)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("mean", "bias")):
                t.add_(0.1 * torch.randn(t.shape, generator=g))
            elif name.endswith("var"):
                t.mul_(torch.rand(t.shape, generator=g) + 0.5)
    save_distill_checkpoint(toy / "distill" / "model_100.npz", model)
    return toy / "distill"


def _distill_overrides(distilled, budget=1024):
    return [f"distill.model_dir={distilled}", "distill.model_3d=MinkUNet14A", "distill.iteration=100",
            "distill.voxel_size=0.05", f"distill.voxel_budget={budget}"]


@pytest.mark.parametrize("mode,extra", [
    ("3d", ()),
    ("2d_and_3d", ("eval.feature_fusion=concat",)),
    ("2d_and_3d", ("eval.feature_fusion=argmax",)),
], ids=["3d", "2d_and_3d_concat", "2d_and_3d_argmax"])
def test_eval_cli_distill_modes_match_root_cli(toy, distilled, mode, extra, monkeypatch, tmp_path):
    """The distilled modes through both CLIs on one checkpoint (1024 voxels
    for ~1150 Gaussians in 5 cm voxels: the budget drops some, whose
    Gaussians get zero features): the per-Gaussian features handed to
    evaluation agree within 1e-4 x their largest magnitude (the argmax
    ensemble's classes exactly), and the confusion matrices are equal."""
    import eval_segmentation as root_eval

    seen = {}

    def recording(key, fn):
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            seen[key] = (np_(args[4]), out[2])
            return out
        return wrapper

    monkeypatch.setattr(jeval, "eval_views", recording("jax", jeval.eval_views))
    monkeypatch.setattr(eval_cli, "eval_views", recording("port", eval_cli.eval_views))
    monkeypatch.chdir(tmp_path)
    overrides = _overrides(toy, mode, (*extra, *_distill_overrides(distilled)))
    yaml = REPO / "semantic_gaussians_tpu/config/yamls/eval.yaml"
    with mock.patch.object(sys, "argv", ["eval_segmentation.py", str(yaml), *overrides,
                                         "pipeline.backend=pallas"]):
        root_eval.main()
    miou, macc, conf = eval_cli.main([str(default_config_dir() / "eval.yaml"), "--device", "cpu",
                                      *overrides, f"eval.log_file={tmp_path / 'port.log'}"])
    (jfeats, jconf), (tfeats, tconf) = seen["jax"], seen["port"]
    width = 2 * D if extra == ("eval.feature_fusion=concat",) else D
    assert tfeats.shape == jfeats.shape and tfeats.shape[1] == width
    assert np.abs(tfeats - jfeats).max() <= 1e-4 * np.abs(jfeats).max()
    if mode == "3d":  # the budget dropped some Gaussians' voxels
        assert (np.abs(jfeats[:1150]).sum(-1) == 0).any()
    np.testing.assert_array_equal(tconf, jconf)
    assert conf.shape == (20, 21) and conf.sum() > 0.8 * 2 * W * H and 0 < miou <= 1


@pytest.mark.parametrize("mode", ["3d", "2d_and_3d"])
def test_eval_cli_distill_modes_raise(toy, mode, tmp_path):
    """The distilled modes raise without a checkpoint; an unknown mode
    raises."""
    with pytest.raises(FileNotFoundError, match="model_100.npz"):
        eval_cli.main([str(default_config_dir() / "eval.yaml"), "--device", "cpu",
                       *_overrides(toy, mode, _distill_overrides(tmp_path))])
    with pytest.raises(ValueError, match="unknown eval_mode"):
        eval_cli.main([str(default_config_dir() / "eval.yaml"), "--device", "cpu",
                       *_overrides(toy, "4d")])


def test_eval_cli_without_labels_returns_none(toy, tmp_path):
    out = eval_cli.main([str(default_config_dir() / "eval.yaml"), "--device", "cpu",
                         *_overrides(toy, "2d"), f"eval.label_dir={tmp_path}"])
    assert out is None

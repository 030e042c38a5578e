"""The eval ring of the port's GPU smoke test, at a cut size, through both
packages' eval_views. Its 9 evaluated views take the 8 training ring poses
in turn and then the first again (bench.py's cloud 4 units down +z, a ring
of radius 6 around it); 20 classes in cones from the first ring camera,
each carrying its label's random text feature; a fused model whose
visited Gaussians hold their class's feature plus noise. Mode 2d with
pred_on_3d true (C = K + 1) and false (C = D), a chunk of 8 and a view
alone as the CLI runs them, on the same inputs: the confusion matrices must be equal. (On the
card this ring read mIoU 0.870 and 0.897 where the single view read over
0.9; this settles that the ring's lower mIoU is the scene's, not the
port's.)"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_gaussians_tpu.pipelines import eval_segmentation as jeval
from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
from semantic_gaussians_torch.data.scannet_constants import COCOMAP_CLASS_LABELS as LABELS
from semantic_gaussians_torch.models.predictors import RandomFeatureProvider
from semantic_gaussians_torch.pipelines import eval_segmentation as teval
from semantic_gaussians_torch.utils.camera import make_camera as torch_camera
from torch_port_common import jax_params, np_, torch_params

N, D = 3000, 32
W, H = 96, 72  # the smoke test's 648x484, cut
RADIUS, VIEWS, EVAL_VIEWS = 6.0, 8, 90
OPACITY_BOOST = 4.0


def _bench_law(n, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * np.array([1.6, 1.1, 1.0]) + np.array([0, 0, 4])).astype(
        np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    return dict(
        means=pts, sh_dc=((cols - 0.5) / 0.28209479177387814)[:, None, :].astype(np.float32),
        sh_rest=np.zeros((n, 15, 3), np.float32),
        # splats e times the law's: the cut cloud is 33x sparser than 100k
        log_scales=rng.uniform(-4.5, -3.0, size=(n, 3)).astype(np.float32) + np.float32(1.0),
        quats=quats,
        opacity_logits=rng.uniform(-1.0, 1.5, size=(n, 1)).astype(np.float32)
        + np.float32(OPACITY_BOOST))


def _ring_poses(centre, radius, views):
    poses = []
    for i in range(views):
        ang = 2 * np.pi * i / views
        pos = centre + radius * np.array([np.sin(ang), 0.15 * (-1) ** i, -np.cos(ang)])
        fwd = (centre - pos) / np.linalg.norm(centre - pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, -down, -fwd], axis=1)
        c2w[:3, 3] = pos
        poses.append(c2w)
    return poses


def _class_cones(means):
    def bins(x, k):
        return np.digitize(x, np.quantile(x, np.linspace(0, 1, k + 1)[1:-1]))

    z = means[:, 2] + 2.0
    return bins(means[:, 0] / z, 5) * 4 + bins((means[:, 1] - 0.15 * RADIUS) / z, 4)


@pytest.fixture(scope="module")
def ring():
    arrays = _bench_law(N)
    cls = _class_cones(arrays["means"])
    text = teval.text_feature_matrix(RandomFeatureProvider(D), LABELS)  # row 0 'other'
    rng = np.random.default_rng(7)
    visited = rng.uniform(size=N) < 0.8
    fused = np.where(visited[:, None], text[cls + 1] + 0.35 * rng.normal(size=(N, D)), 0.0)
    fused = fused.astype(np.float32)
    fov_x = 2 * math.atan(math.tan(0.55) * 640 / 480)
    fov_y = 2 * math.atan(math.tan(fov_x / 2) * H / W)
    poses = _ring_poses(np.array([0.0, 0.0, 4.0]), RADIUS, VIEWS)
    jcams, tcams = [], []
    for i in range(0, EVAL_VIEWS, 10):  # the CLI evaluates every 10th frame
        flip = poses[(i // 10) % VIEWS].copy()
        flip[:3, 1:3] *= -1
        w2c = np.linalg.inv(flip)
        args = (w2c[:3, :3].T, w2c[:3, 3], fov_x, fov_y, W, H)
        jcams.append(jax_camera(*args))
        tcams.append(torch_camera(*args))
    tparams, alive = torch_params(arrays), torch.ones(N, dtype=torch.bool)
    eye = torch.eye(len(LABELS) + 1)
    onehot = eye[torch.from_numpy(cls) + 1]
    gts = [np_(teval.predict_label_image(c, tparams, alive, onehot, eye, pred_on_3d=True))
           .astype(np.int64) for c in tcams]
    return dict(arrays=arrays, fused=fused, text=text, jcams=jcams, tcams=tcams, gts=gts,
                tparams=tparams, alive=alive)


@pytest.mark.parametrize("pred_on_3d", [True, False], ids=["onehot_C=K+1", "features_C=D"])
def test_ring_eval_confusions_match_jax(ring, pred_on_3d, chunk=8):
    r = ring
    assert len(r["tcams"]) == 9
    tm, _, tconf = teval.eval_views(
        r["tcams"], r["gts"], r["tparams"], r["alive"], torch.from_numpy(r["fused"]),
        r["text"], LABELS, pred_on_3d=pred_on_3d, chunk_views=chunk)
    jm, _, jconf = jeval.eval_views(
        r["jcams"], r["gts"], jax_params(r["arrays"]), jnp.ones(N, bool),
        jnp.asarray(r["fused"]), r["text"], LABELS, pred_on_3d=pred_on_3d, backend="pallas",
        chunk_views=chunk)
    np.testing.assert_array_equal(np.asarray(tconf), np.asarray(jconf))
    assert tm == jm
    labelled = sum(int((g < len(LABELS)).sum()) for g in r["gts"])
    assert int(np.asarray(tconf).sum()) == labelled > 0

"""Port parity: the harnesses' scenes, cameras and ground truth.
tools.parity_harness.build_true_scene (density 1 and 3, with and without
classes) and ring_camera are bit-identical to the root tools'; the
semantic harness's build_gt_maps gives the JAX tool's label images at
96x64 on the same Gaussians (the JAX side through the Pallas kernels in
interpret mode)."""
import numpy as np
import pytest
import torch

import tools.parity_harness as jax_ph
import tools.semantic_harness as jax_sh
from semantic_gaussians_torch.tools import parity_harness as ph
from semantic_gaussians_torch.tools import semantic_harness as sh
from torch_port_common import np_


@pytest.mark.parametrize("density", [1, 3])
@pytest.mark.parametrize("classes", [False, True])
def test_build_true_scene_is_bit_identical(density, classes):
    got = ph.build_true_scene(np.random.default_rng(11), density, classes)
    want = jax_ph.build_true_scene(np.random.default_rng(11), density, classes)
    assert len(got) == len(want) == (3 if classes else 2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    n = {1: 23_604, 3: 206_036}[density]
    assert got[0].shape == (n, 3)
    if classes:
        assert np.bincount(got[2]).tolist()[-1] == 800  # the dust


def test_rng_stream_after_the_scene_is_the_same():
    """The harnesses draw the init and noise from the same generator after
    the scene: its state must match too."""
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    ph.build_true_scene(a, 1)
    jax_ph.build_true_scene(b, 1)
    np.testing.assert_array_equal(a.integers(0, 1 << 30, 8), b.integers(0, 1 << 30, 8))


def _ring(mod, make, w=480, h=352):
    n_train, n_test = 40, 8
    cams = [mod.ring_camera(i + 0.5 / n_train, n_train, w, h, make=make) for i in range(n_train)]
    cams += [mod.ring_camera((i + 0.25) * n_train / n_test + 0.5 / n_train, n_train, w, h,
                             make=make) for i in range(n_test)]
    return cams


def test_ring_camera_is_bit_identical():
    from semantic_gaussians_tpu.utils.camera import make_camera_from_c2w as jax_make
    from semantic_gaussians_torch.utils.camera import make_camera_from_c2w as torch_make

    def raw(*a):
        return a

    for got, want in zip(_ring(ph, raw), _ring(jax_ph, raw)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    for tc, jc in zip(_ring(ph, torch_make), _ring(jax_ph, jax_make)):
        for f in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(np_(getattr(tc, f)), np.asarray(getattr(jc, f)))
        assert (tc.width, tc.height, tc.fov_x, tc.fov_y) == (jc.width, jc.height, jc.fov_x,
                                                              jc.fov_y)
    assert (ph.N_TRAIN, ph.N_TEST) == (40, 8)


def test_build_gt_maps_matches_jax(tmp_path):
    """Density 1 without the dust (as the semantic harness takes it), four
    views of its ring at 96x64: the label images equal."""
    from semantic_gaussians_tpu.core.gaussians import init_from_pcd as jax_init
    from semantic_gaussians_tpu.utils.camera import make_camera_from_c2w as jax_make
    from semantic_gaussians_torch.core.gaussians import params_from_numpy
    from semantic_gaussians_torch.utils.camera import make_camera_from_c2w as torch_make

    pts, cols, cls = jax_ph.build_true_scene(np.random.default_rng(11), 1, return_classes=True)
    keep = cls < len(sh.LABELS)
    jparams, jalive = jax_init(pts[keep], cols[keep], sh_degree=3, init_opacity=0.95)
    cap = jparams.capacity
    cls_full = np.full(cap, sh.UNLABELED, np.int32)
    cls_full[: keep.sum()] = cls[keep]
    tparams = params_from_numpy({f: np.asarray(getattr(jparams, f)) for f in (
        "means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")}, "cpu")
    talive = torch.from_numpy(np.array(jalive))
    views = [(i + 0.5 / 30, 30) for i in (0, 7)] + [((i + 0.25) * 30 / 8 + 0.5 / 30, 30)
                                                    for i in (1, 5)]
    jcams = [jax_ph.ring_camera(i, n, 96, 64, make=jax_make) for i, n in views]
    tcams = [ph.ring_camera(i, n, 96, 64, make=torch_make) for i, n in views]
    want = jax_sh.build_gt_maps(jcams, jparams, jalive, cls_full, tmp_path / "jax.npz")
    got = sh.build_gt_maps(tcams, tparams, talive, cls_full, tmp_path / "port.npz")
    assert sh.LABELS == jax_sh.LABELS and sh.UNLABELED == jax_sh.UNLABELED
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == (64, 96)
        np.testing.assert_array_equal(g, w)
    ids = np.concatenate([g.ravel() for g in got])
    assert set(np.unique(ids)) == {0, 1, 2, 3}  # every class and the background
    # the cache reads back as written
    again = sh.build_gt_maps(tcams, None, None, cls_full, tmp_path / "port.npz")
    for a, g in zip(again, got):
        np.testing.assert_array_equal(a, g)

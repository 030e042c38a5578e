"""The port's automatic mask generator (semantic_gaussians_torch.models.
automask) against the JAX package's. Two parts: the float part (the
decoder's logits and their resample to the image) within a tolerance, and
the discrete part (filters, thresholds, boxes, NMS, region removal,
annotations) exactly when both packages are given the same logits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per worker)
from semantic_gaussians_tpu.models import automask as jam
from semantic_gaussians_tpu.models import sam as jsam
from semantic_gaussians_torch.models import automask as tam
from semantic_gaussians_torch.models import sam as tsam
from semantic_gaussians_torch.models.common import random_init_

CFG_J, CFG_T = jsam.SamConfig.tiny(), tsam.SamConfig.tiny()


def port_sam(seed=0):
    return random_init_(tsam.Sam(CFG_T), seed=seed, std=0.2, scales=tsam.init_scales()).eval()


@pytest.mark.parametrize("n", [1, 4, 32])
def test_point_grid_matches_jax(n):
    g = tam.build_point_grid(n)
    np.testing.assert_array_equal(g, jam.build_point_grid(n))
    if n == 4:
        assert g.shape == (16, 2)
        assert abs(g[0, 0] - 1 / 8) < 1e-6 and abs(g[-1, 1] - 7 / 8) < 1e-6


def test_masks_to_boxes_matches_jax(rng):
    m = np.zeros((3, 10, 12), bool)
    m[0, 2:5, 3:9] = True
    m[1, 0:1, 0:1] = True
    boxes = tam.masks_to_boxes(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(boxes, [[3, 2, 9, 5], [0, 0, 1, 1], [0, 0, 0, 0]])
    r = rng.uniform(size=(4, 3, 20, 30)) > 0.97
    r[0, 1] = False
    got = tam.masks_to_boxes(torch.from_numpy(r))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jam.masks_to_boxes(jnp.asarray(r))))


@pytest.mark.parametrize("scores", ["continuous", "ties"])
def test_greedy_nms_matches_jax(rng, scores):
    """Keeps and their order exactly, with continuous scores and with the
    second NMS's 0 / 1 scores (many ties)."""
    boxes = rng.uniform(0, 50, (60, 2)).astype(np.float32)
    boxes = np.concatenate([boxes, boxes + rng.uniform(5, 25, (60, 2))], 1).astype(np.float32)
    s = (rng.uniform(size=60).astype(np.float32) if scores == "continuous"
         else (rng.uniform(size=60) > 0.4).astype(np.float64))
    for thresh in (0.3, 0.5, 0.7):
        keep = tam.greedy_nms(boxes, s, thresh)
        np.testing.assert_array_equal(keep, jam.greedy_nms(boxes, s, thresh))
    assert keep.dtype == np.int64


def test_greedy_nms_bruteforce(rng):
    boxes = rng.uniform(0, 50, (30, 2)).astype(np.float32)
    boxes = np.concatenate([boxes, boxes + rng.uniform(5, 25, (30, 2))], 1)
    scores = rng.uniform(size=30).astype(np.float32)
    keep = set(tam.greedy_nms(boxes, scores, 0.5).tolist())

    def iou(a, b):
        x1, y1 = np.maximum(a[:2], b[:2])
        x2, y2 = np.minimum(a[2:], b[2:])
        inter = max(x2 - x1, 0) * max(y2 - y1, 0)
        area = lambda z: (z[2] - z[0]) * (z[3] - z[1])  # noqa: E731
        return inter / (area(a) + area(b) - inter)

    for i in keep:
        for j in keep:
            if i < j:
                assert iou(boxes[i], boxes[j]) <= 0.5 + 1e-6
    for i in set(range(30)) - keep:
        assert any(iou(boxes[i], boxes[j]) > 0.5 and scores[j] >= scores[i] for j in keep)


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_matches_jax(rng, mode):
    for seed in range(6):
        r = np.random.default_rng(seed)
        m = r.uniform(size=(40, 50)) > (0.3 if mode == "holes" else 0.9)
        for thresh in (2, 5, 40):
            got, ch = tam.remove_small_regions(m, thresh, mode)
            want, jch = jam.remove_small_regions(m, thresh, mode)
            assert ch == jch
            np.testing.assert_array_equal(got, want)
    # an image of islands all below the threshold keeps its largest
    m = np.zeros((20, 20), bool)
    m[1:3, 1:3] = m[10:13, 10:13] = True
    got, ch = tam.remove_small_regions(m, 50, "islands")
    assert ch and got.sum() == 9 and got[11, 11]
    np.testing.assert_array_equal(got, jam.remove_small_regions(m, 50, "islands")[0])


def test_remove_small_regions_oracle():
    m = np.zeros((20, 20), bool)
    m[2:12, 2:12] = True
    m[5, 5] = False  # 1-px hole
    m[16, 16] = True  # 1-px island
    out, ch = tam.remove_small_regions(m, 4, "holes")
    assert ch and out[5, 5]
    out2, ch2 = tam.remove_small_regions(out, 4, "islands")
    assert ch2 and not out2[16, 16] and out2[3, 3]


@pytest.mark.parametrize("hw", [(484, 648), (648, 484), (968, 1296)])
def test_resample_matches_jax_scale_and_translate(rng, hw):
    """Low-res N(0, 1) logits of a 256^2 map -> the image in one resample:
    within 2e-4 of the logits' largest magnitude; the thresholded masks may
    still differ at a few pixels (counted, not gated: the discrete stage is
    held exactly on shared logits below)."""
    h, w = hw
    rh, rw = (round(h * 1024 / max(h, w)), round(w * 1024 / max(h, w)))
    low = rng.normal(size=(2, 3, 256, 256)).astype(np.float32)
    want = np.asarray(jax.image.scale_and_translate(
        jnp.asarray(low), (2, 3, h, w), (2, 3), jnp.array([4.0 * h / rh, 4.0 * w / rw]),
        jnp.zeros(2), method="linear", antialias=False))
    got = tam.resample_logits(torch.from_numpy(low), (h, w), (rh, rw)).numpy()
    assert got.shape == (2, 3, h, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())
    flips = int(((got > 0) != (want > 0)).sum())
    assert flips <= 1e-4 * got.size, flips


AMGS = {
    "keep_all": dict(points_per_side=3, points_per_batch=4, pred_iou_thresh=-1e9,
                     stability_score_thresh=-1.0, min_mask_region_area=0),
    "regions": dict(points_per_side=4, points_per_batch=5, pred_iou_thresh=-1e9,
                    stability_score_thresh=-1.0, min_mask_region_area=12, box_nms_thresh=0.8),
    # the random tiny model's logits are ~1e-2 and its IoU ~0 +- 0.5: cuts
    # through both distributions
    "filters": dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=-0.27,
                    stability_score_thresh=0.2, stability_score_offset=0.005,
                    min_mask_region_area=6),
}


def _generate_both(monkeypatch, amg_kw, seed, image):
    """The port's generate, then the JAX package's on the port's decoder
    outputs: its model returns the port's low-res logits and IoU batch by
    batch, and its resample the port's resampled logits."""
    model = port_sam(seed)
    low, up = [], []
    predict_points = model.predict_points

    def recording_predict(*a):
        out = predict_points(*a)
        low.append(tuple(t.numpy() for t in out))
        return out

    resample = tam.resample_logits

    def recording_resample(*a):
        out = resample(*a)
        up.append(out.numpy())
        return out

    monkeypatch.setattr(model, "predict_points", recording_predict)
    monkeypatch.setattr(tam, "resample_logits", recording_resample)
    got = tam.SamAutoMask(model, tam.AutoMaskConfig(**amg_kw)).generate(image)

    class SharedDecoder:
        def apply(self, variables, *args, method=None):
            if method is jsam.Sam.predict_points:
                return tuple(jnp.asarray(a) for a in low.pop(0))
            return jnp.zeros((1, CFG_J.grid, CFG_J.grid, CFG_J.decoder_dim))

    jgen = jam.SamAutoMask(CFG_J, jsam.params_from_sam_state_dict(model.state_dict(), CFG_J),
                           jam.AutoMaskConfig(**amg_kw))
    jgen.model = SharedDecoder()
    ups = iter(up)
    monkeypatch.setattr(jax.image, "scale_and_translate", lambda *a, **k: jnp.asarray(next(ups)))
    with jax.disable_jit():
        want = jgen.generate(image)
    assert not low and next(ups, None) is None  # every batch consumed once
    return got, want


def assert_same_annotations(got, want):
    assert [len(a) for a in got] == [len(a) for a in want]
    for ga, wa in zip(got, want):
        for g, w in zip(ga, wa):
            assert g.keys() == w.keys()
            np.testing.assert_array_equal(g["segmentation"], w["segmentation"])
            assert g["segmentation"].dtype == np.bool_
            for k in ("bbox", "area", "predicted_iou", "stability_score"):
                assert g[k] == w[k], k


@pytest.mark.parametrize("amg", list(AMGS))
def test_annotations_exact_on_shared_logits(monkeypatch, rng, amg):
    img = (rng.uniform(size=(48, 56, 3)) * 255).astype(np.uint8)
    got, want = _generate_both(monkeypatch, AMGS[amg], seed=3, image=img)
    assert_same_annotations(got, want)
    assert len(got[0]) >= 1


def test_decoder_logits_match_jax(rng):
    """The float part on the JAX package's own decoder: the image
    embedding, each batch's logits at image size (within 2e-4 of their
    largest magnitude) and IoU."""
    model = port_sam(4)
    var = jsam.params_from_sam_state_dict(model.state_dict(), CFG_J)
    amg = tam.AutoMaskConfig(**AMGS["keep_all"])
    img = (rng.uniform(size=(40, 52, 3)) * 255).astype(np.uint8)
    gen = tam.SamAutoMask(model, amg)
    jgen = jam.SamAutoMask(CFG_J, var, jam.AutoMaskConfig(**AMGS["keep_all"]))
    emb, rhw = gen.embed(img)
    x, jrhw = jsam.preprocess_image(img, CFG_J.img_size)
    jemb = jgen._encode(var, jnp.asarray(x)[None])[0]
    assert rhw == jrhw
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=2e-4, atol=2e-5)
    pts = gen.prompts((40, 52))
    with torch.inference_mode():
        logits, iou = gen.decode_batch(emb, pts[:4], (40, 52), rhw)
    labels = jnp.ones((4, 1), jnp.int32)
    jlow, jiou = jsam.Sam(CFG_J).apply(var, jemb, jnp.asarray(pts[:4].numpy())[:, None], labels,
                                       method=jsam.Sam.predict_points)
    jup = jax.image.scale_and_translate(
        jlow[:, 1:], (4, 3, 40, 52), (2, 3),
        jnp.array([4.0 * 40 / rhw[0], 4.0 * 52 / rhw[1]]), jnp.zeros(2),
        method="linear", antialias=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jup), rtol=0,
                               atol=2e-4 * float(jnp.abs(jup).max()))
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou[:, 1:]), rtol=2e-4, atol=2e-5)


def test_tiny_automask_generates_wellformed(rng):
    gen = tam.SamAutoMask(port_sam(2), tam.AutoMaskConfig(**AMGS["keep_all"]))
    img = (rng.uniform(size=(48, 56, 3)) * 255).astype(np.uint8)
    anns, s, m, l = gen.generate(img)
    assert len(anns) >= 1
    c = gen.counts  # every stage keeps at most what the one before it kept
    assert c["points"] == 9 and c["iou"] == c["stability"] == [9, 9, 9]
    for name, n_in in (("s", 9), ("m", 9), ("l", 9), ("merged", 27)):
        assert n_in >= c[name]["nms"] >= c[name]["regions_nms"] >= c[name]["annotations"]
    assert c["merged"]["annotations"] == len(anns) and c["s"]["annotations"] == len(s)
    for a in anns:
        seg = a["segmentation"]
        assert seg.shape == (48, 56) and seg.dtype == bool
        assert a["area"] == int(seg.sum())
        x0, y0, bw, bh = a["bbox"]
        ys, xs = np.nonzero(seg)
        assert x0 == xs.min() and y0 == ys.min()
        assert x0 + bw == xs.max() + 1 and y0 + bh == ys.max() + 1

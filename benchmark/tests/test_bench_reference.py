"""The reference rasterizer held against a dense brute force, and the
other plain references against what they stand for."""
import math
import struct
import zlib

import numpy as np
import pytest
import torch

from benchmark.reference import render as R
from benchmark.reference import view as RV

FIELDS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")


def _scene(n=300, seed=0):
    rng = np.random.default_rng(seed)
    a = dict(means=rng.normal(size=(n, 3)) * [0.8, 0.6, 0.4] + [0, 0, 3.0],
             sh_dc=rng.normal(size=(n, 1, 3)) * 0.5, sh_rest=rng.normal(size=(n, 15, 3)) * 0.05,
             log_scales=rng.uniform(-3.0, -1.8, size=(n, 3)), quats=rng.normal(size=(n, 4)),
             opacity_logits=rng.uniform(-2, 3, size=(n, 1)))
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in a.items()}


def _brute(p, cam, bins_tiles=R.TILE):
    """Every pixel against every Gaussian in depth order, one at a time,
    within each Gaussian's rect of tiles (float64)."""
    proj = R.project(p, cam, 3)
    h, w = cam["height"], cam["width"]
    th, tw = bins_tiles
    order = torch.argsort(proj["depth"], stable=True)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64), indexing="ij")
    T = torch.ones(h, w, dtype=torch.float64)
    C = torch.zeros(h, w, 3, dtype=torch.float64)
    done = torch.zeros(h, w, dtype=torch.bool)
    for g in order.tolist():
        rx, ry = proj["rect"][g].tolist()
        if rx <= 0 or ry <= 0:
            continue
        mx, my = proj["means2d"][g]
        x0 = min(max(math.floor((float(mx) - rx) / tw), 0), -(-w // tw))
        x1 = min(max(math.floor((float(mx) + rx + tw - 1) / tw), 0), -(-w // tw))
        y0 = min(max(math.floor((float(my) - ry) / th), 0), -(-h // th))
        y1 = min(max(math.floor((float(my) + ry + th - 1) / th), 0), -(-h // th))
        inr = ((xs // tw >= x0) & (xs // tw < x1) & (ys // th >= y0) & (ys // th < y1))
        a, b, c = proj["conic"][g]
        dx, dy = mx - xs, my - ys
        pw = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        al = torch.clamp(proj["opac"][g] * torch.exp(torch.clamp(pw, max=0)), max=R.MAX_ALPHA)
        cand = (pw <= 0) & (al >= R.ALPHA_CUTOFF) & inr & ~done
        test = T * (1 - al)
        stop = cand & (test < R.T_EPS)
        con = cand & ~stop
        C = C + torch.where(con, al * T, 0)[..., None] * proj["colors"][g]
        T = torch.where(con, test, T)
        done = done | stop
    return C


def test_reference_render_matches_brute_force_and_its_gradient():
    p = _scene()
    cam = R.camera(np.eye(4), 1.0, 0.8, 64, 48, "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    img = R.render(leaves, cam, 3, torch.zeros(3, dtype=torch.float64))["image"]
    leaves_b = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    ref = _brute(leaves_b, cam)
    assert torch.allclose(img, ref, atol=1e-10)
    w = torch.rand(img.shape, dtype=torch.float64)
    g = torch.autograd.grad((img * w).sum(), [leaves[f] for f in FIELDS])
    gb = torch.autograd.grad((ref * w).sum(), [leaves_b[f] for f in FIELDS])
    for a, b in zip(g, gb):
        assert torch.allclose(a, b, rtol=1e-8, atol=1e-12)


def test_reference_blocks_do_not_change_the_render(monkeypatch):
    p = _scene(seed=1)
    cam = R.camera(np.eye(4), 1.0, 0.8, 96, 64, "cpu")
    full = R.render(p, cam, 3, torch.zeros(3, dtype=torch.float64))["image"]
    monkeypatch.setattr(R, "BLOCK_ELEMS", 512)  # one tile a block
    small = R.render(p, cam, 3, torch.zeros(3, dtype=torch.float64))["image"]
    assert torch.equal(full, small)


def test_event_counts_add_up():
    p = {k: v.float() for k, v in _scene(seed=2).items()}
    cam = R.camera(np.eye(4), 1.0, 0.8, 64, 48, "cpu")
    c = R.event_counts(p, cam, 3)
    assert c["live"] <= c["pairs"] and c["dense"] <= 300
    assert c["contributing"] <= c["up_to_last"] <= c["evaluated"] <= c["pairs"] * 512


def _png(img, filt):
    h, w, _ = img.shape
    rows, prev = [], np.zeros(w * 3, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        if filt == 0:
            enc = cur
        elif filt == 2:
            enc = cur - prev
        else:
            enc = np.zeros_like(cur)
            for x in range(w * 3):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                c = prev[x - 3] if x >= 3 else 0
                if filt == 1:
                    pr = a
                elif filt == 3:
                    pr = (a + b) // 2
                else:
                    q = a + b - c
                    pr = a if abs(q - a) <= abs(q - b) and abs(q - a) <= abs(q - c) else (
                        b if abs(q - b) <= abs(q - c) else c)
                enc[x] = cur[x] - pr
        rows.append(bytes([filt]) + (enc & 255).astype(np.uint8).tobytes())
        prev = cur

    def chunk(k, d):
        return struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_decode_every_filter(filt):
    img = np.random.default_rng(filt).integers(0, 256, size=(5, 7, 3)).astype(np.uint8)
    assert np.array_equal(RV.decode_png(_png(img, filt)), img)


def test_png_decode_reads_the_servers_encoder():
    from semantic_gaussians_torch.cli.view_server import encode_png

    img = np.random.default_rng(9).integers(0, 256, size=(16, 24, 3)).astype(np.uint8)
    assert np.array_equal(RV.decode_png(encode_png(img)), img)


def test_text_features_match_the_viewers_encoder():
    from semantic_gaussians_torch.models.predictors import RandomFeatureProvider

    labels = ["other", "wall", "shower curtain"]
    ours = RV.text_features(labels, 768)
    theirs = RandomFeatureProvider(768).extract_text_feature(labels)
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("name", ["scannet.train", "garden.train"])
def test_scene_laws_repeat_from_the_seed(name):
    from benchmark.scenes.common import target_images
    from benchmark.tests.tiny import tiny_cell
    import importlib

    cfg = tiny_cell(name).config
    law = importlib.import_module(f"benchmark.scenes.{cfg['law']}")
    a, b = law.scene(cfg, 2**31 + 5, "cpu"), law.scene(cfg, 2**31 + 5, "cpu")
    c = law.scene(cfg, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["means"], c["means"])
    assert torch.equal(target_images(4, 8, 8, 3, "cpu"), target_images(4, 8, 8, 3, "cpu"))
    assert torch.equal(target_images(4, 8, 8, 3, "cpu", which=[2])[0],
                       target_images(4, 8, 8, 3, "cpu")[2])

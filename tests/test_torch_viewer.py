"""Port parity: the viewer service. The port's ViewerState on the CPU vs
the JAX ViewerState (view_server.py, render.backend: pallas) on one small
scene with 16-dim fused features: all four modes (uint8 images within 1,
Semantic class maps equal), edit and reset, one HTTP round trip through
the port's server with the PNG decoded by zlib, the interactive page at
GET /, and the replay of a dynamic scene by timestep and by wall clock."""
import json
import pathlib
import struct
import sys
import threading
import urllib.request
import zlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from semantic_gaussians_tpu.config.config import load_config as jax_load_config  # noqa: E402
from semantic_gaussians_tpu.io.ply import save_gaussian_ply  # noqa: E402
from semantic_gaussians_tpu.pipelines.fusion import save_fused_features  # noqa: E402
from semantic_gaussians_torch.cli import view_server as torch_vs  # noqa: E402
from semantic_gaussians_torch.config.config import load_config  # noqa: E402
from torch_port_common import jax_params, scene_arrays  # noqa: E402

QUERY = {"w": ["96"], "h": ["64"], "z": ["-1"], "prompts": ["chair,table"]}


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    import view_server as jax_vs

    tmp = tmp_path_factory.mktemp("torch_viewer")
    arrays, alive = scene_arrays(n=400, seed=51)
    arrays["means"][:, 2] -= 1.0
    ply = tmp / "model" / "point_cloud" / "iteration_7" / "point_cloud.ply"
    save_gaussian_ply(ply, jax_params(arrays), alive)
    rng = np.random.default_rng(52)
    save_fused_features(tmp / "fusion" / "0.pt", rng.normal(size=(400, 16)).astype(np.float32),
                        alive)
    cfg = tmp / "view.yaml"
    cfg.write_text(
        f"model:\n  model_dir: {tmp / 'model'}\n"
        f"fusion:\n  out_dir: {tmp / 'fusion'}\n  embedding_dim: 16\n"
        "render:\n  backend: pallas\n  device: cpu\n"
    )
    jstate = jax_vs.ViewerState(jax_load_config(str(cfg), []))
    tstate = torch_vs.ViewerState(load_config(str(cfg), ["render.backend=tiled"]))
    return jstate, tstate


def _query(mode):
    return dict(QUERY, mode=[mode])


@pytest.mark.parametrize("mode", ["RGB", "Depth", "Semantic", "Relevancy"])
def test_render_modes_match_jax(states, mode):
    jstate, tstate = states
    a = jstate.render(_query(mode))
    b = tstate.render(_query(mode))
    assert b.shape == a.shape == (64, 96, 3) and b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    if mode == "Semantic":  # palette colours are distinct: equal images = equal classes
        np.testing.assert_array_equal(a, b)
    assert b.max() > b.min()


def test_edit_and_reset_match_jax(states):
    jstate, tstate = states
    base = tstate.render(_query("RGB"))
    for mode in ("Remove", "Color", "Size", "Move"):
        q = {"mode": [mode], "edit": ["chair"], "preserve": ["table"]}
        je, te = jstate.edit(q), tstate.edit(q)
        assert te == je and te["edited"] > 0
        a, b = jstate.render(_query("RGB")), tstate.render(_query("RGB"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, mode
        assert jstate.reset() == tstate.reset() == {"reset": True}
    np.testing.assert_array_equal(tstate.render(_query("RGB")), base)


def test_client_pose_routes_match_jax(states):
    """quat+pos and the full c2w pose give the same camera, in both packages."""
    jstate, tstate = states
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, -0.2, -1.0]
    by_pose = {"pose": [",".join(str(float(v)) for v in c2w.flatten())]}
    by_quat = {"quat": ["1,0,0,0"], "pos": ["0.1,-0.2,-1.0"]}
    imgs = []
    for pose in (by_pose, by_quat):
        q = {"mode": ["RGB"], "w": ["96"], "h": ["64"], "fov": ["0.9"], **pose}
        a, b = jstate.render(q), tstate.render(q)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        imgs.append(b)
    np.testing.assert_array_equal(imgs[0], imgs[1])


def _decode_png(data):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2)
        elif kind == b"IDAT":
            idat += body
        assert struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] == zlib.crc32(
            kind + body)
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_http_round_trip(states):
    from http.server import ThreadingHTTPServer

    _, tstate = states
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), torch_vs.make_handler(tstate))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/render?mode=RGB&w=96&h=64&z=-1", timeout=120) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
            img = _decode_png(r.read())
        np.testing.assert_array_equal(img, tstate.render(_query("RGB")))
        req = urllib.request.Request(f"{base}/edit", data=b"mode=Move&edit=chair", method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["mode"] == "Move"
        req = urllib.request.Request(f"{base}/reset", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read()) == {"reset": True}
        with urllib.request.urlopen(f"{base}/render?mode=Nope&w=8&h=8", timeout=120) as r:
            pytest.fail("an unknown mode must not render")
    except urllib.error.HTTPError as e:
        assert e.code == 500 and "unknown mode" in json.loads(e.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_page_at_root_matches_root_server(states):
    """GET / serves the root view_server.py's interactive page byte for
    byte, as HTML; an unknown path is a 404."""
    from http.server import ThreadingHTTPServer

    import view_server as jax_vs

    _, tstate = states
    assert torch_vs._PAGE == jax_vs._PAGE
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), torch_vs.make_handler(tstate))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/", timeout=60) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "text/html"
            assert r.read() == jax_vs._PAGE.encode()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nowhere", timeout=60)
        assert err.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_dynamic_replay_matches_jax(tmp_path, monkeypatch):
    """model.dynamic: both servers load params.npz and render timestep t
    (`t=`, wrapping past the end) or, with play=1, the timestep the wall
    clock gives at `fps`; images within 1 of 255."""
    import time

    import view_server as jax_vs

    rng = np.random.default_rng(53)
    steps, n = 4, 300
    means = (rng.normal(size=(1, n, 3)) * [1.0, 0.4, 0.6] + [0, 0, 3]).astype(np.float32)
    means = means + np.linspace(0, 0.6, steps, dtype=np.float32)[:, None, None]
    np.savez(
        tmp_path / "params.npz", means3D=means,
        rgb_colors=rng.uniform(size=(steps, n, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(steps, n, 4)).astype(np.float32),
        logit_opacities=rng.uniform(0, 3, size=(n, 1)).astype(np.float32),
        log_scales=rng.uniform(-3, -2, size=(n, 3)).astype(np.float32),
        seg_colors=rng.uniform(size=(n, 3)).astype(np.float32),
    )
    cfg = tmp_path / "view.yaml"
    cfg.write_text(f"model:\n  model_dir: {tmp_path}\n  dynamic: true\n"
                   "render:\n  backend: pallas\n  device: cpu\n")
    jstate = jax_vs.ViewerState(jax_load_config(str(cfg), []))
    tstate = torch_vs.ViewerState(load_config(str(cfg), ["render.backend=tiled"]))
    assert tstate.dynamic.num_timesteps == steps
    q = {"mode": ["RGB"], "w": ["96"], "h": ["64"], "z": ["0"]}
    frames = {}
    for t in (0, 2, 5):  # 5 wraps to 1
        a, b = jstate.render(dict(q, t=[str(t)])), tstate.render(dict(q, t=[str(t)]))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        frames[t] = b
    assert not np.array_equal(frames[0], frames[2])
    np.testing.assert_array_equal(frames[5], tstate.render(dict(q, t=["1"])))
    # wall-clock replay: 2.6 s after the start at 1 frame a second is timestep 2
    now = time.time()
    jstate._start_time = tstate._start_time = now - 2.6
    monkeypatch.setattr(time, "time", lambda: now)
    play = dict(q, play=["1"], fps=["1"], t=["0"])
    np.testing.assert_array_equal(tstate.render(play), frames[2])
    assert np.abs(jstate.render(play).astype(int) - frames[2].astype(int)).max() <= 1
    np.testing.assert_array_equal(tstate.render(dict(play, play=["0"])), frames[0])

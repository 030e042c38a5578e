"""Port parity: the multi-step dispatch. The JAX package runs K dependent
train steps (train_scan_step), K evaluated views (_eval_chunk) and K fused
views (_fuse_chunk) in one lax.scan dispatch; the port runs them as one
CUDA-graph replay (utils.graphs), and on the CPU, as here, the same chunk
schedule step by step. Held here: the chunk schedule against JAX's rule;
train_loop at steps_per_dispatch 1 and 5 against JAX's (camera order,
every step's budget and the chunk ends exact, losses at JAX's own rtol
5e-3); the chunked loop against the single-step loop bit for bit; the
budget check over a chunk's largest overflow; chunked evaluation and
fusion against JAX's chunked paths; the fixed-shape fuse_view against the
gathering one bit for bit; the graph runner on the CPU."""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from semantic_gaussians_tpu.models.predictors import (  # noqa: E402
    RandomFeatureProvider as JaxRandomProvider,
)
from semantic_gaussians_tpu.pipelines import eval_segmentation as jeval  # noqa: E402
from semantic_gaussians_tpu.pipelines import fusion as jfusion  # noqa: E402
from semantic_gaussians_tpu.pipelines import train as jtrain  # noqa: E402
from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera  # noqa: E402
from semantic_gaussians_torch.core.gaussians import tree_leaves  # noqa: E402
from semantic_gaussians_torch.models.predictors import RandomFeatureProvider  # noqa: E402
from semantic_gaussians_torch.ops import kernels  # noqa: E402
from semantic_gaussians_torch.pipelines import eval_segmentation as teval  # noqa: E402
from semantic_gaussians_torch.pipelines import fusion as tfusion  # noqa: E402
from semantic_gaussians_torch.pipelines import train as ttrain  # noqa: E402
from semantic_gaussians_torch.utils.camera import make_camera as torch_camera  # noqa: E402
from semantic_gaussians_torch.utils.graphs import GraphRunner  # noqa: E402
from torch_port_common import FIELDS, jax_params, np_, scene_arrays, torch_params  # noqa: E402


# ---------------------------------------------------------------- schedule
def jax_chunks(iter_offset, steps_per_dispatch, iters):
    """JAX's chunk rule, as semantic_gaussians_tpu/pipelines/train.py:336-344
    writes it: [(first iteration, steps), ...]."""
    out, rel_done = [], 0
    while rel_done < iters:
        s = iter_offset + rel_done + 1
        n = min(steps_per_dispatch, iters - rel_done)
        n = min(n, 10 * (-(-s // 10)) - s + 1)
        n = min(n, 1000 * (s // 1000) + 1000 - s)
        out.append((s, n))
        rel_done += n
    return out


@pytest.mark.parametrize("iter_offset,spd,iters", [
    (0, 1, 25), (0, 10, 100), (33, 5, 27), (7, 10, 30), (990, 10, 25), (995, 7, 30),
    (2985, 20, 40), (0, 3, 31), (12, 100, 50), (999, 10, 3),
])
def test_chunk_schedule_matches_jax(iter_offset, spd, iters):
    got, rel = [], 0
    while rel < iters:
        s = iter_offset + rel + 1
        n = ttrain.chunk_length(s, spd, iters - rel)
        got.append((s, n))
        rel += n
    assert got == jax_chunks(iter_offset, spd, iters)
    # every chunk but the last is a full one or ends on a multiple of 10 or
    # just before a multiple of 1000, and none crosses one (an SH change)
    assert all(n == spd or (s + n - 1) % 10 == 0 or (s + n) % 1000 == 0 for s, n in got[:-1])
    assert all(s // 1000 == (s + n - 1) // 1000 for s, n in got)


# ---------------------------------------------------------------- train_loop
W, H = 64, 48
N = 300


def _jax_state_numpy(state):
    return dict(
        params={f: np.asarray(getattr(state.params, f)) for f in FIELDS},
        alive=np.asarray(state.alive),
        adam=dict(count=np.asarray(state.adam.count),
                  mu={f: np.asarray(getattr(state.adam.mu, f)) for f in FIELDS},
                  nu={f: np.asarray(getattr(state.adam.nu, f)) for f in FIELDS}),
        dstate={k: np.asarray(getattr(state.dstate, k))
                for k in ("xyz_grad_accum", "denom", "max_radii2d")},
        step=np.asarray(state.step),
    )


def _toy_training(views=4, seed=41):
    """A toy scene, its start state in both packages, and `views` cameras
    on an arc with target images rendered from a shifted scene."""
    arrays, alive = scene_arrays(n=N, seed=seed)
    target = dict(arrays, sh_dc=arrays["sh_dc"] + 0.4)
    rng = np.random.default_rng(seed + 1)
    jcams, tcams = [], []
    from semantic_gaussians_torch.renderer import render

    tparams = torch_params(target)
    for i in range(views):
        t = np.array([0.3 * (i - views / 2), 0.05 * (-1) ** i, 0.0])
        args = (np.eye(3), t, 1.2, 0.9, W, H)
        with torch.no_grad():
            img = render(torch_camera(*args), tparams, torch.from_numpy(alive),
                         bg=torch.zeros(3))["render"].numpy()
        img = np.clip(img + 0.02 * rng.normal(size=img.shape), 0, 1).astype(np.float32)
        jcams.append(jax_camera(*args, image=jnp.asarray(img), image_name=f"v{i}"))
        tcams.append(torch_camera(*args, image=img, image_name=f"v{i}"))
    jstate = jtrain.init_train_state(jax_params(arrays), jnp.asarray(alive))
    tstate = ttrain.train_state_from_numpy(_jax_state_numpy(jstate), "cpu")
    return jstate, tstate, jcams, tcams


def _record(monkeypatch, module, names, sink):
    """Wrap module.train_step / train_scan_step to record each dispatch the
    loop makes (not the port's steps inside a chunk) as (steps, pair budget,
    camera translations)."""
    depth = [0]
    for name in names:
        fn = getattr(module, name)

        def wrapped(state, cam, bg, cfg, sh, backend="pallas", pair_budget=None, *a,
                    _fn=fn, **kw):
            if not depth[0]:
                wv = np_(cam.world_view)
                wv = wv if wv.ndim == 3 else wv[None]
                sink.append((len(wv), pair_budget,
                             tuple(round(float(x), 4) for x in wv[:, 0, 3])))
            depth[0] += 1
            try:
                return _fn(state, cam, bg, cfg, sh, backend, pair_budget, *a, **kw)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("spd", [1, 5])
def test_train_loop_matches_jax(spd, monkeypatch):
    """27 iterations from iteration 33 (at K = 5 the second chunk is cut to
    39-40), adaptive budget, no densify, no random background: the camera
    order, every step's pair budget and the chunk ends exact; losses at
    rtol 5e-3 (JAX's own scan-vs-step tolerance); the JAX side through
    the Pallas kernels in interpret mode, as the port's kernels' plain
    versions, so pair counts agree."""
    jstate, tstate, jcams, tcams = _toy_training()
    cfg_kw = dict(densify_from_iter=10_000, spatial_lr_scale=2.0)
    jseen, tseen = [], []
    _record(monkeypatch, jtrain, ("train_step", "train_scan_step"), jseen)
    _record(monkeypatch, ttrain, ("train_step", "train_scan_step"), tseen)
    _, jhist = jtrain.train_loop(
        jstate, jcams, jtrain.TrainConfig(**cfg_kw), jax.random.PRNGKey(0), num_iters=27,
        backend="pallas", log_every=1, iter_offset=33, steps_per_dispatch=spd, shuffle_seed=3)
    _, tlog = ttrain.train_loop(
        tstate, tcams, ttrain.TrainConfig(**cfg_kw), None, num_iters=27, iter_offset=33,
        steps_per_dispatch=spd, shuffle_seed=3)
    assert tseen == jseen
    assert tlog["chunks"] == jax_chunks(33, spd, 27)
    if spd == 5:
        assert tlog["chunks"][:2] == [(34, 5), (39, 2)]
    budgets = [b for n, b, _ in jseen for _ in range(n)]
    assert tlog["budget"] == budgets
    assert [it for it, _ in jhist] == list(range(34, 61))
    np.testing.assert_allclose(np_(tlog["loss"]), [m["loss"] for _, m in jhist], rtol=5e-3)
    np.testing.assert_array_equal(np_(tlog["num_pairs"]), [m["num_pairs"] for _, m in jhist])


def test_chunked_loop_matches_single_step_loop():
    """The port's chunks (K = 5 and 10) against its single-step loop, with
    densify (at 10 and 20) and an explicit budget: bit for bit."""
    _, tstate, _, tcams = _toy_training(seed=43)
    cfg = ttrain.TrainConfig(densify_from_iter=5, densification_interval=10,
                             densify_until_iter=25, spatial_lr_scale=2.0)
    out = {}
    for spd in (1, 5, 10):
        gen = torch.Generator().manual_seed(5)
        out[spd] = ttrain.train_loop(tstate, tcams, cfg, gen, 2.0, num_iters=24,
                                     pair_budget=16384, steps_per_dispatch=spd)
    (s1, l1) = out[1]
    assert [it for it, _, _ in l1["densify"]] == [10, 20]
    for spd in (5, 10):
        s, log = out[spd]
        assert log["densify"] == l1["densify"]
        assert torch.equal(log["loss"], l1["loss"]) and torch.equal(log["psnr"], l1["psnr"])
        for k, v in tree_leaves(s).items():
            assert torch.equal(v, tree_leaves(s1)[k]), k
        assert log["graphs"] == dict(captures=0, replays=0)  # the CPU runs the body eagerly


def test_budget_doubles_on_an_early_overflow_in_a_chunk(monkeypatch):
    """Step 46 overflows and the chunk 46-50 ends without: the check at 50
    records the chunk's largest overflow, so the budget doubles at 60 (as
    JAX decides); the stubbed steps feed both loops the same metrics."""
    jstate, tstate, jcams, tcams = _toy_training()

    def metrics(step, array):
        return dict(loss=array(0.5), psnr=array(20.0), num_points=array(N),
                    overflow=array(1 if step == 46 else 0), num_pairs=array(1000))

    def stubs(module, array, stack):
        def one(state, cam, bg, cfg, sh, backend="pallas", pair_budget=None):
            it = int(state.step) + 1
            return dataclasses.replace(state, step=state.step + 1), metrics(it, array)

        def scan(state, cam_stack, bgs, cfg, sh, backend="pallas", pair_budget=None, *a):
            per = []
            for _ in range(bgs.shape[0]):
                state, m = one(state, None, None, cfg, sh)
                per.append(m)
            return state, {k: stack([m[k] for m in per]) for k in per[0]}

        monkeypatch.setattr(module, "train_step", one)
        monkeypatch.setattr(module, "train_scan_step", scan)

    stubs(jtrain, jnp.asarray, jnp.stack)
    stubs(ttrain, torch.tensor, torch.stack)
    jseen, tseen = [], []
    _record(monkeypatch, jtrain, ("train_step", "train_scan_step"), jseen)
    _record(monkeypatch, ttrain, ("train_step", "train_scan_step"), tseen)
    start = dict(step=40)
    jstate = dataclasses.replace(jstate, step=jnp.asarray(start["step"], jnp.int32))
    tstate = dataclasses.replace(tstate, step=torch.tensor(start["step"], dtype=torch.int32))
    cfg_kw = dict(densify_from_iter=10_000)
    jtrain.train_loop(jstate, jcams, jtrain.TrainConfig(**cfg_kw), jax.random.PRNGKey(0),
                      num_iters=30, iter_offset=40, steps_per_dispatch=5)
    _, tlog = ttrain.train_loop(tstate, tcams, ttrain.TrainConfig(**cfg_kw), None,
                                num_iters=30, iter_offset=40, steps_per_dispatch=5)
    budgets = [b for n, b, _ in jseen for _ in range(n)]
    assert tlog["budget"] == budgets
    base = budgets[0]
    assert budgets == [base] * 20 + [2 * base] * 10  # steps 41-60, then 61-70


# ---------------------------------------------------------------- evaluation
EW, EH, ED = 64, 48, 16
LABELS = ("wall", "floor", "chair", "table", "door")


@pytest.mark.parametrize("pred_on_3d", [True, False], ids=["onehot_render", "feature_render"])
def test_eval_views_chunked_matches_jax(pred_on_3d, monkeypatch):
    """7 views in chunks of 3 (two chunks and a view on its own), ground
    truth planted from coherent classes: the same views go through chunks
    on both sides, and the confusion sums are equal."""
    arrays, alive = scene_arrays(n=1200, seed=33, dead=50)
    rng = np.random.default_rng(33)
    text = teval.text_feature_matrix(RandomFeatureProvider(ED), LABELS)
    cls = np.digitize(arrays["means"][:, 0], [-1.0, -0.3, 0.3, 1.0])
    feats = (text[cls + 1] + 0.15 * rng.normal(size=(len(cls), ED))).astype(np.float32)
    cams = [(jax_camera(np.eye(3), np.array([0.1 * i - 0.3, 0, 0]), 1.2, 1.0, EW, EH),
             torch_camera(np.eye(3), np.array([0.1 * i - 0.3, 0, 0]), 1.2, 1.0, EW, EH))
            for i in range(7)]
    tparams, talive = torch_params(arrays), torch.from_numpy(alive)
    eye = np.eye(len(LABELS) + 1, dtype=np.float32)
    gts = [np_(teval.predict_label_image(tc, tparams, talive, torch.from_numpy(eye[cls + 1]),
                                         torch.from_numpy(eye), pred_on_3d=True))
           for _, tc in cams]
    chunks = {"jax": [], "torch": []}
    for mod, side in ((jeval, "jax"), (teval, "torch")):
        fn = mod._eval_chunk

        def wrapped(*a, _fn=fn, _side=side, **kw):
            stack = a[1] if _side == "torch" else a[0]
            chunks[_side].append(len(np_(stack.world_view)))
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, "_eval_chunk", wrapped)
    _, _, jconf = jeval.eval_views(
        [c for c, _ in cams], gts, jax_params(arrays), jnp.asarray(alive), jnp.asarray(feats),
        text, LABELS, pred_on_3d=pred_on_3d, backend="pallas", chunk_views=3)
    _, _, tconf = teval.eval_views(
        [c for _, c in cams], gts, tparams, talive, torch.from_numpy(feats), text, LABELS,
        pred_on_3d=pred_on_3d, chunk_views=3)
    _, _, tview = teval.eval_views(
        [c for _, c in cams], gts, tparams, talive, torch.from_numpy(feats), text, LABELS,
        pred_on_3d=pred_on_3d, chunk_views=1)
    assert chunks["torch"] == chunks["jax"] == [3, 3]
    np.testing.assert_array_equal(tconf, tview)
    np.testing.assert_array_equal(tconf, jconf)
    assert tconf.sum() > 0


# ---------------------------------------------------------------- fusion
FW, FH, FC = 64, 48, 16


@pytest.mark.parametrize("depth_mode", ["none", "surface", "image"])
def test_fuse_scene_chunked_matches_jax(depth_mode, tmp_path):
    """6 views in chunks of 4 (the second chunk padded with two zero-weight
    views) against JAX's chunked path: visited masks exact, features at
    rtol 1e-6; and against the port's per-view loop bit for bit."""
    arrays, alive = scene_arrays(n=1500, seed=21, dead=60)
    arrays["opacity_logits"] += 2.0
    cams = []
    for i in range(6):
        args = (np.eye(3), np.array([0.1 * (i - 3), 0.02 * (-1) ** i, 0.0]), 1.2, 1.0, FW, FH)
        cams.append((jax_camera(*args), torch_camera(*args)))
    paths = [f"view{i}" for i in range(6)]
    depth_paths = None
    if depth_mode == "image":
        from PIL import Image

        rng = np.random.default_rng(23)
        depth_paths = []
        for i in range(6):
            d = rng.uniform(3000, 5000, size=(FH, FW)).astype(np.uint16)
            depth_paths.append(str(tmp_path / f"d{i}.png"))
            Image.fromarray(d).save(depth_paths[-1])
    kw = dict(img_dim=(FW, FH), every_k_views=1, depth=depth_mode, visibility_threshold=0.3,
              cut_boundary=2)
    jf, jv = jfusion.fuse_scene(
        jax_params(arrays), jnp.asarray(alive), [c for c, _ in cams], JaxRandomProvider(FC),
        jfusion.FusionConfig(chunk_views=4, **kw), image_paths=paths, depth_paths=depth_paths,
        backend="pallas")
    out = {}
    for chunk in (4, 1):
        out[chunk] = tfusion.fuse_scene(
            torch_params(arrays), torch.from_numpy(alive), [c for _, c in cams],
            RandomFeatureProvider(FC), tfusion.FusionConfig(chunk_views=chunk, **kw),
            image_paths=paths, depth_paths=depth_paths)
    tf, tv = out[4]
    np.testing.assert_array_equal(np_(tv), np_(jv))
    np.testing.assert_allclose(np_(tf), np_(jf), rtol=1e-6, atol=1e-7)
    assert torch.equal(tf, out[1][0]) and torch.equal(tv, out[1][1])
    assert int(tv.sum()) > 100


def test_fusion_reports_inhomogeneous_cameras(capsys):
    arrays, alive = scene_arrays(n=300, seed=21)
    cams = [torch_camera(np.eye(3), np.zeros(3), 1.2, 1.0, FW, FH),
            torch_camera(np.eye(3), np.zeros(3), 1.1, 1.0, FW, FH)]
    tfusion.fuse_scene(torch_params(arrays), torch.from_numpy(alive), cams,
                       RandomFeatureProvider(FC),
                       tfusion.FusionConfig(img_dim=(FW, FH), every_k_views=1, depth="none"),
                       image_paths=["a", "b"])
    assert "cameras are not homogeneous" in capsys.readouterr().out


@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("weight", [None, 1.0, 0.0])
def test_fuse_view_dense_matches_gathering_fuse_view(feat_dtype, weight):
    """fuse_view_dense (every row, exact zeros where masked) against
    fuse_view (only the visible rows): the same bits, twice in a row."""
    arrays, alive = scene_arrays(n=800, seed=51, dead=40)
    rng = np.random.default_rng(52)
    params = torch_params(arrays)
    cam = torch_camera(np.eye(3), np.zeros(3), 1.2, 1.0, FW, FH)
    intr = torch.from_numpy(tfusion._intrinsic_for(cam, (FW, FH)))
    fmap = torch.from_numpy(rng.normal(size=(FH, FW, FC)).astype(np.float32)).to(feat_dtype)
    depth = torch.from_numpy(rng.uniform(3.0, 5.0, size=(FH, FW)).astype(np.float32))
    w = None if weight is None else torch.tensor(weight)
    base = torch.from_numpy(rng.normal(size=(800, FC)).astype(np.float32))
    sums = [base.clone(), base.clone()]
    counts = [torch.zeros(800), torch.zeros(800)]
    for _ in range(2):
        for fn, s, c in ((tfusion.fuse_view, sums[0], counts[0]),
                         (tfusion.fuse_view_dense, sums[1], counts[1])):
            fn(s, c, params.means, torch.from_numpy(alive), cam.world_view, intr, fmap, depth,
               (FW, FH), 0.3, 2, weight=w)
    assert torch.equal(sums[0], sums[1]) and torch.equal(counts[0], counts[1])
    assert (int(counts[0].sum()) > 0) == (weight != 0.0)


# ---------------------------------------------------------------- runner
def test_graph_runner_runs_the_body_eagerly_on_the_cpu():
    """On the CPU the runner calls the body once, on the carry it was given,
    with list inputs stacked; nothing is captured or counted."""
    calls = []
    before = [c.snapshot() for c in kernels.COUNTERS]

    def body(carry, inp):
        calls.append((carry["x"], inp["y"].shape))
        return {"x": carry["x"] + inp["y"].sum(0)}, {"n": torch.tensor(len(inp["y"]))}

    runner = GraphRunner("cpu")
    x = torch.zeros(3)
    carry, out = runner.run("k", body, {"x": x}, {"y": [torch.ones(3), 2 * torch.ones(3)]})
    assert len(calls) == 1 and calls[0][0] is x and calls[0][1] == (2, 3)
    assert torch.equal(carry["x"], torch.full((3,), 3.0)) and int(out["n"]) == 2
    assert runner.captures == runner.replays == 0
    assert [c.snapshot() for c in kernels.COUNTERS] == before


def test_launch_counter_gain_is_added_per_replay():
    """What a capture counted is taken back and added again per replay, by
    key too (the bookkeeping the runner does for the kernels line)."""
    c = kernels.LaunchCounter("test_counter")
    try:
        c.add(2, key=21)
        snap = c.snapshot()
        c.add(3, key=768)
        c.add(1)
        gain = c.since(snap)
        assert gain == (4, {21: 0, 768: 3})
        c.add_gain(gain, -1)
        assert c.count == 2 and c.by_key == {21: 2}
        for _ in range(2):
            c.add_gain(gain)
        assert c.count == 10 and c.by_key == {21: 2, 768: 6}
    finally:
        kernels.COUNTERS.remove(c)

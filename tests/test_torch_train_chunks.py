"""A training run cut into calls of train_loop that share one GraphRunner
(as the parity harness drives it) against one call, and against calls with
a runner each; and tools.make_toy_scene against the root tool. On the CPU
the runner runs each chunk eagerly, so the states agree bit for bit (the
tolerance of tests/test_torch_dispatch.py's chunked-loop test)."""
import json

import numpy as np
import torch

from semantic_gaussians_torch.core.gaussians import tree_leaves
from semantic_gaussians_torch.pipelines import train as ttrain
from semantic_gaussians_torch.utils.graphs import GraphRunner
from test_torch_dispatch import _toy_training

CFG = ttrain.TrainConfig(densify_from_iter=5, densification_interval=10,
                         densify_until_iter=25, spatial_lr_scale=2.0)


def _equal_states(a, b):
    ta, tb = tree_leaves(a), tree_leaves(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _calls(state, cams, splits, runner_for):
    """train_loop called once a split, iter_offset and shuffle_seed from
    the iterations done, one generator over all calls."""
    gen = torch.Generator().manual_seed(5)
    done, logs = 0, []
    for n in splits:
        state, log = ttrain.train_loop(state, cams, CFG, gen, 2.0, num_iters=n,
                                       iter_offset=done, shuffle_seed=done,
                                       pair_budget=16384, steps_per_dispatch=5,
                                       runner=runner_for())
        logs.append(log)
        done += n
    return state, logs


def test_two_calls_with_a_shared_runner_match_one_call():
    """One training camera (so that the per-call shuffles agree): 24
    iterations as 12 + 12 with one runner against one call of 24, with a
    densify in each half (at 10 and 20)."""
    _, tstate, _, tcams = _toy_training(seed=44)
    runner = GraphRunner("cpu")
    split, slog = _calls(tstate, tcams[:1], (12, 12), lambda: runner)
    whole, wlog = _calls(tstate, tcams[:1], (24,), lambda: None)
    _equal_states(split, whole)
    assert [e for log in slog for e in log["densify"]] == wlog[0]["densify"]
    assert [it for it, _, _ in wlog[0]["densify"]] == [10, 20]
    assert torch.equal(torch.cat([log["loss"] for log in slog]), wlog[0]["loss"])
    chunks = [c for log in slog for c in log["chunks"]]  # cut at the calls' boundary too
    assert [s for s, _ in chunks] == list(np.cumsum([1] + [n for _, n in chunks])[:-1])
    assert sum(n for _, n in chunks) == 24 and (11, 2) in chunks


def test_a_shared_runner_changes_nothing():
    """Four cameras, 30 iterations in calls of 10 (the harness's way):
    one runner for all calls against a runner a call (the default)."""
    _, tstate, _, tcams = _toy_training(seed=45)
    runner = GraphRunner("cpu")
    shared, slog = _calls(tstate, tcams, (10, 10, 10), lambda: runner)
    fresh, flog = _calls(tstate, tcams, (10, 10, 10), lambda: None)
    _equal_states(shared, fresh)
    for a, b in zip(slog, flog):
        assert torch.equal(a["loss"], b["loss"]) and a["cameras"] == b["cameras"]
        assert a["densify"] == b["densify"]
    assert slog[-1]["graphs"] == dict(captures=0, replays=0)  # eager on the CPU


def test_make_toy_scene_matches_the_root_tool(tmp_path):
    """The same poses, point cloud and (within one grey level) images as
    the root tools/make_toy_scene.py at a small size."""
    from PIL import Image

    import tools.make_toy_scene as jax_tool
    from semantic_gaussians_torch.io.ply import load_point_cloud
    from semantic_gaussians_torch.io.scene import load_scene
    from semantic_gaussians_torch.tools.make_toy_scene import make_toy_scene

    kw = dict(n_cams=2, w=32, h=24, n_gauss=40, seed=3)
    jax_tool.main(str(tmp_path / "jax"), **kw)
    make_toy_scene(tmp_path / "port", device="cpu", **kw)
    j = json.loads((tmp_path / "jax" / "transforms_train.json").read_text())
    t = json.loads((tmp_path / "port" / "transforms_train.json").read_text())
    assert t == j
    for a, b in zip(load_point_cloud(tmp_path / "port" / "points3d.ply"),
                    load_point_cloud(tmp_path / "jax" / "points3d.ply")):
        if a is not None or b is not None:
            np.testing.assert_array_equal(a, b)
    for i in range(2):
        a = np.asarray(Image.open(tmp_path / "port" / f"r_{i}.png"), np.int16)
        b = np.asarray(Image.open(tmp_path / "jax" / f"r_{i}.png"), np.int16)
        assert a.shape == b.shape == (24, 32, 3) and np.abs(a - b).max() <= 1
        assert a.std() > 0
    info = load_scene(tmp_path / "port", eval_split=False)
    assert len(info.train_cameras) == 2 and info.points.shape == (40, 3)

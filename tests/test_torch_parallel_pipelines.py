"""Port parity: parallel fusion and distillation, the multihost helpers,
the launch rehearsal and the train CLI's distributed branch.

The port's ranks are spawned gloo CPU processes (torch_dist_common).
  * make_parallel_fuse_step against serial fuse_view (counts exact,
    features rtol / atol 1e-6), a padded slot (weight 0) included;
  * make_parallel_distill_step (MinkUNet14A) against JAX's on `make_mesh(2)`:
    the loss at rtol 1e-4, the averaged batch statistics and the weights
    after AdamW (optax's update replayed on the port's gradients) at 1e-4
    of each leaf's largest; the gradients through the same ReLU masks (see
    that test);
  * stack_items against JAX's; the multihost helpers in one process; the
    2 x 2 launch rehearsal; the train CLI with pipeline.distributed=true on
    two CPU ranks.
"""
import os
import pathlib
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantic_gaussians_tpu.data.feature_dataset import DistillItem as JaxItem
from semantic_gaussians_tpu.parallel.mesh import make_mesh as jax_mesh
from semantic_gaussians_tpu.pipelines import distill as jd
from semantic_gaussians_torch.config.config import default_config_dir
from semantic_gaussians_torch.core.gaussians import params_from_numpy
from semantic_gaussians_torch.io.ply import load_gaussian_ply
from semantic_gaussians_torch.models.unet3d import build_topology, unet_state_from_flax
from semantic_gaussians_torch.parallel import multihost
from semantic_gaussians_torch.pipelines import distill as td
from semantic_gaussians_torch.pipelines.fusion import _intrinsic_for, fuse_view
from semantic_gaussians_torch.renderer import render
from semantic_gaussians_torch.tools.relu_flips import relu_calls, sign_flips
from semantic_gaussians_torch.utils import losses as tloss
from semantic_gaussians_torch.utils.camera import make_camera
from test_torch_cli_train import write_toy_scene
from test_torch_distill import _close_to_leaf_max, _tree
from torch_dist_common import run_ranks
from torch_parallel_ranks import cli_rank, distill_rank, fuse_rank
from torch_port_common import scene_arrays

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("depth_mode", ["render", "surface"])
def test_parallel_fuse_step_matches_serial(tmp_path, depth_mode):
    """Four views in two steps of two ranks, the last slot padded (weight
    0), against fuse_view view by view (the JAX package's
    test_parallel_fuse_step_matches_serial)."""
    arrays, alive = scene_arrays(n=300, seed=60)
    w, h, c = 48, 32, 16
    specs = [dict(R=np.eye(3), t=np.array([0.07 * i - 0.25, 0.0, 0.0]), fov_x=1.2, fov_y=0.9,
                  width=w, height=h) for i in range(4)]
    cams = [make_camera(**s) for s in specs]
    feats = np.random.default_rng(61).normal(size=(4, h, w, c)).astype(np.float32)
    intr = np.stack([_intrinsic_for(cam, (w, h)) for cam in cams])
    weights = np.array([1, 1, 1, 0], np.float32)
    outs = run_ranks(fuse_rank, 2, tmp_path, arrays, alive, specs, intr, feats, weights,
                     depth_mode, (w, h))
    params = params_from_numpy(arrays, "cpu")
    alive_t = torch.from_numpy(alive)
    sem, cnt = torch.zeros((params.capacity, c)), torch.zeros(params.capacity)
    from semantic_gaussians_torch.data.fusion_utils import surface_depth

    for i in range(3):
        intr_i = torch.from_numpy(intr[i])
        if depth_mode == "render":
            depth = render(cams[i], params, alive=alive_t, override_shape=(w, h))["depth"]
        else:
            depth = surface_depth(cams[i].world_view, params.means, intr_i, (w, h), 1,
                                  valid=alive_t)
        fuse_view(sem, cnt, params.means, alive_t, cams[i].world_view, intr_i,
                  torch.from_numpy(feats[i]), depth, (w, h), 0.1, 1)
    assert int((cnt > 0).sum()) > 20  # fusion hit
    for out in outs:
        np.testing.assert_array_equal(out["counts"], cnt.numpy())
        np.testing.assert_allclose(out["sem"], sem.numpy(), rtol=1e-6, atol=1e-6)
    assert outs[0]["comm"]["all_reduce"] == 2 * params.capacity * (c + 1) * 4


BUDGET, IN_CH, EMB = 128, 4, 8


def _distill_items(n_items=2, n=60, seed=62):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n_items):
        items.append(dict(
            coords=np.pad(rng.integers(0, 16, size=(n, 3)).astype(np.int32),
                          ((0, BUDGET - n), (0, 0))),
            feats=np.pad(rng.normal(size=(n, IN_CH)).astype(np.float32),
                         ((0, BUDGET - n), (0, 0))),
            gt=np.pad(rng.normal(size=(n, EMB)).astype(np.float32), ((0, BUDGET - n), (0, 0))),
            gt_mask=np.arange(BUDGET) < n, mask=np.arange(BUDGET) < n, num_voxels=n,
        ))
    return items


def test_stack_items_matches_jax():
    items = _distill_items(3)
    want = jd.stack_items([JaxItem(**it) for it in items])
    from types import SimpleNamespace

    got = td.stack_items([SimpleNamespace(**it) for it in items], "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _grads_through(state, item, dtype, masks=None):
    """The port's gradients of one item's training loss at `state`
    (MinkUNet14A, train mode) in `dtype`, through `masks` if given; with
    the ReLU inputs."""
    net = td.mink_unet(IN_CH, EMB, "MinkUNet14A")
    net.load_state_dict(state)
    net.to(dtype).train()
    c, f, g, gm, m = (torch.from_numpy(item[k]) for k in ("coords", "feats", "gt", "gt_mask",
                                                         "mask"))
    with relu_calls(masks) as pre:
        out = net(f.to(dtype), build_topology(c, m))
    tloss.cosine_distill_loss(out, g.to(dtype), mask=gm).backward()
    return {k: p.grad.double() for k, p in net.named_parameters()}, pre


def test_parallel_distill_step_matches_jax(tmp_path, monkeypatch):
    """One scene a rank on two ranks against JAX's make_parallel_distill_step
    on make_mesh(2), from JAX's initial weights.

    Float32 gradients of the sparse UNet jump by a few percent of a leaf's
    largest where a ReLU pre-activation within rounding of zero lands on
    the other side in one package's sums (tools/relu_flips.py). So JAX's
    averaged gradients (its Adam first moment / 0.1) are held against the
    port's per-scene float64 gradients run through JAX's own ReLU masks of
    that scene, averaged; and the port's averaged float32 gradients against
    the port's float64 through the port's masks. Every flip lies within
    1e-5 of its call's largest magnitude of zero."""
    jcfg = jd.DistillConfig(model_3d="MinkUNet14A", feature_dim=EMB, in_channels=IN_CH)
    tcfg = td.DistillConfig(model_3d="MinkUNet14A", feature_dim=EMB, in_channels=IN_CH)
    model, variables, tx, opt_state = jd.make_distill_state(jcfg, BUDGET, 1)
    items = _distill_items()
    # each ReLU's sign mask on each device, sent to the host from inside the
    # step (flax.linen.relu, which the JAX UNet calls, is wrapped for it)
    jmasks, relu = {}, nn.relu

    def recorded(x, calls=[0]):
        i = calls[0]
        calls[0] += 1
        jax.debug.callback(lambda s, d, i=i: jmasks.__setitem__((int(d), i), np.array(s)),
                           x > 0, jax.lax.axis_index("data"))
        return relu(x)

    monkeypatch.setattr(nn, "relu", recorded)
    step = jd.make_parallel_distill_step(model, tx, jcfg, jax_mesh(2))
    new_vars, new_opt, loss = step(variables, opt_state,
                                   *jd.stack_items([JaxItem(**it) for it in items]))
    jax.block_until_ready(loss)
    jax.effects_barrier()
    jgrads = jax.tree.map(lambda m: np.asarray(m) / 0.1, new_opt[0].mu)  # mu = 0.1 g

    net = td.mink_unet(IN_CH, EMB, "MinkUNet14A")
    state = unet_state_from_flax(jax.tree.map(np.asarray, variables), net)
    state_np = {k: v.numpy() for k, v in state.items()}
    outs = run_ranks(distill_rank, 2, tmp_path, tcfg, state_np, items)
    a, b = outs
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)
    assert abs(a["loss"] - float(loss)) <= 1e-4 * abs(float(loss))

    # the averaged gradients, through each side's ReLU masks
    net.load_state_dict(state)
    port_grads = {k: torch.from_numpy(v) for k, v in a["grads"].items()}
    calls = len(jmasks) // len(items)
    assert calls == 25
    through_jax, through_own = [], []
    for d, it in enumerate(items):
        masks = [torch.from_numpy(jmasks[(d, i)]) for i in range(calls)]
        _, pre32 = _grads_through(state, it, torch.float32)
        f64, pre64 = _grads_through(state, it, torch.float64)
        for signs in (pre32, [mk.double() - 0.5 for mk in masks]):
            assert all(fl[2] <= 1e-5 for fl in sign_flips(signs, pre64))
        through_jax.append(_grads_through(state, it, torch.float64, masks)[0])
        through_own.append(_grads_through(state, it, torch.float64, [x > 0 for x in pre32])[0])
    mean = lambda gs: {k: sum(g[k] for g in gs) / len(gs) for k in gs[0]}  # noqa: E731
    _close_to_leaf_max(_tree(net, mean(through_jax)), jgrads,
                       "JAX's averaged gradients vs the port's float64 through JAX's masks")
    _close_to_leaf_max(_tree(net, port_grads), _tree(net, mean(through_own)),
                       "the port's averaged gradients vs its float64 through its masks")

    # the weights after AdamW: optax's update replayed on the port's gradients
    params = jax.tree.map(jnp.asarray, variables["params"])
    updates, _ = tx.update(jax.tree.map(jnp.asarray, _tree(net, port_grads)), opt_state, params)
    replay = optax.apply_updates(params, updates)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in a["state"].items()})
    from semantic_gaussians_torch.models.unet3d import unet_state_to_flax

    tree = unet_state_to_flax(net)
    _close_to_leaf_max(tree["params"], replay, "weights vs optax replay")
    _close_to_leaf_max(tree["batch_stats"], new_vars["batch_stats"], "averaged batch stats")


def test_multihost_helpers_single_process(monkeypatch):
    """Launched by no one: init_distributed does nothing, every mesh has
    one rank, rank 0 is primary, the global batch is the local one."""
    for k in ("SGTPU_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_distributed(device="cpu") is False
    assert multihost.is_primary()
    mesh = multihost.make_view_band_mesh()
    assert mesh.shape == {"view": 1, "band": 1}
    assert multihost.make_data_mesh().shape == {"data": 1}
    tree = {"x": torch.ones((1, 4))}
    out = multihost.global_batch_from_local(tree, mesh, "view")
    assert out["x"].shape == (1, 4)
    calls = []
    multihost.primary_only(calls.append)(1)
    assert calls == [1]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="1 ranks not divisible by 3"):
        multihost.make_view_band_mesh()


def test_init_distributed_resolution_order(monkeypatch):
    """Explicit arguments, then SGTPU_*, then a launcher's MASTER_ADDR /
    WORLD_SIZE / RANK; the backend is gloo for the CPU unless given; the
    timeout is bounded. (init_process_group is recorded, not run.)"""
    seen = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    for k in ("SGTPU_COORDINATOR", "SGTPU_NUM_PROCS", "SGTPU_PROC_ID", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.9")
    monkeypatch.setenv("MASTER_PORT", "29400")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    assert multihost.init_distributed(device="cpu")
    assert seen[-1][0] == "gloo"
    assert seen[-1][1]["init_method"] == "tcp://10.0.0.9:29400"
    assert (seen[-1][1]["world_size"], seen[-1][1]["rank"]) == (8, 5)
    assert seen[-1][1]["timeout"].total_seconds() == multihost.DEFAULT_TIMEOUT_S
    monkeypatch.setenv("SGTPU_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("SGTPU_NUM_PROCS", "4")
    monkeypatch.setenv("SGTPU_PROC_ID", "2")
    assert multihost.init_distributed(device="cpu", backend="mpi", timeout_s=30)
    assert seen[-1][0] == "mpi"
    assert seen[-1][1]["init_method"] == "tcp://10.0.0.1:8476"
    assert (seen[-1][1]["world_size"], seen[-1][1]["rank"]) == (4, 2)
    assert seen[-1][1]["timeout"].total_seconds() == 30
    assert multihost.init_distributed("file:///x/store", 3, 1, device="cpu")
    assert seen[-1][1]["init_method"] == "file:///x/store"
    assert (seen[-1][1]["world_size"], seen[-1][1]["rank"]) == (3, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.init_distributed()


def test_multihost_launch_rehearsal(tmp_path):
    """2 nodes x 2 ranks through the SGTPU_* launch path (the JAX
    package's test_multihost_launch_rehearsal)."""
    r = subprocess.run(
        [sys.executable, "-m", "semantic_gaussians_torch.tools.launch_multihost", "--procs",
         "2", "--local", "2", "--steps", "1", "--timeout", "240",
         "--coordinator", f"file://{tmp_path / 'store'}"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "multihost rehearsal OK" in r.stdout


@pytest.mark.parametrize("zero", ["false", "true"])
def test_distributed_train_cli_on_cpu(tmp_path, zero):
    """The train CLI with pipeline.distributed=true on two CPU ranks (a
    1 x 2 view x band mesh): both ranks train alike, rank 0 alone writes
    config.yaml and the PLY, and the PLY renders."""
    scene = tmp_path / "scene"
    write_toy_scene(scene)
    out = tmp_path / "out"
    argv = [
        str(default_config_dir() / "official_train.yaml"), "--device", "cpu",
        f"scene.scene_path={scene}", f"train.out_dir={out}", "model.sh_degree=1",
        "train.iterations=20", "train.test_iterations=[]", "train.save_iterations=[]",
        "train.densify_from_iter=5", "train.densification_interval=10",
        "train.densify_until_iter=11", "train.densify_grad_threshold=0.003",
        "pipeline.distributed=true", f"pipeline.zero={zero}",
    ]
    a, b = run_ranks(cli_rank, 2, tmp_path, argv, init=False)
    ply = out / "point_cloud" / "iteration_20" / "point_cloud.ply"
    assert a["plys"] == [str(ply)] and b["plys"] == []
    assert (out / "config.yaml").exists()
    for k, v in a["state"]["params"].items():
        np.testing.assert_array_equal(v, b["state"]["params"][k], err_msg=k)
    assert int(a["state"]["step"]) == 20
    arrays, alive = load_gaussian_ply(ply)
    assert alive.sum() == a["state"]["alive"].sum() and alive.sum() != 300  # densified
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 5.0]), 0.9, 0.7, 64, 48)
    img = render(cam, params_from_numpy(arrays, "cpu"), torch.from_numpy(alive))["render"]
    assert torch.isfinite(img).all() and float(img.max()) > 0

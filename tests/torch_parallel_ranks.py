"""What each spawned rank of the multi-device tests runs (see
torch_dist_common.run_ranks). No JAX here: the children import only torch
and the port. Inputs arrive as numpy arrays and plain values; results go
back as numpy arrays and plain values."""
import torch

from semantic_gaussians_torch.core.gaussians import FIELDS, params_from_numpy
from semantic_gaussians_torch.parallel import collectives as col
from semantic_gaussians_torch.parallel import multihost
from semantic_gaussians_torch.parallel import train_parallel as tp
from semantic_gaussians_torch.parallel.mesh import make_mesh, make_mesh_of, replicate
from semantic_gaussians_torch.parallel.render_sharded import render_sharded
from semantic_gaussians_torch.pipelines.train import train_state_from_numpy, train_state_to_numpy
from semantic_gaussians_torch.utils.camera import make_camera


def _np(x):
    return x.detach().cpu().numpy()


def collectives_rank(rank, world):
    """Each collective on small tensors of rank-dependent values."""
    mesh = make_mesh(world)
    x = torch.arange(4 * world, dtype=torch.float32).reshape(2 * world, 2) + 100 * rank
    out = dict(
        psum=_np(col.psum(x, mesh, "data")), pmean=_np(col.pmean(x, mesh, "data")),
        pmax=_np(col.pmax(x, mesh, "data")), scatter=_np(col.psum_scatter(x, mesh, "data")),
        gather=_np(col.all_gather(x[:1], mesh, "data")),
        many=[_np(t) for t in col.psum_many([x, x[:, :1] * 2], mesh, "data")],
        replicate=_np(replicate([x], mesh)[0]),
        batch=_np(multihost.global_batch_from_local({"x": x[:1]}, mesh, "data")["x"]),
    )
    # gather_bands: the backward hands this rank its own rows of the
    # cotangent; replicated inputs: the backward sums over the axis
    t = (x[:1] * 1.0).requires_grad_(True)
    w = torch.arange(2 * world, dtype=torch.float32).reshape(world, 2)
    (g,) = torch.autograd.grad((col.gather_bands(t, mesh, "data") * w).sum(), [t])
    out["gather_grad"] = _np(g)
    a = torch.ones(3, requires_grad=True)
    (ra,) = col.replicated([a], mesh, "data")
    (ga,) = torch.autograd.grad((ra * (rank + 1)).sum(), [a])
    out["replicated_grad"] = _np(ga)
    out["comm"] = dict(mesh.comm_bytes)
    return out


def _camera(spec):
    return make_camera(**spec)


def render_rank(rank, world, arrays, alive, cam_spec, bg, override=None, weight=None,
                sh_degree=None):
    """render_sharded over a 1D mesh of the world; with `weight`, the
    gradients of sum(render * weight) too."""
    mesh = make_mesh(world)
    params = params_from_numpy(arrays, "cpu")
    leaves = None
    if weight is not None:
        leaves = [getattr(params, f).requires_grad_(True) for f in FIELDS]
    out = render_sharded(
        _camera(cam_spec), params, torch.from_numpy(alive), mesh, torch.from_numpy(bg),
        override_color=None if override is None else torch.from_numpy(override),
        active_sh_degree=sh_degree,
    )
    res = {k: _np(out[k]) for k in ("render", "depth", "final_T", "n_contrib", "overflow",
                                    "num_pairs", "radii")}
    if weight is not None:
        grads = torch.autograd.grad((out["render"] * torch.from_numpy(weight)).sum(), leaves)
        res["grads"] = {f: _np(g) for f, g in zip(FIELDS, grads)}
    res["comm"] = dict(mesh.comm_bytes)
    return res


def _step_mesh(kind, world, mesh_shape):
    if kind.startswith("hybrid"):
        return make_mesh_of(mesh_shape, ("view", "band"))
    return make_mesh(world)


def steps_rank(rank, world, kind, state_np, cam_specs, bg, cfg, sh_degree, nsteps,
               mesh_shape=None):
    """`nsteps` steps of one schedule from a numpy TrainState: kind is dp,
    band, band_zero, hybrid or hybrid_zero. Returns the final state (ZeRO
    moments gathered), each step's metrics and the bytes handed to the
    collectives."""
    mesh = _step_mesh(kind, world, mesh_shape)
    state = train_state_from_numpy(state_np, "cpu")
    cams = [_camera(s) for s in cam_specs]
    bg = torch.from_numpy(bg)
    h, w = cams[0].height, cams[0].width
    axis = "band" if kind.startswith("hybrid") else "data"
    make = {
        "dp": lambda: tp.make_parallel_train_step(mesh, cfg, sh_degree),
        "band": lambda: tp.make_band_train_step(mesh, cfg, sh_degree),
        "band_zero": lambda: tp.make_band_train_step_zero(mesh, cfg, sh_degree, h, w),
        "hybrid": lambda: tp.make_hybrid_train_step(mesh, cfg, sh_degree, h, w),
        "hybrid_zero": lambda: tp.make_hybrid_train_step_zero(mesh, cfg, sh_degree, h, w),
    }[kind]
    step = make()
    zero = kind.endswith("zero")
    if zero:
        state = tp.shard_moments(state, mesh, axis)
    arg = cams[0] if kind in ("band", "band_zero") else tp.stack_cameras(cams)
    metrics = []
    for _ in range(nsteps):
        state, m = step(state, arg, bg)
        metrics.append({k: float(v) for k, v in m.items()})
    if zero:
        state = tp.gather_moments(state, mesh, axis)
    return dict(state=train_state_to_numpy(state), metrics=metrics, comm=dict(mesh.comm_bytes))


def short_batch_rank(rank, world, state_np, cam_spec, cfg):
    """A view-DP step handed fewer views than ranks: the error it raises."""
    mesh = make_mesh(world)
    step = tp.make_parallel_train_step(mesh, cfg, 1)
    try:
        step(train_state_from_numpy(state_np, "cpu"), tp.stack_cameras([_camera(cam_spec)]),
             torch.zeros(3))
    except ValueError as e:
        return str(e)
    return None


def loop_rank(rank, world, mesh_shape, state_np, cam_specs, cfg, iters, zero, extent):
    """hybrid_train_loop over a (view, band) mesh of the world."""
    mesh = multihost.make_view_band_mesh(ranks_per_node=mesh_shape[1])
    assert mesh.shape == {"view": mesh_shape[0], "band": mesh_shape[1]}
    gen = torch.Generator().manual_seed(0)
    state, hist = tp.hybrid_train_loop(
        train_state_from_numpy(state_np, "cpu"), [_camera(s) for s in cam_specs], cfg, gen,
        mesh, scene_extent=extent, num_iters=iters, log_every=6, zero=zero)
    return dict(state=train_state_to_numpy(state), history=hist)


def fuse_rank(rank, world, arrays, alive, cam_specs, intrinsics, feats, weights, depth_mode,
              img_dim):
    """make_parallel_fuse_step over the batch, `world` views a step."""
    from semantic_gaussians_torch.pipelines.fusion import make_parallel_fuse_step

    mesh = make_mesh(world)
    params = params_from_numpy(arrays, "cpu")
    step = make_parallel_fuse_step(mesh, img_dim, 0.1, 1, depth_mode=depth_mode)
    sem = torch.zeros((params.capacity, feats.shape[-1]))
    cnt = torch.zeros(params.capacity)
    cams = [_camera(s) for s in cam_specs]
    for s in range(0, len(cams), world):
        sem, cnt = step(sem, cnt, params, torch.from_numpy(alive), cams[s:s + world],
                        torch.from_numpy(intrinsics[s:s + world]),
                        torch.from_numpy(feats[s:s + world]),
                        torch.from_numpy(weights[s:s + world]))
    return dict(sem=_np(sem), counts=_np(cnt), comm=dict(mesh.comm_bytes))


def distill_rank(rank, world, cfg, state, items):
    """One make_parallel_distill_step from the given weights, one item a
    rank: the loss, the (averaged) gradients, the weights and batch
    statistics after it."""
    from types import SimpleNamespace

    from semantic_gaussians_torch.pipelines import distill as td

    mesh = make_mesh(world)
    model, opt, schedule = td.make_distill_state(cfg, 1, 0, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    step = td.make_parallel_distill_step(model, opt, schedule, cfg, mesh)
    loss = step(*td.stack_items([SimpleNamespace(**it) for it in items], "cpu"))
    return dict(loss=float(loss), grads={k: _np(p.grad) for k, p in model.named_parameters()},
                state={k: _np(v) for k, v in model.state_dict().items()})


def cli_rank(rank, world, argv):
    """The train CLI on this rank (it makes the process group itself from
    the SGTPU_* variables run_ranks sets)."""
    from semantic_gaussians_torch.cli import train as train_cli

    summary = train_cli.main(argv)
    return dict(state=train_state_to_numpy(summary["state"]),
                plys=[str(p) for p in summary["plys"]], history=summary["logs"][-1]["history"])


def band_grads_rank(rank, world, n, width, height, budget):
    """tools.bench_scaling's band step on the tool's scene: the MSE
    gradients (FIELDS order) with the view split into `world` bands."""
    from semantic_gaussians_torch.tools import bench_scaling

    dev = multihost.rank_device("cpu")
    params, alive, cam, target = bench_scaling.scaling_scene(n, width, height, dev)
    mesh = bench_scaling.band_mesh(world)
    return [_np(g) for g in bench_scaling.band_grads(cam, params, alive, target, mesh, budget)]

"""Time each stage of the bench step on the card, alone.

Port of the root tools/bench_components.py. The scene is bench.py's law
at its headline size (100,000 Gaussians, 640x480: no density shift) with
the fixed pair budget 393,216. Each stage runs chained INNER = 10 times
(each call's output, times 1e-30, fed back into its input, so no call can
be skipped) in one CUDA-graph replay (utils.graphs.GraphRunner: a capture
and a replay, then ITERS = 3 timed replays); its time is the replays' wall
over 30. The stages keep the root tool's names:

- full fwd+bwd, full fwd only: bench.py's step and its forward;
- projection fwd: ops.projection.project_gaussians;
- binning: ops.binning.bin_gaussians (no tile-ellipse cull, as the root
  tool bins), chained through the means;
- pack gather fwd: the JAX package's pair-column gather has no step of its
  own in the port (its composite kernels read the per-Gaussian rows
  through the pair ids); the nearest steps are composite.pack_geometry and
  the gather of [geometry, colour] rows through pair_gaussian;
- pack gather fwd+bwd: the gather's gradient, which in the port is
  rasterize.pair_grads_to_gaussians (generation order, the segment sum) on
  constant cotangent rows;
- composite fwd: ops.composite.composite_forward;
- composite fwd+bwd: composite_forward, then composite_backward on the
  gradient of the mean colour (per-pair rows; no segment sum, as in the
  root tool, whose gradient is the pair columns').

The stages from projection on start from one projection and binning of the
scene. `num_pairs` and `overflow` of that binning are printed first.

    python -m semantic_gaussians_torch.tools.bench_components [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..core.gaussians import FIELDS, GaussianParams
from ..ops.binning import bin_gaussians
from ..ops.composite import composite_backward, composite_forward, pack_geometry
from ..ops.projection import ProjectedGaussians, project_gaussians
from ..ops.rasterize import DEFAULT_TILE, pair_grads_to_gaussians
from ..renderer import render
from ..utils.device import resolve_device
from ..utils.graphs import GraphRunner
from .bench import INNER, bench_scene, mse_grads, time_replays

N, WIDTH, HEIGHT = 100_000, 640, 480
BUDGET = 393_216
PROJ_FLOATS = ("means2d", "depths", "conics", "opacities", "colors")
# Where a stage has no step of the same name in the port: the steps it times.
PORT_STEPS = {
    "pack gather fwd": "composite.pack_geometry + the [geometry, colour] row gather through "
                       "pair_gaussian (the port's composite kernels gather in place)",
    "pack gather fwd+bwd": "rasterize.pair_grads_to_gaussians on constant cotangent rows",
    "composite fwd+bwd": "composite_forward + composite_backward (per-pair rows)",
}


def _nudge(tensors: dict, s: torch.Tensor, scale: float = 1e-30) -> dict:
    """Every float tensor minus scale * s: the dependence of a chain."""
    return {k: v - scale * s if v.is_floating_point() else v for k, v in tensors.items()}


def project(cam, params: GaussianParams, alive) -> ProjectedGaussians:
    return project_gaussians(
        params.means, params.scales, params.quats, params.opacity[:, 0], cam.world_view,
        cam.full_proj, cam.camera_center, cam.width, cam.height, cam.tan_half_fov_x,
        cam.tan_half_fov_y, sh_coeffs=params.sh_coeffs, sh_degree=3, alive=alive)


def gather_rows(proj: dict, pair_gaussian: torch.Tensor) -> torch.Tensor:
    """The pair rows [P, 8 + C]: pack_geometry's row and the colours of
    each pair's Gaussian, zero for an invalid pair (id N)."""
    table = torch.cat([pack_geometry(proj["means2d"], proj["conics"], proj["opacities"],
                                     proj["depths"]), proj["colors"]], dim=1)
    table = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    return table[pair_gaussian.long()]


def make_stages(params: GaussianParams, alive, cam, target, budget: int = BUDGET):
    """{stage: (fn, x0)}, fn(x) -> (the next x, the stage's outputs), x a
    dict of tensors; and (proj0, binning0): the projection and binning the
    later stages start from."""
    th, tw = DEFAULT_TILE
    grid = (-(-cam.height // th), -(-cam.width // tw))
    dev = params.device
    with torch.no_grad():
        proj0 = project(cam, params, alive)
        bin0 = bin_gaussians(proj0.means2d, proj0.depths, proj0.radii_xy, DEFAULT_TILE, grid,
                             budget)
    leaves = {f: getattr(params, f) for f in FIELDS}
    pj = {f: getattr(proj0, f).to(torch.float32).contiguous() for f in PROJ_FLOATS}
    geom0 = pack_geometry(pj["means2d"], pj["conics"], pj["opacities"], pj["depths"])
    colors0 = pj["colors"]
    bg = torch.zeros(3, device=dev)
    frame = (bin0.pair_gaussian, bin0.tile_start, bin0.tile_count, bg, grid[1], th, tw)
    cot_rows = torch.full((budget, 6 + colors0.shape[1]), 1e-6, device=dev)
    live = (torch.arange(budget, device=dev) < bin0.num_pairs)[:, None]
    grads = mse_grads(cam, alive, target, budget)

    def full_fwd_bwd(x):
        g, _ = grads(GaussianParams(**x))
        out = dict(zip(FIELDS, g))
        return {f: x[f] - 1e-30 * out[f] for f in FIELDS}, out

    def full_fwd(x):
        with torch.no_grad():
            out = render(cam, GaussianParams(**x), alive=alive, pair_budget=budget)
        return _nudge(x, out["render"].mean()), out

    def projection(x):
        with torch.no_grad():
            proj = project(cam, GaussianParams(**x), alive)
        return _nudge(x, proj.means2d.mean() + proj.colors.mean()), vars(proj)

    def binning(x):
        with torch.no_grad():
            b = bin_gaussians(x["means2d"], proj0.depths, proj0.radii_xy, DEFAULT_TILE, grid,
                              budget)
        return {"means2d": x["means2d"] - 1e-30 * b.num_pairs.to(torch.float32)}, vars(b)

    def pack_fwd(x):
        rows = gather_rows(x, bin0.pair_gaussian)
        return _nudge(x, rows.mean()), {"rows": rows}

    def pack_bwd(x):
        d_geom, d_colors = pair_grads_to_gaussians(cot_rows, bin0)
        out = {"means2d": d_geom[:, :2], "colors": d_colors}
        return {k: x[k] - 1e-30 * out[k] for k in x}, out

    def comp_fwd(x):
        color, depth, final_t, n_contrib = composite_forward(x["geom"], colors0, *frame)
        out = dict(color=color, depth=depth, final_T=final_t, n_contrib=n_contrib)
        return {"geom": x["geom"] - 1e-30 * color.mean()}, out

    def comp_fwd_bwd(x):
        color, _, final_t, n_contrib = composite_forward(x["geom"], colors0, *frame)
        g_color = torch.full_like(color, 1.0 / color.numel())
        rows = composite_backward(x["geom"], colors0, bin0.pair_gaussian, bin0.tile_start,
                                  bin0.tile_count, bg, g_color, final_t, n_contrib, grid[1],
                                  th, tw)
        s = torch.where(live, rows, 0.0).mean()
        return {"geom": x["geom"] - 1e-8 * s}, {"rows": rows, "live": live}

    stages = {
        "full fwd+bwd": (full_fwd_bwd, leaves),
        "full fwd only": (full_fwd, leaves),
        "projection fwd": (projection, leaves),
        "binning": (binning, {"means2d": pj["means2d"]}),
        "pack gather fwd": (pack_fwd, pj),
        "pack gather fwd+bwd": (pack_bwd, {"means2d": pj["means2d"], "colors": colors0}),
        "composite fwd": (comp_fwd, {"geom": geom0}),
        "composite fwd+bwd": (comp_fwd_bwd, {"geom": geom0}),
    }
    return stages, (proj0, bin0)


def time_stage(name: str, fn, x0: dict, runner: GraphRunner, inner: int = INNER) -> float:
    """ms a call of `fn`, chained `inner` times a replay (bench.time_replays)."""

    def body(carry, _inputs):
        x = carry
        for _ in range(inner):
            x, _ = fn(x)
        return x, {}

    return time_replays(runner, ("bench_components", name), body, dict(x0))[2] * 1e3 / inner


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params, alive, cam, target = bench_scene(N, WIDTH, HEIGHT, dev)
    stages, (_, bin0) = make_stages(params, alive, cam, target)
    num_pairs, overflow = int(bin0.num_pairs), int(bin0.overflow)
    print("num_pairs:", num_pairs, "overflow:", overflow)
    runner = GraphRunner(dev)
    results = {name: time_stage(name, fn, x0, runner) for name, (fn, x0) in stages.items()}
    print()
    for name, ms in results.items():
        note = f"  (port: {PORT_STEPS[name]})" if name in PORT_STEPS else ""
        print(f"{name:>24}: {ms:7.2f} ms{note}")
    return dict(ms=results, num_pairs=num_pairs, overflow=overflow)


if __name__ == "__main__":
    main()

"""The projection's hand-written backward and its autograd Function.

`project_backward_plain` (the backward the CUDA kernel repeats) against
autograd through `project_forward_plain`, in float64 on small scenes that
hold the edge cases by construction: near-plane culls (z = 0.2 exactly and
behind), dead slots, a 2D covariance of determinant exactly 0, means
exactly on and past the 1.3 tan FOV clamp, a colour exactly on its clamp
at 0, SH degrees below the coefficients held, override colours,
cov3d_precomp and a scaling modifier. Then `ProjectFunction`'s dispatch:
the plain versions on the CPU, a refusal elsewhere, the offset's gradient.
"""
import numpy as np
import pytest
import torch

from semantic_gaussians_torch.ops import kernels, projection
from semantic_gaussians_torch.ops.projection import (
    Frame, ProjectFunction, project_backward_plain, project_forward_plain, project_gaussians,
)
from semantic_gaussians_torch.utils.sh import C0

F64 = torch.float64
W, H, TAN_X, TAN_Y = 64, 48, 1.0, 0.75  # focal 32 both ways
N_RANDOM = 48
ZERO_ROWS = 0.3
# the special rows after the random ones
NEAR_EXACT, BEHIND, DEAD, DET_ZERO, ON_CLAMP, PAST_CLAMP, COLOUR_ZERO = range(
    N_RANDOM, N_RANDOM + 7)
N = N_RANDOM + 7
CASES = {  # name: (SH coefficients held or 0 for an override colour, degree, covariance)
    "sh3": (16, 3, "scales"),
    "sh0_of_3": (16, 0, "scales"),
    "sh1_of_3": (16, 1, "scales"),
    "sh2_of_2": (9, 2, "scales"),
    "sh4": (25, 4, "scales"),
    "override": (0, 3, "scales"),
    "cov3d": (16, 3, "cov3d"),
    "scaling_modifier": (16, 3, "scales"),
}


def _camera():
    """Identity pose at the origin looking down +z, so that a mean's view
    point is the mean itself, bit for bit."""
    znear, zfar = 0.01, 100.0
    P = torch.zeros((4, 4), dtype=F64)
    P[0, 0], P[1, 1] = 1.0 / TAN_X, 1.0 / TAN_Y
    P[2, 2], P[2, 3], P[3, 2] = zfar / (zfar - znear), -zfar * znear / (zfar - znear), 1.0
    return torch.eye(4, dtype=F64), P, torch.zeros(3, dtype=F64)


def _inputs(case, seed=0):
    k, deg, cov_kind = CASES[case]
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-20, 20, N), rng.uniform(-15, 15, N), rng.uniform(5, 60, N)],
                     -1)
    means[NEAR_EXACT] = (0.0, 0.0, 0.2)
    means[BEHIND] = (1.0, 2.0, -3.0)
    means[DET_ZERO] = (0.0, 0.0, 32.0)  # u = (1, 0, 0), v = (0, 1, 0) exactly
    means[ON_CLAMP] = (1.3 * TAN_X * 32.0, 0.0, 32.0)  # t_x / t_z = 1.3 tan exactly
    means[PAST_CLAMP] = (2.0 * 32.0, 1.5 * 32.0, 32.0)
    t = {
        "means": torch.tensor(means, dtype=F64),
        "scales": torch.tensor(np.exp(rng.uniform(-3.0, 0.0, (N, 3))), dtype=F64),
        "quats": torch.tensor(rng.normal(size=(N, 4)), dtype=F64),
        "opacities": torch.tensor(rng.uniform(0.01, 0.99, N), dtype=F64),
    }
    alive = torch.ones(N, dtype=torch.bool)
    alive[DEAD] = False
    kw = {}
    if k:
        sh = rng.normal(size=(N, k, 3)) * 0.4
        # a colour exactly on its clamp: sh_0 C0 = -0.5 in the red channel,
        # every other coefficient of the row zero
        sh[COLOUR_ZERO, 1:] = 0.0
        s = -0.5 / C0
        while s * C0 != -0.5:
            s = np.nextafter(s, 0.0 if s * C0 < -0.5 else -1.0)
        sh[COLOUR_ZERO, 0, 0] = s
        t["sh_coeffs"] = torch.tensor(sh, dtype=F64)
    if cov_kind == "cov3d":
        L = torch.tensor(rng.normal(size=(N, 3, 3)) * 0.3, dtype=F64)
        cov = L @ L.transpose(1, 2)
        cov6 = torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1],
                            cov[:, 1, 2], cov[:, 2, 2]], -1)
        a = torch.tensor(1.7, dtype=F64) + 0.3  # a = c = b: det = a c - b b = 0
        cov6[DET_ZERO] = torch.stack([torch.tensor(1.7, dtype=F64), a, torch.zeros((), dtype=F64),
                                      torch.tensor(1.7, dtype=F64),
                                      torch.zeros((), dtype=F64), torch.ones((), dtype=F64)])
        t["cov3d_precomp"] = cov6
    frame = Frame(W, H, TAN_X, TAN_Y, deg, 0.6 if case == "scaling_modifier" else 1.0)
    return t, alive, frame


def _forward(t, alive, frame, offset=None):
    wv, fp, cc = _camera()
    return project_forward_plain(
        t["means"], t["scales"], t["quats"], t["opacities"], wv, fp, cc, frame,
        sh_coeffs=t.get("sh_coeffs"), cov3d_precomp=t.get("cov3d_precomp"), alive=alive,
        mean2d_offset=offset)


def _cotangents(proj, seed=1):
    gen = torch.Generator().manual_seed(seed)
    live = torch.rand(N, generator=gen) >= ZERO_ROWS
    live[N_RANDOM:] = True
    outs = [proj.means2d, proj.depths, proj.conics, proj.opacities]
    if proj.colors is not None:
        outs.append(proj.colors)
    cots = []
    for x in outs:
        g = torch.randn(x.shape, generator=gen, dtype=F64)
        cots.append(g * (live if x.dim() == 1 else live[:, None]))
    return outs, cots, live


@pytest.mark.parametrize("case", sorted(CASES))
def test_hand_backward_matches_autograd(case):
    t, alive, frame = _inputs(case)
    proj = _forward(t, alive, frame)
    # the edge cases hold as built
    assert int(proj.radii[NEAR_EXACT]) == int(proj.radii[BEHIND]) == int(proj.radii[DEAD]) == 0
    assert float(proj.opacities[DEAD]) == 0.0 and int(proj.radii[ON_CLAMP]) > 0
    if "cov3d_precomp" in t:
        assert int(proj.radii[DET_ZERO]) == 0
        assert proj.conics[DET_ZERO].tolist() == [2.0, -2.0, 2.0]  # (c, -b, a) / 1
    if "sh_coeffs" in t:
        assert float(proj.colors[COLOUR_ZERO, 0]) == 0.0

    leaves = {k: v.clone().requires_grad_(True) for k, v in t.items()}
    outs, cots, live = _cotangents(_forward(leaves, alive, frame))
    names = [k for k in leaves if k not in (("scales", "quats") if "cov3d_precomp" in t else ())]
    want = dict(zip(names, torch.autograd.grad(outs, [leaves[k] for k in names], cots)))
    wv, fp, cc = _camera()
    got = dict(zip(
        ("means", "scales", "quats", "opacities", "sh_coeffs", "cov3d_precomp"),
        project_backward_plain(
            t["means"], t["scales"], t["quats"], t.get("sh_coeffs"), t.get("cov3d_precomp"),
            alive, wv, fp, cc, frame, *cots, *([None] if len(cots) == 4 else []))))
    for name in names:
        w, g = want[name], got[name]
        assert g.shape == w.shape and g.dtype == F64, name
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12 * float(w.abs().max()),
                                   msg=name)
        assert not g[~live].any(), f"{name}: nonzero gradient where every cotangent is 0"
    if "cov3d_precomp" in t:
        assert got["scales"] is None and got["quats"] is None
    else:
        assert got["cov3d_precomp"] is None
    # the SH coefficients above the active degree get exactly zero
    if "sh_coeffs" in t:
        assert not got["sh_coeffs"][:, (frame.sh_degree + 1) ** 2:].any()


def test_clamp_bounds_pass_the_gradient():
    """At a bound (the FOV clamp, the colour clamp) the gradient passes, as
    clamp's own backward passes it; past the FOV clamp the ratio gets none."""
    t, alive, frame = _inputs("sh3")
    wv, fp, cc = _camera()
    n_only = torch.zeros(N, dtype=F64)
    g_col = torch.zeros((N, 3), dtype=F64)
    g_col[COLOUR_ZERO, 0] = 1.0
    d = project_backward_plain(t["means"], t["scales"], t["quats"], t["sh_coeffs"], None, alive,
                               wv, fp, cc, frame, None, None, None, n_only, g_col)
    assert float(d[4][COLOUR_ZERO, 0, 0]) == C0  # d colour / d sh_0 = C0, passed at raw = 0
    g_con = torch.zeros((N, 3), dtype=F64)
    g_con[[ON_CLAMP, PAST_CLAMP]] = 1.0
    d = project_backward_plain(t["means"], t["scales"], t["quats"], None, None, alive,
                               wv, fp, cc, frame, None, None, g_con, None, None)
    # d/d mean_x through the clamped ratio: present on the clamp, absent past it
    # (where only tz's share reaches mean_x: none, as t_x enters only the ratio)
    assert float(d[0][ON_CLAMP, 0]) != 0.0 and float(d[0][PAST_CLAMP, 0]) == 0.0


def test_project_function_takes_the_plain_versions_on_the_cpu(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a kernel was loaded on the CPU")

    monkeypatch.setattr(kernels, "load", no_kernel)
    t, alive, frame = _inputs("sh3")
    t = {k: v.float() for k, v in t.items()}
    wv, fp, cc = (x.float() for x in _camera())
    offset = torch.zeros((N, 2))
    leaves = {k: v.clone().requires_grad_(True) for k, v in t.items()}
    off = offset.clone().requires_grad_(True)
    before = projection.LAUNCHES.snapshot()
    proj = project_gaussians(
        leaves["means"], leaves["scales"], leaves["quats"], leaves["opacities"], wv, fp, cc,
        W, H, TAN_X, TAN_Y, sh_coeffs=leaves["sh_coeffs"], sh_degree=3, alive=alive,
        mean2d_offset=off)
    plain = project_forward_plain(t["means"], t["scales"], t["quats"], t["opacities"], wv, fp,
                                  cc, frame, sh_coeffs=t["sh_coeffs"], alive=alive,
                                  mean2d_offset=offset)
    for f in ("means2d", "depths", "conics", "opacities", "colors", "radii", "radii_xy",
              "cull_ellipse"):
        assert torch.equal(getattr(proj, f), getattr(plain, f)), f
    assert proj.radii.dtype == proj.radii_xy.dtype == torch.int32
    assert not proj.radii.requires_grad and not proj.cull_ellipse.requires_grad
    outs, cots, _ = _cotangents(proj)
    cots = [c.float() for c in cots]
    names = ["means", "scales", "quats", "opacities", "sh_coeffs"]
    got = torch.autograd.grad(outs, [leaves[k] for k in names] + [off], cots)
    want = project_backward_plain(t["means"], t["scales"], t["quats"], t["sh_coeffs"], None,
                                  alive, wv, fp, cc, frame, *cots)
    for name, g, w in zip(names, got, want):
        assert torch.equal(g, w), name
    assert torch.equal(got[-1], cots[0])  # the offset's gradient is the means2d cotangent
    assert projection.LAUNCHES.since(before)[0] == 0


def test_override_colour_passes_through_with_its_gradient():
    t, alive, frame = _inputs("override")
    wv, fp, cc = _camera()
    feats = torch.rand((N, 21), dtype=F64, requires_grad=True)
    proj = project_gaussians(t["means"], t["scales"], t["quats"], t["opacities"], wv, fp, cc,
                             W, H, TAN_X, TAN_Y, override_color=feats, alive=alive)
    assert proj.colors is feats
    g = torch.randn((N, 21), dtype=F64)
    (d,) = torch.autograd.grad(proj.colors, feats, g)
    assert torch.equal(d, g)


def test_project_function_refuses_other_devices():
    t, alive, frame = _inputs("sh3")
    wv, fp, cc = _camera()
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="unsupported device meta"):
        ProjectFunction.apply(meta["means"], meta["scales"], meta["quats"], meta["opacities"],
                              meta["sh_coeffs"], None, None, None, wv.to("meta"),
                              fp.to("meta"), cc.to("meta"), frame)


@pytest.mark.parametrize("what", ["dtype", "coefficients", "degree", "alive"])
def test_kernel_inputs_refuse_what_the_kernels_do_not_take(what):
    t, alive, frame = _inputs("sh3")
    t = {k: v.float() for k, v in t.items()}
    wv, fp, cc = (x.float() for x in _camera())
    if what == "dtype":
        t["means"] = t["means"].double()
    elif what == "coefficients":
        t["sh_coeffs"] = t["sh_coeffs"][:, :5]
    elif what == "degree":
        t["sh_coeffs"] = t["sh_coeffs"][:, :9]  # degree 3 needs 16
    else:
        alive = alive.to(torch.uint8)
    with pytest.raises(ValueError):
        projection._kernel_inputs(t["means"], t["scales"], t["quats"], t["sh_coeffs"], None,
                                  alive, wv, fp, cc, frame)


@pytest.mark.parametrize("layout", ["contiguous", "row_slice", "transposed", "expanded"])
def test_cotangent_is_unit_stride_in_its_last_dimension(layout):
    base = torch.randn((N, 8))
    g = {"contiguous": base[:, :3].contiguous(), "row_slice": base[:, 2:5],
         "transposed": base[:3].T, "expanded": torch.full((1, 1), 2.0).expand(N, 3)}[layout]
    got = projection._cotangent(g)
    assert got.stride(1) == 1 and torch.equal(got, g)
    if g.stride(1) == 1:
        assert got is g  # no copy where the kernel can read the rows in place
    assert projection._cotangent(None) is None
    with pytest.raises(ValueError):
        projection._cotangent(g.double())


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.card)])
@pytest.mark.parametrize("layout", ["transposed", "expanded"])
def test_strided_cotangents_give_the_contiguous_gradients(device, layout):
    """Cotangents of the conics and the colours, both [N, 3], that are not
    unit-stride in their last dimension (transposed ones; the expanded ones
    of a weighted sum) give the gradients of their contiguous copies. On the
    card the wrapper copies them and must hold each copy until the kernel
    has read it: two copies of one size would otherwise share a block."""
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        kernels.build_all(["projection"])
    dev = torch.device(device)
    t, alive, frame = _inputs("sh3")
    leaves = {k: v.float().to(dev).requires_grad_(True) for k, v in t.items()}
    wv, fp, cc = (x.float().to(dev) for x in _camera())
    proj = project_gaussians(
        leaves["means"], leaves["scales"], leaves["quats"], leaves["opacities"], wv, fp, cc,
        W, H, TAN_X, TAN_Y, sh_coeffs=leaves["sh_coeffs"], sh_degree=3, alive=alive.to(dev))
    if layout == "transposed":
        gen = torch.Generator().manual_seed(2)
        g_con, g_col = (torch.randn((3, N), generator=gen).to(dev).T for _ in range(2))
    else:
        g_con, g_col = (torch.full((1, 1), w, device=dev).expand(N, 3) for w in (2.0, 3.0))
    assert g_con.stride(1) != 1 and g_col.stride(1) != 1
    names = ["means", "scales", "quats", "sh_coeffs"]
    outs, inputs = [proj.conics, proj.colors], [leaves[k] for k in names]
    got = torch.autograd.grad(outs, inputs, [g_con, g_col], retain_graph=True)
    want = torch.autograd.grad(outs, inputs, [g_con.contiguous(), g_col.contiguous()])
    for name, g, w in zip(names, got, want):
        assert torch.equal(g, w), name

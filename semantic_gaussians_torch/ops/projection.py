"""Per-Gaussian projection ("preprocess") and SH colour, forward and backward.

Port of semantic_gaussians_tpu.ops.projection (XLA there, differentiated by
jax.grad): EWA projection with near cull at view z <= 0.2, the 1.3*tan FOV
clamp, +0.3 px low-pass, eigenvalue floor 0.1, radius = ceil(3*sigma),
per-axis opacity-aware rect extents (`radii_xy`) and the normalized support
quadratic (`cull_ellipse`) that drives the exact tile-ellipse pair cull.
The arithmetic keeps the JAX package's evaluation order term for term.

`project_gaussians` is one autograd node, `ProjectFunction`. For CUDA
tensors its forward and backward are one kernel each (csrc/projection.cu);
for CPU tensors they are the plain versions here: `project_forward_plain`
(torch ops, itself differentiable by autograd) and `project_backward_plain`
(the backward written out by hand, the kernel's arithmetic). The backward
follows autograd's rules for the forward's ops: `torch.where` passes the
gradient to the branch it took, `clamp` where its input lies in the range
or on a bound, and SH coefficients above the active degree get zero.

Dead padded and culled Gaussians flow through the same math, so every
division and square root that reaches the rendered outputs has a safe
operand (tz, det, p_w and the SH direction norm): `torch.where` alone does
not stop a NaN gradient, since the unselected branch's inf still gives
0 * inf. The radii and the cull quadratic feed only integer binning and
carry no gradient.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch

from ..utils.sh import eval_sh, sh_basis, sh_basis_vjp
from ..utils.transforms import normalize_quat
from . import kernels

NEAR_CULL_Z = 0.2
LOWPASS = 0.3
EIG_FLOOR = 0.1
# The SH coefficient counts a Gaussian may hold on the card (degrees 0-4).
KERNEL_SH_COEFFS = (1, 4, 9, 16, 25)

LAUNCHES = kernels.LaunchCounter("projection")  # keys "fwd" and "bwd"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "sgt_project_fwd": (_P,) * 11 + (_I,) * 5 + (_F,) * 5 + (_P,) * 9,
    "sgt_project_bwd": (_P,) * 9 + (_I,) * 5 + (_F,) * 5 + (_P, _L) * 5 + (_P,) * 7,
}


@dataclasses.dataclass(frozen=True)
class ProjectedGaussians:
    """Per-Gaussian screen-space quantities (all [N, ...])."""

    means2d: torch.Tensor  # [N, 2] pixel coords
    depths: torch.Tensor  # [N] view-space z
    conics: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    opacities: torch.Tensor  # [N]
    colors: torch.Tensor  # [N, C]
    radii: torch.Tensor  # [N] int32 circular radius (0 = culled)
    radii_xy: torch.Tensor  # [N, 2] int32 per-axis rect half-extents
    cull_ellipse: Optional[torch.Tensor] = None  # [N, 3] conic / r^2


class Frame(NamedTuple):
    """The scalars of a projection."""

    img_width: int
    img_height: int
    tan_fov_x: float
    tan_fov_y: float
    sh_degree: int
    scaling_modifier: float

    @property
    def focal(self):
        return (self.img_width / (2.0 * self.tan_fov_x),
                self.img_height / (2.0 * self.tan_fov_y))


@dataclasses.dataclass
class _Ewa:
    """The two rows u, v of JW as per-component (N,) tensors, and what
    their gradient needs."""

    in_front: torch.Tensor
    tz: torch.Tensor
    ratio: tuple  # t_x / tz, t_y / tz before the FOV clamp
    clamped: tuple  # the same after it
    txy: tuple  # clamped * tz
    inv_z: torch.Tensor
    u: tuple
    v: tuple


def _ewa(t, W, focal_x, focal_y, tan_fov_x, tan_fov_y) -> _Ewa:
    """JW's rows at the view points t [N, 3] (W: world_view[:3, :3])."""
    one = torch.ones((), dtype=t.dtype, device=t.device)
    in_front = t[:, 2] > NEAR_CULL_Z
    tz = torch.where(in_front, t[:, 2], one)
    limx = 1.3 * tan_fov_x
    limy = 1.3 * tan_fov_y
    ratio = (t[:, 0] / tz, t[:, 1] / tz)
    clamped = (torch.clamp(ratio[0], -limx, limx), torch.clamp(ratio[1], -limy, limy))
    tx, ty = clamped[0] * tz, clamped[1] * tz
    inv_z = 1.0 / tz
    a1 = focal_x * inv_z
    b1 = -focal_x * tx * inv_z * inv_z
    a2 = focal_y * inv_z
    b2 = -focal_y * ty * inv_z * inv_z
    u = tuple(a1 * W[0, j] + b1 * W[2, j] for j in range(3))
    v = tuple(a2 * W[1, j] + b2 * W[2, j] for j in range(3))
    return _Ewa(in_front, tz, ratio, clamped, (tx, ty), inv_z, u, v)


def _quad(cov3d6, p, q):
    """p^T Sigma q of packed covariances (xx, xy, xz, yy, yz, zz)."""
    xx, xy, xz, yy, yz, zz = (cov3d6[:, i] for i in range(6))
    return (
        xx * p[0] * q[0]
        + yy * p[1] * q[1]
        + zz * p[2] * q[2]
        + xy * (p[0] * q[1] + p[1] * q[0])
        + xz * (p[0] * q[2] + p[2] * q[0])
        + yz * (p[1] * q[2] + p[2] * q[1])
    )


def _cov2d_packed(e: _Ewa, cov3d6):
    """EWA projection of packed 3D covariances (xx, xy, xz, yy, yz, zz):
    the 2D covariance (a, b, c) with the low-pass."""
    return (_quad(cov3d6, e.u, e.u) + LOWPASS, _quad(cov3d6, e.u, e.v),
            _quad(cov3d6, e.v, e.v) + LOWPASS)


def _rotation_rows(qn):
    """The rows C[i] (per-component) of the normalized quaternions' matrix."""
    w, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)),
        (2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)),
        (2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)),
    )


def _cov2d_scales_quats(e: _Ewa, scales, quats):
    """The fused EWA path: with L = R diag(s), a = |L^T u|^2, b = (L^T u).(L^T
    v), c = |L^T v|^2 (+ the low-pass), all per-component arithmetic, where
    (L^T p)_i = s_i (C[i] . p). Returns ((a, b, c), (qn, C, C.u, C.v, L^T u,
    L^T v))."""
    qn = normalize_quat(quats)
    C = _rotation_rows(qn)
    cu = tuple(C[i][0] * e.u[0] + C[i][1] * e.u[1] + C[i][2] * e.u[2] for i in range(3))
    cv = tuple(C[i][0] * e.v[0] + C[i][1] * e.v[1] + C[i][2] * e.v[2] for i in range(3))
    lu = tuple(scales[:, i] * cu[i] for i in range(3))
    lv = tuple(scales[:, i] * cv[i] for i in range(3))
    a = lu[0] * lu[0] + lu[1] * lu[1] + lu[2] * lu[2] + LOWPASS
    b = lu[0] * lv[0] + lu[1] * lv[1] + lu[2] * lv[2]
    c = lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2] + LOWPASS
    return (a, b, c), (qn, C, cu, cv, lu, lv)


def _view_point(means, world_view):
    """t = means @ W^T + T, the points in view space (computed once)."""
    return means @ world_view[:3, :3].T + world_view[:3, 3]


def _clip_point(means, full_proj):
    """p_hom [N, 3], whether |p_w| is safe, and rw = 1 / (p_w_safe + 1e-7)."""
    p_hom = means @ full_proj[:3, :3].T + full_proj[:3, 3]
    p_w = means @ full_proj[3, :3] + full_proj[3, 3]
    pw_ok = p_w.abs() > 1e-6
    p_w_safe = torch.where(pw_ok, p_w, torch.full_like(p_w, 1e-6))
    rw = 1.0 / (p_w_safe + 1e-7)
    return p_hom, pw_ok, rw


def _view_dirs(means, camera_center):
    """Unit directions from the camera centre, and their norms [N, 1]."""
    dirs = means - camera_center[None, :]
    norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-20)
    return dirs / norm, norm


def project_forward_plain(
    means, scales, quats, opacities, world_view, full_proj, camera_center, frame: Frame, *,
    sh_coeffs=None, override_color=None, cov3d_precomp=None, alive=None, mean2d_offset=None,
) -> ProjectedGaussians:
    """Plain torch version of the forward (the kernel's reference; autograd
    differentiates it, which the tests hold `project_backward_plain` to).
    Culled entries get radius 0 and opacity 0; colors is the override
    colour if one is given, else the SH colour, else None."""
    focal_x, focal_y = frame.focal
    tan_fov_x, tan_fov_y = frame.tan_fov_x, frame.tan_fov_y

    t = _view_point(means, world_view)
    depths = t[:, 2]
    e = _ewa(t, world_view[:3, :3], focal_x, focal_y, tan_fov_x, tan_fov_y)

    p_hom, _, rw = _clip_point(means, full_proj)
    ndc = p_hom * rw[:, None]
    means2d = torch.stack(
        [
            ((ndc[:, 0] + 1.0) * frame.img_width - 1.0) * 0.5,
            ((ndc[:, 1] + 1.0) * frame.img_height - 1.0) * 0.5,
        ],
        dim=-1,
    )
    if mean2d_offset is not None:
        means2d = means2d + mean2d_offset

    if cov3d_precomp is not None:
        a, b, c = _cov2d_packed(e, cov3d_precomp)
    else:
        (a, b, c), _ = _cov2d_scales_quats(e, scales * frame.scaling_modifier, quats)
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=EIG_FLOOR))
    lambda_max = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda_max, min=0.0)))

    valid = e.in_front & det_ok
    if alive is not None:
        valid = valid & alive
    zero = torch.zeros((), dtype=radius_f.dtype, device=radius_f.device)
    radii = torch.where(valid, radius_f, zero).to(torch.int32)

    # Per-axis, opacity-aware rect half-extents: |dx| <= sigma_x *
    # sqrt(2 ln(255 op)) bounds the alpha >= 1/255 support exactly.
    opac_m = torch.where(valid, opacities, torch.zeros_like(opacities))
    r_mah2 = 2.0 * torch.log(torch.clamp(255.0 * opac_m, min=1.0))
    r_mah = torch.sqrt(r_mah2)
    rx = torch.minimum(radius_f, torch.ceil(r_mah * torch.sqrt(torch.clamp(a, min=0.0))))
    ry = torch.minimum(radius_f, torch.ceil(r_mah * torch.sqrt(torch.clamp(c, min=0.0))))
    radii_xy = torch.where(
        (valid & (r_mah2 > 0.0))[:, None], torch.stack([rx, ry], dim=-1), zero
    ).to(torch.int32)

    colors = override_color
    if override_color is None and sh_coeffs is not None:
        dirs, _ = _view_dirs(means, camera_center)
        raw = eval_sh(frame.sh_degree, sh_coeffs.transpose(-1, -2), dirs) + 0.5
        colors = torch.clamp(raw, min=0.0)

    inv_r2 = torch.where(
        r_mah2 > 0.0, 1.0 / torch.clamp(r_mah2, min=1e-20), torch.zeros_like(r_mah2)
    )
    cull_ellipse = conics * inv_r2[:, None]

    return ProjectedGaussians(
        means2d=means2d,
        depths=depths,
        conics=conics,
        opacities=opac_m,
        colors=colors,
        radii=radii,
        radii_xy=radii_xy,
        cull_ellipse=cull_ellipse,
    )


def project_backward_plain(
    means, scales, quats, sh_coeffs, cov3d_precomp, alive, world_view, full_proj,
    camera_center, frame: Frame, g_means2d, g_depths, g_conics, g_opacities, g_colors,
):
    """Plain torch version of the backward: the gradients (means, scales,
    quats, opacities, sh_coeffs, cov3d_precomp) from the cotangents of
    means2d, depths, conics, opacities and the SH colours, each cotangent
    None for zero. scales / quats get None with cov3d_precomp, cov3d_precomp
    None without; sh_coeffs None without SH. The offset's gradient is the
    means2d cotangent (the caller's)."""
    focal_x, focal_y = frame.focal
    tan_fov_x, tan_fov_y = frame.tan_fov_x, frame.tan_fov_y
    zero = torch.zeros_like(means[:, 0])

    def col(g, j=None):
        return zero if g is None else (g if j is None else g[:, j])

    g_cona, g_conb, g_conc = (col(g_conics, j) for j in range(3))
    W = world_view[:3, :3]
    e = _ewa(_view_point(means, world_view), W, focal_x, focal_y, tan_fov_x, tan_fov_y)
    u, v = e.u, e.v

    # The covariance as the forward computes it, then the conic's gradient.
    if cov3d_precomp is not None:
        a, b, c = _cov2d_packed(e, cov3d_precomp)
    else:
        s = scales * frame.scaling_modifier
        (a, b, c), (qn, C, cu, cv, lu, lv) = _cov2d_scales_quats(e, s, quats)
        nq = torch.sqrt(torch.sum(quats * quats, dim=-1) + 1e-12)
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    # conics = (c, -b, a) * inv_det
    d_a = g_conc * inv_det
    d_b = -g_conb * inv_det
    d_c = g_cona * inv_det
    d_inv = g_cona * c - g_conb * b + g_conc * a
    d_det = torch.where(det_ok, -d_inv * inv_det * inv_det, zero)
    d_a = d_a + d_det * c
    d_c = d_c + d_det * a
    d_b = d_b - 2.0 * b * d_det

    d_scales = d_quats = d_cov = None
    if cov3d_precomp is not None:
        xx, xy, xz, yy, yz, zz = (cov3d_precomp[:, i] for i in range(6))
        S = ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))
        su = tuple(S[j][0] * u[0] + S[j][1] * u[1] + S[j][2] * u[2] for j in range(3))
        sv = tuple(S[j][0] * v[0] + S[j][1] * v[1] + S[j][2] * v[2] for j in range(3))
        d_u = tuple(2.0 * d_a * su[j] + d_b * sv[j] for j in range(3))
        d_v = tuple(2.0 * d_c * sv[j] + d_b * su[j] for j in range(3))

        def d_entry(p, q):
            if p == q:
                return d_a * u[p] * u[p] + d_b * u[p] * v[p] + d_c * v[p] * v[p]
            return (2.0 * d_a * u[p] * u[q] + d_b * (u[p] * v[q] + u[q] * v[p])
                    + 2.0 * d_c * v[p] * v[q])

        d_cov = torch.stack(
            [d_entry(p, q) for p, q in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))], -1
        )
    else:
        d_lu = tuple(2.0 * d_a * lu[i] + d_b * lv[i] for i in range(3))
        d_lv = tuple(2.0 * d_c * lv[i] + d_b * lu[i] for i in range(3))
        d_scales = torch.stack(
            [(d_lu[i] * cu[i] + d_lv[i] * cv[i]) * frame.scaling_modifier for i in range(3)],
            -1,
        )
        d_u = tuple(sum(s[:, i] * C[i][j] * d_lu[i] for i in range(3)) for j in range(3))
        d_v = tuple(sum(s[:, i] * C[i][j] * d_lv[i] for i in range(3)) for j in range(3))
        dC = [[s[:, i] * (d_lu[i] * u[j] + d_lv[i] * v[j]) for j in range(3)] for i in range(3)]
        w, x, y, z = qn.unbind(-1)
        d_qn = torch.stack([
            2.0 * (z * dC[0][1] - y * dC[0][2] - z * dC[1][0] + x * dC[1][2] + y * dC[2][0]
                   - x * dC[2][1]),
            2.0 * (y * dC[0][1] + z * dC[0][2] + y * dC[1][0] - 2.0 * x * dC[1][1]
                   + w * dC[1][2] + z * dC[2][0] - w * dC[2][1] - 2.0 * x * dC[2][2]),
            2.0 * (-2.0 * y * dC[0][0] + x * dC[0][1] - w * dC[0][2] + x * dC[1][0]
                   + z * dC[1][2] + w * dC[2][0] + z * dC[2][1] - 2.0 * y * dC[2][2]),
            2.0 * (-2.0 * z * dC[0][0] + w * dC[0][1] + x * dC[0][2] - w * dC[1][0]
                   - 2.0 * z * dC[1][1] + y * dC[1][2] + x * dC[2][0] + y * dC[2][1]),
        ], -1)
        # qn = q / nq:  dq = dqn / nq - q (dqn . q) / nq^3
        proj = torch.sum(d_qn * quats, dim=-1) / (nq * nq * nq)
        d_quats = d_qn / nq[:, None] - quats * proj[:, None]

    # JW's rows back to the view point t (_ewa), then to the means.
    d_a1 = sum(d_u[j] * W[0, j] for j in range(3))
    d_b1 = sum(d_u[j] * W[2, j] for j in range(3))
    d_a2 = sum(d_v[j] * W[1, j] for j in range(3))
    d_b2 = sum(d_v[j] * W[2, j] for j in range(3))
    (tx, ty), iz2 = e.txy, e.inv_z * e.inv_z
    d_inv_z = (focal_x * d_a1 + focal_y * d_a2 + 2.0 * d_b1 * -focal_x * tx * e.inv_z
               + 2.0 * d_b2 * -focal_y * ty * e.inv_z)
    d_tx = -focal_x * d_b1 * iz2
    d_ty = -focal_y * d_b2 * iz2
    d_tz = -d_inv_z * iz2 + d_tx * e.clamped[0] + d_ty * e.clamped[1]
    (r0, r1), lims = e.ratio, (1.3 * tan_fov_x, 1.3 * tan_fov_y)
    d_r0 = torch.where((r0 >= -lims[0]) & (r0 <= lims[0]), d_tx * e.tz, zero)
    d_r1 = torch.where((r1 >= -lims[1]) & (r1 <= lims[1]), d_ty * e.tz, zero)
    d_tz = d_tz - (d_r0 * r0 + d_r1 * r1) / e.tz
    d_t = torch.stack(
        [d_r0 / e.tz, d_r1 / e.tz, torch.where(e.in_front, d_tz, zero) + col(g_depths)], -1
    )

    # means2d = ((p_hom * rw + 1) * size - 1) / 2
    p_hom, pw_ok, rw = _clip_point(means, full_proj)
    d_ndc0 = col(g_means2d, 0) * (0.5 * frame.img_width)
    d_ndc1 = col(g_means2d, 1) * (0.5 * frame.img_height)
    d_rw = d_ndc0 * p_hom[:, 0] + d_ndc1 * p_hom[:, 1]
    d_pw = torch.where(pw_ok, -d_rw * rw * rw, zero)
    d_clip = torch.stack([d_ndc0 * rw, d_ndc1 * rw, zero, d_pw], -1)
    d_means = d_t @ W + d_clip @ full_proj[:, :3]

    d_sh = None if sh_coeffs is None else torch.zeros_like(sh_coeffs)
    if sh_coeffs is not None and g_colors is not None:
        deg = frame.sh_degree
        ncoef = (deg + 1) ** 2
        dirs, norm = _view_dirs(means, camera_center)
        basis = sh_basis(deg, dirs)
        sh = sh_coeffs[:, :ncoef, :]
        raw = torch.einsum("nkc,nk->nc", sh, basis) + 0.5
        g = torch.where(raw >= 0.0, g_colors, torch.zeros_like(raw))
        d_sh[:, :ncoef, :] = basis[:, :, None] * g[:, None, :]
        d_dirs = sh_basis_vjp(deg, dirs, torch.einsum("nkc,nc->nk", sh, g))
        dot = torch.sum(d_dirs * dirs, dim=-1, keepdim=True)
        d_means = d_means + (d_dirs - dirs * dot) / norm

    valid = e.in_front & det_ok
    if alive is not None:
        valid = valid & alive
    d_opacities = torch.where(valid, col(g_opacities), zero)
    return d_means, d_scales, d_quats, d_opacities, d_sh, d_cov


def _f32(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected float32 {list(shape)}, got {t.dtype} "
                         f"{list(t.shape)}")
    return t.contiguous()


def _kernel_inputs(means, scales, quats, sh_coeffs, cov3d_precomp, alive, world_view,
                   full_proj, camera_center, frame: Frame):
    """The inputs both kernels read, checked and contiguous (scales and
    quats None with cov3d_precomp), then the scalars: (n, k, deg, width,
    height, fx, fy, limx, limy, scaling_modifier) as host doubles, which
    ctypes rounds to float32 as torch rounds a Python scalar."""
    dev = means.device
    n = means.shape[0]
    if any(t is not None and t.device != dev for t in (
            scales, quats, sh_coeffs, cov3d_precomp, alive, world_view, full_proj,
            camera_center)):
        raise ValueError("project_gaussians: all tensors must be on one device")
    means = _f32("means", means, (n, 3))
    if cov3d_precomp is not None:
        cov3d_precomp = _f32("cov3d_precomp", cov3d_precomp, (n, 6))
        scales = quats = None
    else:
        scales = _f32("scales", scales, (n, 3))
        quats = _f32("quats", quats, (n, 4))
    k = 0 if sh_coeffs is None else sh_coeffs.shape[1]
    deg = frame.sh_degree
    if sh_coeffs is not None:
        sh_coeffs = _f32("sh_coeffs", sh_coeffs, (n, k, 3))
        if k not in KERNEL_SH_COEFFS or (deg + 1) ** 2 > k:
            raise ValueError(f"project_gaussians: {k} SH coefficients at degree {deg}")
    if alive is not None:
        if alive.dtype != torch.bool or alive.shape != (n,):
            raise ValueError(f"alive: expected bool [{n}]")
        alive = alive.contiguous()
    tensors = (means, scales, quats, sh_coeffs, cov3d_precomp, alive,
               _f32("world_view", world_view, (4, 4)), _f32("full_proj", full_proj, (4, 4)),
               _f32("camera_center", camera_center, (3,)))
    fx, fy = frame.focal
    scalars = (n, k, deg, frame.img_width, frame.img_height, fx, fy,
               1.3 * frame.tan_fov_x, 1.3 * frame.tan_fov_y, frame.scaling_modifier)
    return tensors, scalars


def _ptr(t):
    return None if t is None else t.data_ptr()


def _project_forward_cuda(means, scales, quats, opacities, sh_coeffs, cov3d_precomp, alive,
                          mean2d_offset, world_view, full_proj, camera_center, frame):
    dev = means.device
    n = means.shape[0]
    tensors, scalars = _kernel_inputs(means, scales, quats, sh_coeffs, cov3d_precomp, alive,
                                      world_view, full_proj, camera_center, frame)
    means, scales, quats, sh_coeffs, cov3d_precomp, alive = tensors[:6]
    if opacities.device != dev or (mean2d_offset is not None and mean2d_offset.device != dev):
        raise ValueError("project_gaussians: all tensors must be on one device")
    opacities = _f32("opacities", opacities, (n,))
    if mean2d_offset is not None:
        mean2d_offset = _f32("mean2d_offset", mean2d_offset, (n, 2))
    f32, i32 = torch.float32, torch.int32
    means2d = torch.empty((n, 2), dtype=f32, device=dev)
    depths = torch.empty((n,), dtype=f32, device=dev)
    conics = torch.empty((n, 3), dtype=f32, device=dev)
    opac = torch.empty((n,), dtype=f32, device=dev)
    colors = None if sh_coeffs is None else torch.empty((n, 3), dtype=f32, device=dev)
    radii = torch.empty((n,), dtype=i32, device=dev)
    radii_xy = torch.empty((n, 2), dtype=i32, device=dev)
    cull = torch.empty((n, 3), dtype=f32, device=dev)
    lib = kernels.load("projection", _SIGNATURES)
    with kernels.on_device(dev):
        err = lib.sgt_project_fwd(
            means.data_ptr(), _ptr(scales), _ptr(quats), opacities.data_ptr(),
            _ptr(sh_coeffs), _ptr(cov3d_precomp), _ptr(alive), _ptr(mean2d_offset),
            *(t.data_ptr() for t in tensors[6:]), *scalars,
            means2d.data_ptr(), depths.data_ptr(), conics.data_ptr(), opac.data_ptr(),
            _ptr(colors), radii.data_ptr(), radii_xy.data_ptr(), cull.data_ptr(),
            kernels.current_stream(dev),
        )
    kernels.check(lib, err, "sgt_project_fwd")
    LAUNCHES.add(key="fwd")
    return means2d, depths, conics, opac, colors, radii, radii_xy, cull


def _cotangent(g):
    """A cotangent [N] or [N, c] whose last dimension is contiguous (a copy
    where it is not), or None. The caller holds it until the launch: a copy
    freed before then goes back to the allocator, whose next block of that
    size would overwrite it."""
    if g is None:
        return None
    if g.dtype != torch.float32:
        raise ValueError(f"projection cotangent: expected float32, got {g.dtype}")
    if g.dim() == 2 and g.stride(1) != 1:
        g = g.contiguous()
    return g


def _project_backward_cuda(means, scales, quats, sh_coeffs, cov3d_precomp, alive, world_view,
                           full_proj, camera_center, frame, g_means2d, g_depths, g_conics,
                           g_opacities, g_colors, needs=(True,) * 6):
    """The backward kernel; `needs` says which of the six gradients
    (means, scales, quats, opacities, sh_coeffs, cov3d_precomp) to write."""
    dev = means.device
    n = means.shape[0]
    tensors, scalars = _kernel_inputs(means, scales, quats, sh_coeffs, cov3d_precomp, alive,
                                      world_view, full_proj, camera_center, frame)
    k, cov = scalars[1], cov3d_precomp is not None

    def out(want, shape):
        return torch.empty(shape, dtype=torch.float32, device=dev) if want else None

    grads = (out(needs[0], (n, 3)), out(needs[1] and not cov, (n, 3)),
             out(needs[2] and not cov, (n, 4)), out(needs[3], (n,)),
             out(needs[4] and k > 0, (n, k, 3)), out(needs[5] and cov, (n, 6)))
    cots = [_cotangent(g) for g in (g_means2d, g_depths, g_conics, g_opacities,
                                    g_colors if k else None)]
    cot_args = [x for g in cots
                for x in ((None, 0) if g is None else (g.data_ptr(), g.stride(0)))]
    lib = kernels.load("projection", _SIGNATURES)
    with kernels.on_device(dev):
        err = lib.sgt_project_bwd(
            *(_ptr(t) for t in tensors), *scalars,
            *cot_args, *(_ptr(g) for g in grads),
            kernels.current_stream(dev),
        )
    kernels.check(lib, err, "sgt_project_bwd")
    LAUNCHES.add(key="bwd")
    return grads


class ProjectFunction(torch.autograd.Function):
    """The projection as one autograd node: outputs (means2d, depths,
    conics, opacities, colors or None, radii, radii_xy, cull_ellipse); the
    last three carry no gradient. Gradients reach means, scales, quats,
    opacities, sh_coeffs, cov3d_precomp and mean2d_offset (its gradient is
    the means2d cotangent). CUDA tensors take the two kernels, CPU tensors
    the plain versions; another device raises."""

    @staticmethod
    def forward(ctx, means, scales, quats, opacities, sh_coeffs, cov3d_precomp, mean2d_offset,
                alive, world_view, full_proj, camera_center, frame: Frame):
        kind = means.device.type
        if kind == "cuda":
            outs = _project_forward_cuda(
                means, scales, quats, opacities, sh_coeffs, cov3d_precomp, alive,
                mean2d_offset, world_view, full_proj, camera_center, frame)
        elif kind == "cpu":
            p = project_forward_plain(
                means, scales, quats, opacities, world_view, full_proj, camera_center, frame,
                sh_coeffs=sh_coeffs, cov3d_precomp=cov3d_precomp, alive=alive,
                mean2d_offset=mean2d_offset)
            outs = (p.means2d, p.depths, p.conics, p.opacities, p.colors, p.radii,
                    p.radii_xy, p.cull_ellipse)
        else:
            raise ValueError(f"project_gaussians: unsupported device {means.device}")
        ctx.save_for_backward(means, scales, quats, sh_coeffs, cov3d_precomp, alive,
                              world_view, full_proj, camera_center)
        ctx.frame = frame
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*outs[5:])
        return outs

    @staticmethod
    def backward(ctx, g_means2d, g_depths, g_conics, g_opacities, g_colors, *_):
        (means, scales, quats, sh_coeffs, cov3d_precomp, alive, world_view, full_proj,
         camera_center) = ctx.saved_tensors
        need = ctx.needs_input_grad
        args = (means, scales, quats, sh_coeffs, cov3d_precomp, alive, world_view, full_proj,
                camera_center, ctx.frame, g_means2d, g_depths, g_conics, g_opacities, g_colors)
        if means.device.type == "cuda":
            grads = _project_backward_cuda(*args, needs=need[:6])
        else:
            grads = project_backward_plain(*args)
        grads = [g if want else None for g, want in zip(grads, need[:6])]
        d_offset = None
        if need[6]:
            d_offset = torch.zeros_like(means[:, :2]) if g_means2d is None else g_means2d
        return (*grads, d_offset, None, None, None, None, None)


def project_gaussians(
    means: torch.Tensor,  # [N, 3]
    scales: torch.Tensor,  # [N, 3] (activated)
    quats: torch.Tensor,  # [N, 4] (raw)
    opacities: torch.Tensor,  # [N] (activated)
    world_view: torch.Tensor,  # [4, 4]
    full_proj: torch.Tensor,  # [4, 4]
    camera_center: torch.Tensor,  # [3]
    img_width: int,
    img_height: int,
    tan_fov_x: float,
    tan_fov_y: float,
    *,
    sh_coeffs: Optional[torch.Tensor] = None,  # [N, K, 3]
    sh_degree: int = 3,
    override_color: Optional[torch.Tensor] = None,  # [N, C]
    cov3d_precomp: Optional[torch.Tensor] = None,  # [N, 6] packed
    scaling_modifier: float = 1.0,
    alive: Optional[torch.Tensor] = None,  # [N] bool
    mean2d_offset: Optional[torch.Tensor] = None,  # [N, 2] zeros; its gradient
    # is dL/dmean2D, which densification accumulates
) -> ProjectedGaussians:
    """Project all Gaussians to screen space. Culled entries get radius 0
    and opacity 0 (no compaction: downstream stages treat them uniformly).
    An override colour is passed through untouched."""
    if override_color is None:
        assert sh_coeffs is not None
    else:
        sh_coeffs = None
    frame = Frame(img_width, img_height, tan_fov_x, tan_fov_y, sh_degree, scaling_modifier)
    means2d, depths, conics, opac, colors, radii, radii_xy, cull = ProjectFunction.apply(
        means, scales, quats, opacities, sh_coeffs, cov3d_precomp, mean2d_offset, alive,
        world_view, full_proj, camera_center, frame,
    )
    return ProjectedGaussians(
        means2d=means2d,
        depths=depths,
        conics=conics,
        opacities=opac,
        colors=override_color if override_color is not None else colors,
        radii=radii,
        radii_xy=radii_xy,
        cull_ellipse=cull,
    )


def mark_visible(
    means: torch.Tensor, world_view: torch.Tensor, full_proj: torch.Tensor
) -> torch.Tensor:
    """[N] bool frustum visibility, the reference rasterizer's markVisible:
    in front of the near plane (view z > NEAR_CULL_Z) and inside a loose
    +/-1.3 NDC box."""
    p_view = means @ world_view[:3, :3].T + world_view[:3, 3]
    p_hom = means @ full_proj[:3, :3].T + full_proj[:3, 3]
    p_w = means @ full_proj[3, :3] + full_proj[3, 3]
    rw = 1.0 / torch.where(p_w.abs() > 1e-7, p_w, torch.full_like(p_w, 1e-7))
    ndc = p_hom * rw[:, None]
    in_front = p_view[:, 2] > NEAR_CULL_Z
    in_box = (ndc[:, 0].abs() < 1.3) & (ndc[:, 1].abs() < 1.3)
    return in_front & in_box

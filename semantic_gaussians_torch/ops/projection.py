"""Per-Gaussian projection ("preprocess"), vectorized torch.

Port of semantic_gaussians_tpu.ops.projection (XLA there, plain torch here),
differentiated by autograd: EWA projection with near cull at view z <= 0.2, the 1.3*tan
FOV clamp, +0.3 px low-pass, eigenvalue floor 0.1, radius = ceil(3*sigma),
per-axis opacity-aware rect extents (`radii_xy`) and the normalized support
quadratic (`cull_ellipse`) that drives the exact tile-ellipse pair cull.
The arithmetic keeps the JAX package's evaluation order term for term.

Dead padded and culled Gaussians flow through the same math, so every
division and square root that reaches the rendered outputs has a safe
operand (tz, det, p_w and the SH direction norm): `torch.where` alone does
not stop a NaN gradient, since the unselected branch's inf still gives
0 * inf. The radii and the cull quadratic feed only integer binning and
carry no gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.sh import eval_sh
from ..utils.transforms import normalize_quat

NEAR_CULL_Z = 0.2
LOWPASS = 0.3
EIG_FLOOR = 0.1


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


def _ewa_rows(means, world_view, focal_x, focal_y, tan_fov_x, tan_fov_y):
    """The two rows u, v of JW as per-component (N,) tensors."""
    W = world_view[:3, :3]
    t = means @ W.T + world_view[:3, 3]
    one = torch.ones((), dtype=t.dtype, device=t.device)
    tz = torch.where(t[:, 2] > NEAR_CULL_Z, t[:, 2], one)
    limx = 1.3 * tan_fov_x
    limy = 1.3 * tan_fov_y
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    a1 = focal_x * inv_z
    b1 = -focal_x * tx * inv_z * inv_z
    a2 = focal_y * inv_z
    b2 = -focal_y * ty * inv_z * inv_z
    u = tuple(a1 * W[0, j] + b1 * W[2, j] for j in range(3))
    v = tuple(a2 * W[1, j] + b2 * W[2, j] for j in range(3))
    return u, v


def compute_cov2d(means, cov3d6, world_view, focal_x, focal_y, tan_fov_x, tan_fov_y):
    """EWA projection of packed 3D covariances (xx, xy, xz, yy, yz, zz) to
    2D: returns [N, 3] (a, b, c)."""
    u, v = _ewa_rows(means, world_view, focal_x, focal_y, tan_fov_x, tan_fov_y)
    xx, xy, xz, yy, yz, zz = (cov3d6[:, i] for i in range(6))

    def quad(p, q):
        return (
            xx * p[0] * q[0]
            + yy * p[1] * q[1]
            + zz * p[2] * q[2]
            + xy * (p[0] * q[1] + p[1] * q[0])
            + xz * (p[0] * q[2] + p[2] * q[0])
            + yz * (p[1] * q[2] + p[2] * q[1])
        )

    a = quad(u, u) + LOWPASS
    b = quad(u, v)
    c = quad(v, v) + LOWPASS
    return torch.stack([a, b, c], dim=-1)


def compute_cov2d_from_scales_quats(
    means, scales, quats, world_view, focal_x, focal_y, tan_fov_x, tan_fov_y
):
    """Fused EWA path: with L = R diag(s), a = |L^T u|^2, b = (L^T u).(L^T v),
    c = |L^T v|^2, all per-component arithmetic."""
    u, v = _ewa_rows(means, world_view, focal_x, focal_y, tan_fov_x, tan_fov_y)
    q = normalize_quat(quats)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    C = (
        (1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)),
        (2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)),
        (2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)),
    )
    s0, s1, s2 = scales[:, 0], scales[:, 1], scales[:, 2]

    def ltdot(p):  # (L^T p)_i = s_i * (col_i . p)
        return tuple(
            s * (C[i][0] * p[0] + C[i][1] * p[1] + C[i][2] * p[2])
            for i, s in enumerate((s0, s1, s2))
        )

    lu, lv = ltdot(u), ltdot(v)
    a = lu[0] * lu[0] + lu[1] * lu[1] + lu[2] * lu[2] + LOWPASS
    b = lu[0] * lv[0] + lu[1] * lv[1] + lu[2] * lv[2]
    c = lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2] + LOWPASS
    return torch.stack([a, b, c], dim=-1)


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
    and opacity 0 (no compaction: downstream stages treat them uniformly)."""
    focal_x = img_width / (2.0 * tan_fov_x)
    focal_y = img_height / (2.0 * tan_fov_y)

    p_view = means @ world_view[:3, :3].T + world_view[:3, 3]
    depths = p_view[:, 2]
    in_front = depths > NEAR_CULL_Z

    p_hom = means @ full_proj[:3, :3].T + full_proj[:3, 3]
    p_w = means @ full_proj[3, :3] + full_proj[3, 3]
    p_w_safe = torch.where(p_w.abs() > 1e-6, p_w, torch.full_like(p_w, 1e-6))
    rw = 1.0 / (p_w_safe + 1e-7)
    ndc = p_hom * rw[:, None]
    means2d = torch.stack(
        [
            ((ndc[:, 0] + 1.0) * img_width - 1.0) * 0.5,
            ((ndc[:, 1] + 1.0) * img_height - 1.0) * 0.5,
        ],
        dim=-1,
    )
    if mean2d_offset is not None:
        means2d = means2d + mean2d_offset

    if cov3d_precomp is not None:
        cov2d = compute_cov2d(
            means, cov3d_precomp, world_view, focal_x, focal_y, tan_fov_x, tan_fov_y
        )
    else:
        cov2d = compute_cov2d_from_scales_quats(
            means, scales * scaling_modifier, quats, world_view,
            focal_x, focal_y, tan_fov_x, tan_fov_y,
        )
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=EIG_FLOOR))
    lambda_max = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda_max, min=0.0)))

    valid = in_front & det_ok
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

    if override_color is not None:
        colors = override_color
    else:
        assert sh_coeffs is not None
        dirs = means - camera_center[None, :]
        dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-20)
        raw = eval_sh(sh_degree, sh_coeffs.transpose(-1, -2), dirs) + 0.5
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

"""Real spherical-harmonics evaluation (degrees 0-4).

Port of semantic_gaussians_tpu.utils.sh: the PlenOctree convention shared by
all 3DGS implementations, evaluated as one basis build + one contraction.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit directions -> [..., (deg+1)**2] basis values."""
    assert 0 <= deg <= 4
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = [C0 * torch.ones_like(x)]
    if deg > 0:
        cols += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if deg > 2:
        cols += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    if deg > 3:
        cols += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3.0 * xx - yy),
            C4[2] * xy * (7.0 * zz - 1.0),
            C4[3] * yz * (7.0 * zz - 3.0),
            C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            C4[5] * xz * (7.0 * zz - 3.0),
            C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            C4[7] * xz * (xx - 3.0 * yy),
            C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(cols, dim=-1)


def sh_basis_vjp(deg: int, dirs: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of sh_basis(deg, dirs) with respect to dirs [..., 3],
    given the basis' cotangent g [..., (deg+1)**2]: each column's partial
    derivatives in x, y, z, written out (csrc/projection.cu has the same
    terms)."""
    assert 0 <= deg <= 4
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    dx, dy, dz = (torch.zeros_like(x) for _ in range(3))
    if deg > 0:
        dx = dx - C1 * g[..., 3]
        dy = dy - C1 * g[..., 1]
        dz = dz + C1 * g[..., 2]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        dx = dx + (C2[0] * y * g[..., 4] - 2.0 * C2[2] * x * g[..., 6]
                   + C2[3] * z * g[..., 7] + 2.0 * C2[4] * x * g[..., 8])
        dy = dy + (C2[0] * x * g[..., 4] + C2[1] * z * g[..., 5]
                   - 2.0 * C2[2] * y * g[..., 6] - 2.0 * C2[4] * y * g[..., 8])
        dz = dz + C2[1] * y * g[..., 5] + 4.0 * C2[2] * z * g[..., 6] + C2[3] * x * g[..., 7]
    if deg > 2:
        dx = dx + (C3[0] * 6.0 * xy * g[..., 9] + C3[1] * yz * g[..., 10]
                   - C3[2] * 2.0 * xy * g[..., 11] - C3[3] * 6.0 * xz * g[..., 12]
                   + C3[4] * (4.0 * zz - 3.0 * xx - yy) * g[..., 13]
                   + C3[5] * 2.0 * xz * g[..., 14] + C3[6] * (3.0 * xx - 3.0 * yy) * g[..., 15])
        dy = dy + (C3[0] * (3.0 * xx - 3.0 * yy) * g[..., 9] + C3[1] * xz * g[..., 10]
                   + C3[2] * (4.0 * zz - xx - 3.0 * yy) * g[..., 11]
                   - C3[3] * 6.0 * yz * g[..., 12] - C3[4] * 2.0 * xy * g[..., 13]
                   - C3[5] * 2.0 * yz * g[..., 14] - C3[6] * 6.0 * xy * g[..., 15])
        dz = dz + (C3[1] * xy * g[..., 10] + C3[2] * 8.0 * yz * g[..., 11]
                   + C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * g[..., 12]
                   + C3[4] * 8.0 * xz * g[..., 13] + C3[5] * (xx - yy) * g[..., 14])
    if deg > 3:
        xyz = xy * z
        dx = dx + (C4[0] * y * (3.0 * xx - yy) * g[..., 16] + C4[1] * 6.0 * xyz * g[..., 17]
                   + C4[2] * y * (7.0 * zz - 1.0) * g[..., 18]
                   + C4[5] * z * (7.0 * zz - 3.0) * g[..., 21]
                   + C4[6] * 2.0 * x * (7.0 * zz - 1.0) * g[..., 22]
                   + C4[7] * z * (3.0 * xx - 3.0 * yy) * g[..., 23]
                   + C4[8] * 4.0 * x * (xx - 3.0 * yy) * g[..., 24])
        dy = dy + (C4[0] * x * (xx - 3.0 * yy) * g[..., 16]
                   + C4[1] * z * (3.0 * xx - 3.0 * yy) * g[..., 17]
                   + C4[2] * x * (7.0 * zz - 1.0) * g[..., 18]
                   + C4[3] * z * (7.0 * zz - 3.0) * g[..., 19]
                   - C4[6] * 2.0 * y * (7.0 * zz - 1.0) * g[..., 22]
                   - C4[7] * 6.0 * xyz * g[..., 23]
                   + C4[8] * 4.0 * y * (yy - 3.0 * xx) * g[..., 24])
        dz = dz + (C4[1] * y * (3.0 * xx - yy) * g[..., 17] + C4[2] * 14.0 * xyz * g[..., 18]
                   + C4[3] * y * (21.0 * zz - 3.0) * g[..., 19]
                   + C4[4] * z * (140.0 * zz - 60.0) * g[..., 20]
                   + C4[5] * x * (21.0 * zz - 3.0) * g[..., 21]
                   + C4[6] * 14.0 * z * (xx - yy) * g[..., 22]
                   + C4[7] * x * (xx - 3.0 * yy) * g[..., 23])
    return torch.stack([dx, dy, dz], dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """color[..., C] = sum_k basis_k(dir) * sh[..., C, k]."""
    coeff = num_sh_coeffs(deg)
    assert sh.shape[-1] >= coeff
    basis = sh_basis(deg, dirs)
    return torch.einsum("...ck,...k->...c", sh[..., :coeff], basis)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5

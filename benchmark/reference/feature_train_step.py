"""Plain-PyTorch reference of the Feature 3DGS training step.

Feature 3DGS: Zhou et al., "Feature 3DGS: Supercharging 3D Gaussian
Splatting to Enable Distilled Feature Fields", CVPR 2024, arXiv 2312.03203
(code: github.com/ShijieZhou-UCLA/feature-3dgs). Every Gaussian i carries,
besides its 3DGS leaves, a learned feature f_i in R^D. The feature is
rendered with the colour's own alpha-blending weights in the same pass as
the colour,

    F(p) = sum_i f_i alpha_i prod_{j<i} (1 - alpha_j),

here one composite of the [N, 3 + D] columns (SH colour, then f) through
the reference rasterizer (`render.py`, its gradient recomputed block by
block). The loss is

    L = (1 - lambda_dssim) L1(rgb) + lambda_dssim (1 - SSIM(rgb))
        + lambda_feature mean |F - F_t|,

F_t the 2D teacher's map of the view (float16 maps are upcast), and Adam
(torch.optim.Adam's update, eps 1e-15) trains every leaf: the 3DGS leaves
at the official rates (`train_step.learning_rates`), f at
`semantic_feature_lr`.

Departures from the Feature 3DGS code, as the benchmark's configuration
runs it:
- no speed-up module: f has the teacher's full D (512 for LSeg) and no
  1x1 convolution lifts a narrower render to D;
- the teacher map is at the image's size; Feature 3DGS interpolates the
  rendered map bilinearly to the teacher's (LSeg's output size) instead;
- the rasterizer is this benchmark's reference of the program's (16x32
  tiles, the exact tile cull, 3DGS's alpha rules), not Feature 3DGS's
  CUDA rasterizer; the feature channels get no background, as there.

Nothing here imports the program. Arithmetic is in `dtype` (float32 the
reference, bfloat16 the control); matmuls never use TF32.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import render as R
from . import train_step as RT

FIELDS = RT.FIELDS + ("features",)


def render_joint(params: Dict[str, torch.Tensor], cam: Dict, sh_degree: int,
                 bg: torch.Tensor):
    """(rgb [H, W, 3], feature [H, W, D]) of one view, composited
    together; differentiable in every leaf."""
    proj = R.project(params, cam, sh_degree)
    bins = R.Binning(proj, cam["width"], cam["height"])
    colors = torch.cat([proj["colors"], params["features"]], 1)
    bg_all = torch.cat([bg, bg.new_zeros(params["features"].shape[1])]).to(colors.dtype)
    img = R._Composite.apply(proj["means2d"], proj["conic"], proj["opac"], colors, bg_all, bins)
    return img[..., :3], img[..., 3:]


def loss_fn(rgb, gt, feat, teacher, hyper: Dict) -> torch.Tensor:
    photo = RT.photometric_loss(rgb, gt, hyper["lambda_dssim"])
    return photo + hyper["lambda_feature"] * (feat - teacher.to(feat.dtype)).abs().mean()


def learning_rates(hyper: Dict, extent: float, step: int) -> Dict[str, float]:
    return dict(RT.learning_rates(hyper, extent, step), features=hyper["semantic_feature_lr"])


def follow(params0: Dict[str, torch.Tensor], cams: List[Dict], images: List[torch.Tensor],
           teachers: List[torch.Tensor], hyper: Dict, extent: float, first_step: int,
           sh_degree: int, dtype=torch.float32) -> Dict:
    """len(cams) steps of training from `params0` with fresh Adam moments,
    the k-th on cams[k] against images[k] and teachers[k]; the step
    counter (which sets the position's rate) starts at `first_step`.
    Returns each step's loss, the first step's gradient norm by leaf, and
    after all the steps the norm by leaf of Adam's first moment and of the
    change of the parameters."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(params0, cams, images, teachers, hyper, extent, first_step, sh_degree,
                       dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _follow(params0, cams, images, teachers, hyper, extent, first_step, sh_degree, dtype):
    p = {k: params0[k].detach().to(dtype) for k in FIELDS}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    bg = torch.zeros(3, dtype=dtype, device=p["means"].device)
    b1, b2, eps = 0.9, 0.999, 1e-15
    losses, g1 = [], None
    for k, (cam, gt, teacher) in enumerate(zip(cams, images, teachers)):
        leaves = {f: p[f].clone().requires_grad_(True) for f in FIELDS}
        rgb, feat = render_joint(leaves, cam, sh_degree, bg)
        loss = loss_fn(rgb, gt.to(dtype), feat, teacher, hyper)
        grads = dict(zip(FIELDS, torch.autograd.grad(loss, [leaves[f] for f in FIELDS])))
        del leaves, rgb, feat
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = RT.norms(grads)
        lrs = learning_rates(hyper, extent, first_step + k)
        t = k + 1
        with torch.no_grad():
            for f in FIELDS:
                g = grads[f]
                m[f] = b1 * m[f] + (1 - b1) * g
                v2[f] = b2 * v2[f] + (1 - b2) * g * g
                mh = m[f] / (1 - b1 ** t)
                vh = v2[f] / (1 - b2 ** t)
                p[f] = p[f] - lrs[f] * mh / (torch.sqrt(vh) + eps)
        del grads
    change = RT.norms({f: p[f].double() - params0[f].double() for f in FIELDS})
    return dict(losses=losses, grad_norms=g1, moment_norms=RT.norms(m), change_norms=change)

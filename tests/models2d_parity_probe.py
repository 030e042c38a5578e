"""How far the port's 2D towers are from the JAX package's, stage by stage.

Run from the repository root:  JAX_PLATFORMS=cpu python tests/models2d_parity_probe.py

The weights and inputs of tests/test_torch_{clip,sam,automask,lseg}.py
(tiny configs, seeded), carried from the port to the JAX package
(`state_dict()` -> the JAX converters). Prints, per output, the largest
|port - JAX| and that over the JAX output's largest magnitude. The tests
gate these at their tolerances; this prints where each one stands.
"""
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from semantic_gaussians_tpu.models import automask as jam  # noqa: E402
from semantic_gaussians_tpu.models import clip_text as jct  # noqa: E402
from semantic_gaussians_tpu.models import clip_vision as jcv  # noqa: E402
from semantic_gaussians_tpu.models import lseg as jls  # noqa: E402
from semantic_gaussians_tpu.models import sam as jsam  # noqa: E402
from semantic_gaussians_torch.models import automask as tam  # noqa: E402
from semantic_gaussians_torch.models import clip_text as tct  # noqa: E402
from semantic_gaussians_torch.models import clip_vision as tcv  # noqa: E402
from semantic_gaussians_torch.models import lseg as tls  # noqa: E402
from semantic_gaussians_torch.models.common import random_init_  # noqa: E402
from test_torch_automask import port_sam  # noqa: E402
from test_torch_lseg import CFG as LSEG_CFG  # noqa: E402


def dev(port, jax_out):
    a = np.asarray(port.detach().numpy() if isinstance(port, torch.Tensor) else port, np.float64)
    b = np.asarray(jax_out, np.float64)
    d = float(np.abs(a - b).max())
    return {"max_abs": d, "of_max": d / max(float(np.abs(b).max()), 1e-30)}


def main():
    rng = np.random.default_rng(0)
    out = {}
    with torch.no_grad():
        kw = dict(vocab_size=1000, width=64, layers=3, heads=4, embed_dim=32)
        tower = random_init_(tct.CLIPTextTower(**kw), seed=1)
        ids = np.zeros((3, 77), np.int64)
        for i, n in enumerate((5, 12, 30)):
            ids[i, 0], ids[i, 1:n], ids[i, n] = 998, rng.integers(1, 998, n - 1), 999
        params = jct.params_from_torch_state_dict(
            {k: v.numpy() for k, v in tower.state_dict().items()})
        out["clip_text"] = dev(tower(torch.from_numpy(ids)),
                               jct.CLIPTextTower(**kw).apply(params, ids.astype(np.int32)))

        vkw = dict(image_size=16, patch=8, width=12, layers=2, heads=2, embed_dim=6)
        vis = random_init_(tcv.CLIPVisionTower(**vkw), seed=7)
        x = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
        vp = jcv.params_from_torch_state_dict(
            {"visual." + k: v for k, v in vis.state_dict().items()}, jcv.CLIPVisionTower(**vkw))
        out["clip_vision"] = dev(
            tcv.CLIPImageEncoder(vis, device="cpu").encode_image(x),
            jcv.JaxCLIPImageEncoder(tower=jcv.CLIPVisionTower(**vkw), params=vp).encode_image(x))

        cfg = jsam.SamConfig.tiny()
        model = port_sam(4)
        var = jsam.params_from_sam_state_dict(model.state_dict(), cfg)
        jm = jsam.Sam(cfg)
        img = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
        pts = rng.uniform(0, 64, (5, 1, 2)).astype(np.float32)
        lbl = np.ones((5, 1), np.int32)
        emb = model.encode_image(torch.from_numpy(img))
        jemb = jm.apply(var, jnp.asarray(img), method=jsam.Sam.encode_image)
        masks, iou = model.predict_points(emb[0], torch.from_numpy(pts), torch.from_numpy(lbl))
        jmasks, jiou = jm.apply(var, jemb[0], jnp.asarray(pts), jnp.asarray(lbl),
                                method=jsam.Sam.predict_points)
        out["sam_embedding"] = dev(emb, jemb)
        out["sam_mask_logits"] = dev(masks, jmasks)
        out["sam_iou"] = dev(iou, jiou)

        for h, w in ((484, 648), (968, 1296)):
            rh, rw = round(h * 1024 / max(h, w)), round(w * 1024 / max(h, w))
            low = rng.normal(size=(2, 3, 256, 256)).astype(np.float32)
            want = jax.image.scale_and_translate(
                jnp.asarray(low), (2, 3, h, w), (2, 3), jnp.array([4.0 * h / rh, 4.0 * w / rw]),
                jnp.zeros(2), method="linear", antialias=False)
            got = tam.resample_logits(torch.from_numpy(low), (h, w), (rh, rw))
            d = dev(got, want)
            d["sign_flips"] = int(((got.numpy() > 0) != (np.asarray(want) > 0)).sum())
            out[f"amg_resample_{h}x{w}"] = d

        net = random_init_(tls.LSegNet(tls.LSegConfig(**LSEG_CFG)), seed=2, std=0.05).eval()
        lv = jls.params_from_lseg_state_dict({k: v.numpy() for k, v in net.state_dict().items()},
                                             jls.LSegConfig(**LSEG_CFG))
        x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
        out["lseg_net"] = dev(net(torch.from_numpy(x)),
                              jax.jit(jls.LSegNet(jls.LSegConfig(**LSEG_CFG)).apply)(
                                  lv, jnp.asarray(x)))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

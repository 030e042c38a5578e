"""Where the second distill step's gradients of the two packages part, and why.

Run from the repository root:  JAX_PLATFORMS=cpu python tests/distill_grad_probe.py

The scene, items and seeds of tests/test_torch_distill.py (MinkUNet14A,
56 -> 16, 5 cm voxels, a 256-voxel budget, augmentation on). One distill
step by the JAX package (jitted, as `train_distill` runs it) from its
initial weights; then, at the weights after that step and on the second
item of `train_distill`'s draws, the gradients of the training loss by:
the JAX package jitted, the JAX package eagerly (jax.disable_jit), the
JAX package jitted with each ReLU's sign mask sent to the host, the port
in float32, and the port in float64 (the reference). Prints, for the
leaves where they part most, each one's largest deviation from float64
over the leaf's largest magnitude; the ReLU entries whose sign differs
from float64's (semantic_gaussians_torch/tools/relu_flips.py); and the
jitted JAX gradients against the port in float64 run through JAX's own
ReLU masks. The eager JAX call takes minutes on one CPU.
"""
import pathlib
import sys
import tempfile
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from semantic_gaussians_tpu.data.feature_dataset import FeatureDataset  # noqa: E402
from semantic_gaussians_tpu.io.ply import save_gaussian_ply  # noqa: E402
from semantic_gaussians_tpu.pipelines import distill as jd  # noqa: E402
from semantic_gaussians_torch.models.unet3d import (  # noqa: E402
    GRID_MAX, build_topology, mink_unet, unet_state_from_flax, unet_state_to_flax,
)
from semantic_gaussians_torch.pipelines.fusion import save_fused_features  # noqa: E402
from semantic_gaussians_torch.tools.relu_flips import relu_calls, sign_flips  # noqa: E402
from semantic_gaussians_torch.utils.losses import cosine_distill_loss  # noqa: E402
from torch_port_common import jax_params, scene_arrays  # noqa: E402

N, CAP, EMB, BUDGET = 300, 512, 16, 256


def main():
    tmp = pathlib.Path(tempfile.mkdtemp())
    arrays, _ = scene_arrays(n=N, seed=54)
    pad = {k: np.concatenate([v, np.zeros((CAP - N,) + v.shape[1:], v.dtype)])
           for k, v in arrays.items()}
    save_gaussian_ply(tmp / "m.ply", jax_params(pad), np.arange(CAP) < N)
    rng = np.random.default_rng(55)
    feats = rng.normal(size=(CAP, EMB)).astype(np.float32)
    save_fused_features(tmp / "0.pt", feats, (np.arange(CAP) < N) & (rng.uniform(size=CAP) < 0.8))
    ds = FeatureDataset([str(tmp / "m.ply")], [str(tmp / "0.pt")], voxel_size=0.05,
                        voxel_budget=BUDGET)
    cfg = jd.DistillConfig(model_3d="MinkUNet14A", feature_dim=EMB, in_channels=56, epochs=3)
    model, variables, tx, opt_state = jd.make_distill_state(cfg, BUDGET, 1, 0)

    draws, items = np.random.default_rng(0), []  # train_distill's draws
    for _ in range(2):
        draws.permutation(1)
        item = ds.__getitem__(0, seed=int(draws.integers(1 << 31)))
        hi = max(1, min(100, GRID_MAX - int(item.coords.max())))
        items.append((item, item.coords + draws.integers(0, hi, size=(1, 3)).astype(np.int32)))

    def arrays_of(item, coords):
        return [jnp.asarray(a) for a in (coords, item.feats, item.gt, item.gt_mask, item.mask)]

    v1, _, _ = jd.make_distill_step(model, tx, cfg)(variables, opt_state, *arrays_of(*items[0]))
    c, f, g, gm, m = arrays_of(*items[1])
    topo = jd.build_topology(c, m)

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": v1["batch_stats"]}, f, topo,
                             train=True, mutable=["batch_stats"])
        return jd.cosine_distill_loss(out, g, mask=gm)

    t0 = time.perf_counter()
    grads = {"jax jitted": jax.jit(jax.grad(loss_fn))(v1["params"])}
    t1 = time.perf_counter()
    with jax.disable_jit():
        grads["jax eager"] = jax.grad(loss_fn)(v1["params"])
    t2 = time.perf_counter()
    print(f"jitted gradient {t1 - t0:.1f} s (compile included), eager {t2 - t1:.1f} s")
    # the jitted gradient again, each ReLU's sign mask sent to the host
    masks, relu = {}, nn.relu

    def recorded(x, i=[0]):
        jax.debug.callback(lambda m, i=i[0]: masks.__setitem__(i, np.asarray(m)), x > 0)
        i[0] += 1
        return relu(x)

    nn.relu = recorded
    try:
        grads["jax jitted, masks sent out"] = jax.jit(jax.grad(loss_fn))(v1["params"])
    finally:
        nn.relu = relu
    jax_masks = [torch.from_numpy(masks[i]) for i in range(len(masks))]
    item, coords = items[1]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        coords, item.feats, item.gt, item.gt_mask, item.mask)]
    ttopo = build_topology(t[0], t[4])
    pre = {}
    for name, dtype, forced in (("port float32", torch.float32, None),
                                ("port float64", torch.float64, None),
                                ("port float64, jax jitted's masks", torch.float64, jax_masks)):
        net = mink_unet(56, EMB, "MinkUNet14A")
        net.load_state_dict(unet_state_from_flax(jax.tree.map(np.asarray, v1), net))
        net.to(dtype).train()
        with relu_calls(forced) as pre[name]:
            out = net(t[1].to(dtype), ttopo)
        cosine_distill_loss(out, t[2].to(dtype), mask=t[3]).backward()
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(p.grad)
        grads[name] = unet_state_to_flax(net.double())["params"]
    print(f"ReLU calls: jax {len(jax_masks)}, port {len(pre['port float64'])}")
    jax_pre = [m.to(torch.float64) - 0.5 for m in jax_masks]  # the sign is all that counts
    for name, a in (("port float32", pre["port float32"]), ("jax jitted", jax_pre)):
        print(f"ReLU flips of {name} against float64 (call, entries, |float64| over "
              f"the call's max): {sign_flips(a, pre['port float64'])}")
    masked = dict(jax.tree_util.tree_leaves_with_path(
        grads.pop("port float64, jax jitted's masks")))
    print("jax jitted (masks sent out) against port float64 through its masks, worst leaf: "
          + f"{max(float(np.abs(np.asarray(a, np.float64) - masked[p]).max() / np.abs(masked[p]).max()) for p, a in jax.tree_util.tree_leaves_with_path(grads['jax jitted, masks sent out'])):.3g}")

    ref = dict(jax.tree_util.tree_leaves_with_path(grads.pop("port float64")))
    rows = {}
    for name, tree in grads.items():
        for path, a in jax.tree_util.tree_leaves_with_path(tree):
            r = ref[path]
            rows.setdefault(jax.tree_util.keystr(path), {})[name] = float(
                np.abs(np.asarray(a, np.float64) - r).max() / np.abs(r).max())
    worst = sorted(rows.items(), key=lambda kv: -max(kv[1].values()))[:5]
    print("largest |gradient - float64| / leaf max, second step")
    for path, errs in worst:
        print(f"  {path}: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    for name in grads:
        print(f"worst leaf, {name}: {max(e[name] for e in rows.values()):.3g}")


if __name__ == "__main__":
    main()

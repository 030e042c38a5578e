"""Port parity: 3D distillation. The same numpy inputs and files go through
the JAX package (on the CPU) and the port (on the CPU).

Exact: the augmentations, the voxelizer, FeatureDataset items (aug on),
`voxelize_for_net` (its topology bit for bit), packed features and the
checkpoint format both ways. Within 1e-4 x each leaf's largest magnitude:
one distill step (gradients, parameters, batch statistics) from the same
initial weights, and three `train_distill` steps (losses against JAX at
rtol 1e-4, each step's gradients against JAX's at the port's weights, the
final weights against optax replayed; see that test). The losses meet
rtol 1e-6 on their own, the schedules rtol 1e-6."""
import pathlib
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from semantic_gaussians_tpu.core import gaussians as jgauss  # noqa: E402
from semantic_gaussians_tpu.data import augmentation as jaug  # noqa: E402
from semantic_gaussians_tpu.data import feature_dataset as jfd  # noqa: E402
from semantic_gaussians_tpu.data import fusion_utils as jfu  # noqa: E402
from semantic_gaussians_tpu.io.ply import save_gaussian_ply as jax_save_ply  # noqa: E402
from semantic_gaussians_tpu.pipelines import distill as jd  # noqa: E402
from semantic_gaussians_tpu.pipelines import eval_segmentation as jeval  # noqa: E402
from semantic_gaussians_tpu.utils import losses as jloss  # noqa: E402
from semantic_gaussians_tpu.utils import schedules as jsched  # noqa: E402
from semantic_gaussians_torch.cli import distill as distill_cli  # noqa: E402
from semantic_gaussians_torch.config.config import default_config_dir  # noqa: E402
from semantic_gaussians_torch.core import gaussians as tgauss  # noqa: E402
from semantic_gaussians_torch.data import augmentation as taug  # noqa: E402
from semantic_gaussians_torch.data import feature_dataset as tfd  # noqa: E402
from semantic_gaussians_torch.data import fusion_utils as tfu  # noqa: E402
from semantic_gaussians_torch.models.unet3d import (  # noqa: E402
    build_topology, unet_state_from_flax, unet_state_to_flax,
)
from semantic_gaussians_torch.pipelines import distill as td  # noqa: E402
from semantic_gaussians_torch.pipelines import eval_segmentation as teval  # noqa: E402
from semantic_gaussians_torch.pipelines.fusion import save_fused_features  # noqa: E402
from semantic_gaussians_torch.tools.relu_flips import relu_calls, sign_flips  # noqa: E402
from semantic_gaussians_torch.utils import losses as tloss  # noqa: E402
from semantic_gaussians_torch.utils import schedules as tsched  # noqa: E402
from torch_port_common import jax_params, scene_arrays, torch_params  # noqa: E402

N, CAP, EMB, BUDGET = 300, 512, 16, 256
CFG = dict(model_3d="MinkUNet14A", feature_dim=EMB, in_channels=56, epochs=3, voxel_size=0.05)


# ---------------------------------------------------------------- small helpers
def test_losses_match_jax():
    rng = np.random.default_rng(50)
    pred = rng.normal(size=(40, 8)).astype(np.float32)
    target = rng.normal(size=(40, 8)).astype(np.float32)
    target[::5] = 0  # rows without supervision: no NaN gradient
    pred[::7] = 0
    mask = rng.uniform(size=40) < 0.6
    np.testing.assert_allclose(float(tloss.l2_loss(torch.from_numpy(pred), torch.from_numpy(target))),
                               float(jloss.l2_loss(pred, target)), rtol=1e-6)
    for m in (None, mask):
        pt = torch.from_numpy(pred).requires_grad_(True)
        got = tloss.cosine_distill_loss(pt, torch.from_numpy(target),
                                        None if m is None else torch.from_numpy(m))
        got.backward()
        want, wgrad = jax.value_and_grad(
            lambda p: jloss.cosine_distill_loss(p, jnp.asarray(target),
                                                None if m is None else jnp.asarray(m)))(
            jnp.asarray(pred))
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        assert np.isfinite(pt.grad.numpy()).all()
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(wgrad), rtol=1e-5, atol=1e-7)


def test_schedules_match_jax():
    steps = [0, 1, 7, 50, 99, 100, 130]
    for lr_min in (0.0, 1e-5):
        got = tsched.cosine_annealing_schedule(1e-3, 100, lr_min)
        want = jsched.cosine_annealing_schedule(1e-3, 100, lr_min)
        for s in steps:
            np.testing.assert_allclose(float(got(s)), float(want(s)), rtol=1e-6, atol=1e-12)
    got, want = tsched.cosine_decay_schedule(1e-3, 100), optax.cosine_decay_schedule(1e-3, 100)
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(jnp.asarray(s, jnp.int32))), rtol=1e-6,
                                   atol=1e-12)
    assert got(0) == pytest.approx(1e-3) and got(100) == 0.0 == got(130)


def test_gaussian_helpers_match_jax():
    arrays, alive = scene_arrays(n=64, seed=51, dead=9)
    for ft, width in (("all", 56), ("color", 48)):
        got = tgauss.packed_features(torch_params(arrays), torch.from_numpy(alive), ft)
        want = jgauss.packed_features(jax_params(arrays), jnp.asarray(alive), ft)
        assert got.shape == (64, width)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sem, counts = tgauss.create_semantic(100, 12)
    jsem, jcounts = jgauss.create_semantic(100, 12)
    assert sem.shape == jsem.shape and counts.shape == jcounts.shape
    assert not sem.any() and not counts.any()
    params, alive = tgauss.random_init(torch.Generator().manual_seed(0), num_points=500)
    assert int(alive.sum()) == 500 and params.capacity == 4096
    assert float(params.means[:500].abs().max()) <= 1.3


# ---------------------------------------------------------------- data
def _cloud(seed=52, n=2000):
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(n, 3)) * [1.5, 1.0, 0.8]
    feats = rng.uniform(0, 255, size=(n, 6))
    return coords, feats, rng.integers(0, 20, size=n)


@pytest.mark.parametrize("name", ["ElasticDistortion", "RandomHorizontalFlip",
                                  "ChromaticTranslation", "ChromaticAutoContrast",
                                  "ChromaticJitter", "HueSaturationTranslation", "Compose"])
def test_augmentations_match_jax(name):
    coords, feats, labels = _cloud()
    for seed in (0, 3, 11, None):
        def build(mod):
            if name == "Compose":
                return mod.Compose([mod.ElasticDistortion(), mod.RandomHorizontalFlip("z"),
                                    mod.ChromaticJitter(), mod.HueSaturationTranslation()])
            return getattr(mod, name)()
        if seed is None:  # unseeded draws differ; only the shapes are compared
            got = build(taug)(coords, feats.copy(), labels)
            assert got[0].shape == coords.shape and got[1].shape == feats.shape
            continue
        got = build(taug)(coords, feats.copy(), labels, seed=seed)
        want = build(jaug)(coords, feats.copy(), labels, seed=seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_voxelizer_matches_jax(augment):
    coords, feats, labels = _cloud(53, 5000)
    kw = dict(voxel_size=0.05)
    if augment:
        kw.update(use_augmentation=True, scale_augmentation_bound=(0.9, 1.1),
                  rotation_augmentation_bound=((-0.2, 0.2), None, (-np.pi, np.pi)),
                  translation_augmentation_ratio_bound=((-0.1, 0.1), (-0.1, 0.1), (0, 0)))
    got = tfu.Voxelizer(**kw).voxelize(coords, feats, labels, seed=5)
    want = jfu.Voxelizer(**kw).voxelize(coords, feats, labels, seed=5)
    assert len(got[0]) < len(coords)  # some points share a voxel
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if not augment:  # each point's voxel is its floor-quantized coords
        vox = np.floor(coords / 0.05).astype(np.int64)
        np.testing.assert_array_equal(got[0][got[3]], vox - vox.min(0))


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """A 300-Gaussian PLY (written by the JAX package) and its fused
    16-dim features (visited share ~0.8), as a distill scene."""
    tmp = tmp_path_factory.mktemp("torch_distill")
    arrays, alive = scene_arrays(n=N, seed=54)
    pad = {k: np.concatenate([v, np.zeros((CAP - N,) + v.shape[1:], v.dtype)]) for k, v in arrays.items()}
    alive = np.arange(CAP) < N
    ply = tmp / "model" / "point_cloud" / "iteration_7" / "point_cloud.ply"
    jax_save_ply(ply, jax_params(pad), alive)
    rng = np.random.default_rng(55)
    feats = rng.normal(size=(CAP, EMB)).astype(np.float32)
    visited = alive & (rng.uniform(size=CAP) < 0.8)
    fused = tmp / "fusion" / "model" / "0.pt"
    save_fused_features(fused, feats, visited)
    return dict(tmp=tmp, ply=str(ply), fused=str(fused), arrays=arrays)


def _item_equal(got, want):
    for f in ("coords", "feats", "gt", "gt_mask", "mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.num_voxels == want.num_voxels


@pytest.mark.parametrize("aug,budget", [(True, BUDGET), (True, 1024), (False, BUDGET)],
                         ids=["aug_overflow", "aug_fits", "noaug_overflow"])
def test_feature_dataset_items_match_jax(scene_files, aug, budget):
    kw = dict(voxel_size=0.05, aug=aug, voxel_budget=budget)
    ds = tfd.FeatureDataset([scene_files["ply"]], [scene_files["fused"]], **kw)
    ref = jfd.FeatureDataset([scene_files["ply"]], [scene_files["fused"]], **kw)
    for seed in (0, 9, 123456789):
        item = ds.__getitem__(0, seed=seed)
        _item_equal(item, ref.__getitem__(0, seed=seed))
        assert item.coords.shape == (budget, 3) and item.feats.shape == (budget, 56)
        assert item.gt.shape == (budget, EMB) and item.mask.sum() == item.num_voxels
        assert item.gt_mask.sum() > 0 and (item.coords[item.mask] >= 0).all()
        assert (item.num_voxels == budget) == (budget == BUDGET)
    assert len(ds._raw_cache) == 1


@pytest.mark.parametrize("budget", [512, 4096], ids=["overflow", "fits"])
def test_voxelize_for_net_matches_jax(budget):
    """Dense occupancy: at 512 the budget drops voxels and their Gaussians
    get zero features."""
    rng = np.random.default_rng(56)
    locs = rng.uniform(0, 1.0, (3000, 3)).astype(np.float32)
    pf = rng.normal(size=(3000, 8)).astype(np.float32)
    feats_in, topo, inverse, v = teval.voxelize_for_net(locs, pf, 0.05, budget, "cpu")
    jf, jt, jinv, jv = jeval.voxelize_for_net(locs, pf, 0.05, budget)
    assert v == jv and (v == budget) == (budget == 512)
    np.testing.assert_array_equal(feats_in.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(inverse, jinv)
    for tl, jl in zip(topo.levels, jt.levels):
        for f in ("coords", "mask", "nbr", "sorted_keys", "sorted_perm"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)))
    for tl, jl in zip(topo.links, jt.links):
        for f in ("parent_of", "octant"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)))
    vout = rng.normal(size=(budget, 4)).astype(np.float32)
    g = teval.voxel_feats_to_gaussians(vout, inverse, 3000, 3010, num_valid=v).numpy()
    dropped = inverse >= v
    assert dropped.any() == (budget == 512) and not g[:3000][dropped].any()


# ---------------------------------------------------------------- training
def _close_to_leaf_max(got, want, what, rel=1e-4):
    for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want)):
        b = got
        for k in path:
            b = b[k.key]
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(b - a).max())
        assert err <= rel * scale, f"{what} {jax.tree_util.keystr(path)}: {err} vs max {scale}"


def _from_jax_weights(variables, make_state=td.make_distill_state):
    """make_distill_state, with the model holding JAX's weights."""
    def make(*args, **kw):
        model, opt, schedule = make_state(*args, **kw)
        model.load_state_dict(unet_state_from_flax(jax.tree.map(np.asarray, variables), model))
        return model, opt, schedule
    return make


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's initial distill state (MinkUNet14A, 56 -> 16),
    built once: its eager init is the costliest call of this file."""
    cfg = jd.DistillConfig(**CFG)
    return cfg, jd.make_distill_state(cfg, BUDGET, 1, 0)


def _tree(model, tensors):
    """{parameter name: tensor} (gradients, optimizer moments) as the JAX
    variables tree, through the model's own converter."""
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(tensors[k])
        tree = unet_state_to_flax(model)["params"]
        model.load_state_dict(saved)
    return tree


def _leaves(tree, want):
    """(path, got leaf, want leaf) over JAX's tree."""
    for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want)):
        b = tree
        for k in path:
            b = b[k.key]
        yield jax.tree_util.keystr(path), np.asarray(b), a


def _check_adamw_params(got, want, quiet, bound, lr=1e-3):
    """Parameters after AdamW against JAX's: within 1e-4 x each leaf's
    largest magnitude at every entry whose gradient stands above the
    float32 noise of the two packages' sums. An entry whose gradient is
    within 100 x Adam's eps (1e-8) of zero (`quiet`) takes a step
    lr g / (|g| + eps) that a 1e-9 difference in g moves by a few percent
    of lr; such an entry must stay within `bound` x lr of JAX's."""
    n_quiet = 0
    for path, b, a in _leaves(got, want):
        err = np.abs(b - a)
        q = quiet[path]
        far = err > 1e-4 * np.abs(a).max()
        assert not (far & ~q).any(), f"params {path}: {err[~q].max()} vs max {np.abs(a).max()}"
        assert err.max() <= bound * lr, path
        n_quiet += int((far & q).sum())
    return n_quiet


def test_distill_step_matches_jax(scene_files, jax_state):
    """One step on an augmented item: the loss, the gradients, the
    parameters after the AdamW update and the running batch statistics."""
    cfg, (model, variables, tx, opt_state) = jax_state
    ds = jfd.FeatureDataset([scene_files["ply"]], [scene_files["fused"]], voxel_size=0.05,
                            voxel_budget=BUDGET)
    item = ds.__getitem__(0, seed=4)
    coords = item.coords + np.int32(3)
    new_vars, new_opt, loss = jd.make_distill_step(model, tx, cfg)(
        variables, opt_state, jnp.asarray(coords), jnp.asarray(item.feats), jnp.asarray(item.gt),
        jnp.asarray(item.gt_mask), jnp.asarray(item.mask))
    jgrads = jax.tree.map(lambda m: np.asarray(m) / 0.1, new_opt[0].mu)  # mu = (1 - b1) g

    tcfg = td.DistillConfig(**CFG)
    tmodel, opt, schedule = _from_jax_weights(variables)(tcfg, 1, 0, device="cpu")
    step = td.make_distill_step(tmodel, opt, schedule, tcfg)
    got = step(*td.item_tensors(item, coords, "cpu"))
    assert abs(float(got) - float(loss)) <= 1e-4 * abs(float(loss))
    grads = _tree(tmodel, {k: p.grad for k, p in tmodel.named_parameters()})
    _close_to_leaf_max(grads, jgrads, "grads")
    quiet = {path: np.abs(a) < 100 * 1e-8 for path, _, a in _leaves(grads, jgrads)}
    tree = unet_state_to_flax(tmodel)
    n_quiet = _check_adamw_params(tree["params"], new_vars["params"], quiet, bound=2)
    assert n_quiet < 1e-4 * sum(a.size for a in jax.tree.leaves(jgrads))
    _close_to_leaf_max(tree["batch_stats"], new_vars["batch_stats"], "batch stats")
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3)  # schedule(0)


def _jax_gradient_fn(model, monkeypatch):
    """JAX's jitted gradients of the training loss at given variables on
    one item, and each ReLU's sign mask, sent to the host from inside the
    same jitted call (flax.linen.relu, which the JAX UNet calls, is
    wrapped for the test). Returns grads(variables, c, f, g, gm, m) ->
    (gradient tree, masks as bool tensors in call order)."""
    masks, relu = {}, nn.relu

    def recorded(x, calls=[0]):
        i = calls[0]
        calls[0] += 1
        jax.debug.callback(lambda s, i=i: masks.__setitem__(i, np.array(s)), x > 0)
        return relu(x)

    monkeypatch.setattr(nn, "relu", recorded)

    @jax.jit
    def grad_fn(params, batch_stats, c, f, g, gm, m):
        topo = jd.build_topology(c, m)

        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": batch_stats}, f, topo, train=True,
                                 mutable=["batch_stats"])
            return jloss.cosine_distill_loss(out, g, mask=gm)
        return jax.grad(loss_fn)(params)

    def grads(variables, *tensors):
        masks.clear()
        recorded.__defaults__[0][0] = 0  # a retrace numbers the calls from 0 again
        out = grad_fn(variables["params"], variables["batch_stats"],
                      *[jnp.asarray(t.numpy()) for t in tensors])
        jax.block_until_ready(out)
        jax.effects_barrier()
        return out, [torch.from_numpy(masks[i]) for i in range(len(masks))]

    return grads


def _port_grads(state, tensors, dtype, masks=None):
    """The port's gradients of the training loss (MinkUNet14A, train mode)
    at a state dict on one item, in `dtype`, through `masks` if given;
    with the ReLU inputs."""
    c, f, g, gm, m = tensors
    net = td.mink_unet(56, EMB, "MinkUNet14A")
    net.load_state_dict(state)
    net.to(dtype).train()
    with relu_calls(masks) as pre:
        out = net(f.to(dtype), build_topology(c, m))
    tloss.cosine_distill_loss(out, g.to(dtype), mask=gm).backward()
    return {k: p.grad.float() for k, p in net.named_parameters()}, pre


def test_train_distill_matches_jax(scene_files, jax_state, monkeypatch):
    """Three epochs of one augmented scene from JAX's initial weights. The
    same numpy draws (permutation, item seed, global shift) give the same
    three items, and the loss sequence follows JAX's within rtol 1e-4.

    Each step's gradients are held against the JAX package's, computed
    (jitted) at the port's weights and item, within 1e-4 x each leaf's
    largest magnitude. Float32 gradients of this net part by up to ~10% of
    a leaf's max where a ReLU pre-activation within rounding of zero lands
    on the other side in one package's sums and not in the other's
    (semantic_gaussians_torch/tools/relu_flips.py; on XLA:CPU the JAX
    package's jitted second step has one such flip,
    tests/distill_grad_probe.py prints it).
    So JAX's gradients are held against the port run in float64 through
    JAX's own ReLU masks, the port's float32 gradients against the port in
    float64 through the port's masks, and the two directly where their
    masks agree; every flip lies within 1e-5 x its call's largest
    magnitude of zero. A three-step AdamW trajectory is not compared
    weight for weight (the first step maps gradient entries near Adam's
    eps, 1e-8, to steps set by rounding noise): the final weights are held
    against optax's adamw (JAX's optimizer) replayed on the port's own
    gradients, within 1e-4 x each leaf's largest magnitude."""
    cfg, state = jax_state
    monkeypatch.setattr(jd, "make_distill_state", lambda *a, **k: state)
    kw = dict(voxel_size=0.05, voxel_budget=BUDGET)
    _, _, want = jd.train_distill(
        jfd.FeatureDataset([scene_files["ply"]], [scene_files["fused"]], **kw), cfg, seed=0)

    records, make_step = [], td.make_distill_step

    def recording(model, opt, schedule, dcfg):
        step = make_step(model, opt, schedule, dcfg)

        def wrapped(*tensors):
            before = {k: v.detach().clone() for k, v in model.state_dict().items()}
            loss = step(*tensors)
            records.append((before, tensors, {k: p.grad.clone() for k, p in model.named_parameters()}))
            return loss
        return wrapped

    monkeypatch.setattr(td, "make_distill_step", recording)
    monkeypatch.setattr(td, "make_distill_state", _from_jax_weights(state[1]))
    model, _, got = td.train_distill(
        tfd.FeatureDataset([scene_files["ply"]], [scene_files["fused"]], **kw),
        td.DistillConfig(**CFG), seed=0, device="cpu")
    assert len(got) == len(want) == len(records) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)

    jax_grads = _jax_gradient_fn(state[0], monkeypatch)
    tx = optax.adamw(optax.cosine_decay_schedule(1e-3, 3), weight_decay=0.01)
    params = jax.tree.map(jnp.asarray, state[1]["params"])
    opt_state = tx.init(params)
    final = {k: v.clone() for k, v in model.state_dict().items()}
    direct = 0
    for before, tensors, grads in records:
        tree = _tree(model, grads)
        again, pre32 = _port_grads(before, tensors, torch.float32)
        assert all(torch.equal(again[k], grads[k]) for k in grads)  # the step's own
        f64, pre64 = _port_grads(before, tensors, torch.float64)
        model.load_state_dict(before)
        jg, jmasks = jax_grads(unet_state_to_flax(model), *tensors)
        assert len(jmasks) == len(pre32) == 25
        masks32 = [x > 0 for x in pre32]
        for signs in (pre32, [mk.double() - 0.5 for mk in jmasks]):
            assert all(fl[2] <= 1e-5 for fl in sign_flips(signs, pre64))
        through_jax, _ = _port_grads(before, tensors, torch.float64, jmasks)
        _close_to_leaf_max(_tree(model, through_jax), jg, "JAX's gradients vs the port's "
                           "float64 through JAX's ReLU masks")
        through_own, _ = _port_grads(before, tensors, torch.float64, masks32)
        _close_to_leaf_max(tree, _tree(model, through_own), "the port's gradients vs its "
                           "float64 through its ReLU masks")
        if all(torch.equal(a, b) for a, b in zip(masks32, jmasks)):
            _close_to_leaf_max(tree, jg, "the port's gradients vs JAX's")
            direct += 1
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, tree), opt_state, params)
        params = optax.apply_updates(params, updates)
    assert direct >= 1
    model.load_state_dict(final)
    _close_to_leaf_max(unet_state_to_flax(model)["params"], params, "weights vs optax replay")


def test_distill_loss_decreases(scene_files):
    """The JAX package's training check (12 epochs, no augmentation), on
    the port alone."""
    ds = tfd.FeatureDataset([scene_files["ply"]], [scene_files["fused"]], voxel_size=0.05,
                            aug=False, voxel_budget=BUDGET)
    _, _, losses = td.train_distill(ds, td.DistillConfig(**dict(CFG, epochs=12)), device="cpu")
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.02, losses


def test_checkpoints_load_across_packages(tmp_path, jax_state):
    """A checkpoint written by the JAX package loads in the port, and one
    written by the port loads in the JAX package, leaf for leaf; the
    reloaded net gives the same eval-mode output."""
    _, (_, variables, _, _) = jax_state
    jpath = tmp_path / "jax" / "model_5.npz"
    jd.save_distill_checkpoint(jpath, variables)
    model = td.load_distill_model(jpath, 56, EMB, "MinkUNet14A", "cpu")
    assert not model.training
    tree = unet_state_to_flax(model)
    for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, variables)):
        b = tree
        for k in path:
            b = b[k.key]
        np.testing.assert_array_equal(b, a)
    tpath = tmp_path / "port" / "model_5.npz"
    td.save_distill_checkpoint(tpath, model)
    back = jd.load_distill_checkpoint(tpath)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = td.load_distill_model(tpath, 56, EMB, "MinkUNet14A", "cpu")
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


def test_eval_render_hook_matches_jax(scene_files, jax_state, tmp_path):
    """The every-N-epoch semantic render: the port's PNG against the JAX
    package's (dense backend) for the same weights and camera, equal on at
    least 99% of the pixels (class ties aside)."""
    from PIL import Image

    from semantic_gaussians_tpu.utils.camera import make_camera as jax_camera
    from semantic_gaussians_torch.utils.camera import make_camera as torch_camera

    cfg, (model, variables, _, _) = jax_state
    text = np.random.default_rng(57).normal(size=(6, EMB)).astype(np.float32)
    args = (np.eye(3), np.zeros(3), 1.3, 0.8, 64, 32)
    kw = dict(voxel_size=0.05, voxel_budget=BUDGET)
    jhook = jd.make_eval_render_hook(scene_files["ply"], [jax_camera(*args)], text,
                                     tmp_path / "jax", cfg, backend="dense", **kw)
    jdir = jhook(2, model, variables)
    path = tmp_path / "ckpt.npz"
    jd.save_distill_checkpoint(path, variables)
    tmodel = td.load_distill_model(path, 56, EMB, "MinkUNet14A", "cpu")
    thook = td.make_eval_render_hook(scene_files["ply"], [torch_camera(*args)], text,
                                     tmp_path / "port", td.DistillConfig(**CFG), device="cpu", **kw)
    tdir = thook(2, tmodel)
    assert pathlib.Path(tdir) == tmp_path / "port" / "semantic" / "2"
    got = np.asarray(Image.open(pathlib.Path(tdir) / "0.png"))
    want = np.asarray(Image.open(pathlib.Path(jdir) / "0.png"))
    assert got.shape == want.shape == (32, 64, 3) and got.max() > 0
    assert (np.abs(got.astype(int) - want.astype(int)).max(-1) <= 1).mean() >= 0.99


# ---------------------------------------------------------------- the CLI
def test_distill_cli_on_cpu(scene_files, tmp_path):
    """`python -m semantic_gaussians_torch.cli.distill --device cpu` on one
    scene: two epochs, a checkpoint each epoch (each loads in the JAX
    package), the eval scene's render at epoch 2."""
    from torch_port_common import write_toy_blender_scene

    escene = tmp_path / "eval_scene"  # no model of its own: the model dir's Gaussians
    write_toy_blender_scene(escene, views=3, w=48, h=32)
    out = tmp_path / "out"
    summary = distill_cli.main([
        str(default_config_dir() / "distill_scannet.yaml"), "--device", "cpu",
        f"model.model_dir={scene_files['tmp'] / 'model'}", "model.load_iteration=-1",
        f"fusion.out_dir={scene_files['tmp'] / 'fusion'}", f"fusion.embedding_dim={EMB}",
        "distill.model_3d=MinkUNet14A", "distill.voxel_size=0.05", f"distill.voxel_budget={BUDGET}",
        "distill.epochs=2", "distill.save_interval=1", "distill.eval_interval=2",
        f"distill.eval_scene={escene}", f"distill.out_dir={out}",
    ])
    assert summary["device"] == "cpu" and summary["steps_per_epoch"] == 1
    assert len(summary["losses"]) == 2 and np.isfinite(summary["losses"]).all()
    assert summary["checkpoints"] == [out / "model_1.npz", out / "model_2.npz"]
    for ck in summary["checkpoints"]:
        tree = jd.load_distill_checkpoint(ck)
        assert tree["params"]["Dense_0"]["kernel"].shape == (96, EMB)
    assert summary["hook_dirs"] == [str(out / "semantic" / "2")]
    assert len(list((out / "semantic" / "2").glob("*.png"))) == 1  # views [::40][:3] of 3
    with pytest.raises(FileNotFoundError, match="no \\(point_cloud.ply, fused .pt\\) pairs"):
        distill_cli.main([str(default_config_dir() / "distill_scannet.yaml"), "--device", "cpu",
                          f"model.model_dir={tmp_path / 'none'}", f"fusion.out_dir={tmp_path}"])

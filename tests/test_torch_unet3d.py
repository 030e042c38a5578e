"""Port parity: the sparse-voxel UNet. The same numpy inputs go through the
JAX package (on the CPU, jitted) and the port (on the CPU), with the same
weights carried across by `unet_state_from_flax`. The topology (neighbour
maps, sorted keys and permutations, parents, octants) is bit-identical;
each layer's forward and backward meets rtol 1e-5 / atol 1e-5 (the JAX
package's own conv test); the whole MinkUNet14A's outputs, updated batch
stats and gradients are within 1e-4 x each leaf's largest magnitude."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_gaussians_tpu.models import unet3d as J
from semantic_gaussians_tpu.utils.losses import cosine_distill_loss as jax_cos_loss
from semantic_gaussians_torch.models import unet3d as T
from semantic_gaussians_torch.utils.losses import cosine_distill_loss
from torch_port_common import np_  # noqa: F401  (sets one torch thread per worker)

RTOL = ATOL = 1e-5
_jit_topology = jax.jit(J.build_topology)


def _pad_coords(coords, cap):
    c = np.zeros((cap, 3), np.int32)
    c[: len(coords)] = coords
    m = np.zeros(cap, bool)
    m[: len(coords)] = True
    return c, m


def _coord_sets():
    rng = np.random.default_rng(40)
    dense = rng.integers(0, 6, size=(150, 3))  # many duplicate parents, all 8 octants
    return {
        "random": _pad_coords(rng.integers(0, 40, size=(200, 3)), 256),
        # the grid's edges: -2 (probes at -3, -4 fall off the grid) and GRID_MAX - 1
        "offgrid_negative": (
            np.array([[-2, 0, 0], [0, 0, 0], [0, 0, 0], [-1, -2, 5], [-2, -1, -1],
                      [J.GRID_MAX - 1, 3, 3], [3, J.GRID_MAX - 1, 0], [1, 1, 1]], np.int32),
            np.array([1, 1, 0, 1, 1, 1, 1, 0], bool)),
        "all_dead": (np.zeros((16, 3), np.int32), np.zeros(16, bool)),
        "dense_duplicates": _pad_coords(dense, 192),
    }


def _topologies(coords, mask):
    jt = _jit_topology(jnp.asarray(coords), jnp.asarray(mask))
    tt = T.build_topology(torch.from_numpy(coords), torch.from_numpy(mask))
    return jt, tt


@pytest.mark.parametrize("name", list(_coord_sets()))
def test_topology_matches_jax(name):
    coords, mask = _coord_sets()[name]
    jt, tt = _topologies(coords, mask)
    assert len(tt.levels) == 5 and len(tt.links) == 4
    assert tt.levels[0].nbr.shape == (125, len(mask)) and tt.levels[1].nbr.shape[0] == 27
    for i, (jl, tl) in enumerate(zip(jt.levels, tt.levels)):
        for f in ("coords", "mask", "nbr", "sorted_keys", "sorted_perm"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                          err_msg=f"level {i} {f}")
    for i, (jl, tl) in enumerate(zip(jt.links, tt.links)):
        for f in ("parent_of", "octant"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                          err_msg=f"link {i} {f}")


def test_neighbor_map_and_parents():
    """The JAX package's own topology checks, on the port."""
    c, m = _pad_coords(np.array([[0, 0, 0], [1, 0, 0], [5, 5, 5]], np.int32), 8)
    nbr = T._build_level(torch.from_numpy(c), torch.from_numpy(m), kernel_size=3).nbr.numpy()
    assert nbr[22, 0] == 1 and nbr[4, 1] == 0 and nbr[13, 2] == 2 and nbr[22, 2] == 8
    assert (nbr[:, 3:] == 8).all()  # padded rows have no neighbours
    c, m = _pad_coords(np.array([[0, 0, 0], [1, 1, 1], [2, 0, 0], [3, 1, 0]], np.int32), 8)
    lvl = T._build_level(torch.from_numpy(c), torch.from_numpy(m))
    pc, pm, link = T._downsample(lvl)
    assert int(pm.sum()) == 2 and {tuple(r) for r in pc[pm].tolist()} == {(0, 0, 0), (1, 0, 0)}
    po, oc = link.parent_of.numpy(), link.octant.numpy()
    assert po[0] == po[1] and po[2] == po[3] and po[0] != po[2] and (po[4:] == 8).all()
    assert oc[0] == 0 and oc[1] == 7
    # a live voxel at the grid edge probing off the grid joins the missing
    # row V, never a dead padding row (whose key is the same sentinel)
    coords = torch.tensor([[-2, 0, 0], [0, 0, 0], [0, 0, 0]], dtype=torch.int32)
    nbr = T._build_level(coords, torch.tensor([True, True, False]), 3).nbr.numpy()
    offs = [tuple(o) for o in T._offsets(3)]
    assert nbr[offs.index((-1, 0, 0)), 0] == 3 and (nbr[:, 2] == 3).all()
    assert not (nbr[:, :2] == 2).any()
    assert nbr[offs.index((0, 0, 0)), 0] == 0 and nbr[offs.index((0, 0, 0)), 1] == 1


def test_validate_coords_raises():
    c, m = _pad_coords(np.array([[0, 0, 0], [J.GRID_MAX, 0, 0]], np.int32), 4)
    with pytest.raises(ValueError, match="int32 key packing"):
        T.build_topology(torch.from_numpy(c), torch.from_numpy(m))
    c[1, 0] = -3
    with pytest.raises(ValueError, match="int32 key packing"):
        T.validate_coords(c, m)
    m[1] = False  # dead rows may hold anything
    T.validate_coords(c, m)


# ---------------------------------------------------------------- layers
@pytest.fixture(scope="module")
def layer_topo():
    coords, mask = _coord_sets()["random"]
    return _topologies(coords, mask)


def _layer_case(name, jt, tt):
    """(flax module, torch module factory, call args for each, input width)."""
    l0, l1 = (jt.levels[0], tt.levels[0]), (jt.levels[1], tt.levels[1])
    link = (jt.links[0], tt.links[0])
    c27 = J._center27_rows(5)
    cases = {
        "SparseConv_k5": (J.SparseConv(6), lambda: T.SparseConv(5, 6, 125), l0, 5),
        "SparseConv_c27": (J.SparseConv(6, rows=jnp.asarray(c27)),
                           lambda: T.SparseConv(5, 6, 27, c27), l0, 5),
        "SparseConv_k3": (J.SparseConv(7), lambda: T.SparseConv(5, 7, 27), l1, 5),
        "SparseConvDown": (J.SparseConvDown(6), lambda: T.SparseConvDown(5, 6), None, 5),
        "SparseConvUp": (J.SparseConvUp(6), lambda: T.SparseConvUp(5, 6), None, 5),
        "BasicBlock_same": (J.BasicBlock(5), lambda: T.BasicBlock(5, 5, 27), l1, 5),
        "BasicBlock_proj": (J.BasicBlock(6), lambda: T.BasicBlock(5, 6, 27), l1, 5),
    }
    jm, tfac, lvl, cin = cases[name]
    if name == "SparseConvDown":
        return jm, tfac, (link[0], jt.levels[1]), (link[1], tt.levels[1]), cin, tt.levels[0].mask
    if name == "SparseConvUp":
        return jm, tfac, (link[0], jt.levels[0]), (link[1], tt.levels[0]), cin, tt.levels[1].mask
    return jm, tfac, (lvl[0],), (lvl[1],), cin, lvl[1].mask


def _compare_tree(got: dict, want, what):
    """Leaves of a port state dict (as the JAX tree) against JAX's."""
    for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want)):
        b = got
        for k in path:
            b = b[k.key]
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", ["SparseConv_k5", "SparseConv_c27", "SparseConv_k3",
                                  "SparseConvDown", "SparseConvUp", "BasicBlock_same",
                                  "BasicBlock_proj"])
def test_layer_matches_jax(layer_topo, name):
    """Forward and backward (input and weight gradients under a random
    cotangent) of one layer, the BasicBlocks in training mode (batch
    statistics, running stats updated)."""
    jt, tt = layer_topo
    jm, tfac, jargs, targs, cin, in_mask = _layer_case(name, jt, tt)
    rng = np.random.default_rng(41)
    v = len(in_mask)
    x = (rng.normal(size=(v, cin)) * in_mask.numpy()[:, None]).astype(np.float32)
    block = name.startswith("BasicBlock")
    kw = {"train": True} if block else {}
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), *jargs, **kw)
    if block:  # BN scale / bias away from their 1 / 0 init
        variables = jax.tree_util.tree_map_with_path(
            lambda p, a: a + 0.3 * jnp.asarray(rng.normal(size=a.shape), jnp.float32)
            if p[0].key == "params" and p[-1].key in ("scale", "bias") else a, variables)

    def f(params, xx):
        vs = dict(variables, params=params)
        if block:
            return jm.apply(vs, xx, *jargs, train=True, mutable=["batch_stats"])
        return jm.apply(vs, xx, *jargs), {}

    (jout, jmut), vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jgp, jgx = vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, jmut)))

    mod = tfac()
    if block:
        mod.load_state_dict(T.unet_state_from_flax(jax.tree.map(np.asarray, variables), mod))
    else:
        with torch.no_grad():
            mod.kernel.copy_(torch.from_numpy(np.array(variables["params"]["kernel"])))
    mod.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mod(xt, *targs)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)
    assert not out.detach().numpy()[~targs[-1].mask.numpy()].any()  # masked rows zero
    if block:
        grads = {k: p.grad for k, p in mod.named_parameters()}
        _compare_tree(_as_flax_tree(mod, grads)["params"], jgp, "grad")
        _compare_tree(T.unet_state_to_flax(mod)["batch_stats"], jmut["batch_stats"], "stats")
    else:
        np.testing.assert_allclose(mod.kernel.grad.numpy(), np.asarray(jgp["kernel"]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_masked_batchnorm_matches_jax(train):
    rng = np.random.default_rng(42)
    x = rng.normal(size=(64, 5)).astype(np.float32) * 3 + 1
    mask = rng.uniform(size=64) < 0.7
    jm = J.MaskedBatchNorm()
    variables = {"params": {"scale": jnp.asarray(rng.uniform(0.5, 2, 5), jnp.float32),
                            "bias": jnp.asarray(rng.normal(size=5), jnp.float32)},
                 "batch_stats": {"mean": jnp.asarray(rng.normal(size=5), jnp.float32),
                                 "var": jnp.asarray(rng.uniform(0.5, 2, 5), jnp.float32)}}

    def f(params, xx):
        return jm.apply(dict(variables, params=params), xx, jnp.asarray(mask), train,
                        mutable=["batch_stats"])

    (jout, jmut), vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jgp, jgx = vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, jmut)))
    mod = T.MaskedBatchNorm(5)
    with torch.no_grad():
        for k in ("scale", "bias"):
            getattr(mod, k).copy_(torch.from_numpy(np.array(variables["params"][k])))
        for k in ("mean", "var"):
            getattr(mod, k).copy_(torch.from_numpy(np.array(variables["batch_stats"][k])))
    mod.train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mod(xt, torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(mod, k).grad.numpy(), np.asarray(jgp[k]),
                                   rtol=RTOL, atol=ATOL)
    for k in ("mean", "var"):  # updated in training mode only
        np.testing.assert_allclose(getattr(mod, k).numpy(), np.asarray(jmut["batch_stats"][k]),
                                   rtol=RTOL, atol=ATOL)
    assert not out.detach().numpy()[~mask].any()


def test_sparse_conv_center_only():
    """Isolated voxels: only the centre tap fires, so the conv is a dense
    per-voxel matmul with the centre kernel."""
    c, m = _pad_coords(np.array([[0, 0, 0], [10, 0, 0], [0, 10, 0]], np.int32), 8)
    lvl = T._build_level(torch.from_numpy(c), torch.from_numpy(m), kernel_size=3)
    conv = T.SparseConv(5, 4, 27)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 5)).astype(np.float32))
    out = conv(x, lvl).detach()
    torch.testing.assert_close(out[:3], (x @ conv.kernel[13]).detach()[:3], rtol=1e-5, atol=1e-5)
    assert not out[3:].any()


# ---------------------------------------------------------------- the whole net
def _as_flax_tree(module, tensors):
    """A {state-dict key: tensor} map (e.g. gradients) as the JAX tree."""
    saved = {k: v.detach().clone() for k, v in module.state_dict().items()}
    with torch.no_grad():
        for k, p in module.named_parameters():
            p.copy_(tensors[k])
        tree = T.unet_state_to_flax(module)
        module.load_state_dict(saved)
    return tree


def _close_to_leaf_max(got, want, what, rel=1e-4):
    for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want)):
        b = got
        for k in path:
            b = b[k.key]
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(b - a).max())
        assert err <= rel * scale, f"{what} {jax.tree_util.keystr(path)}: {err} vs max {scale}"


@pytest.fixture(scope="module")
def unet_case():
    """MinkUNet14A (8 -> 16) on 200 random voxels of a 256 budget: JAX's
    init, and in training and eval mode its output, mutated batch stats and
    the gradients of a cosine loss against random targets."""
    rng = np.random.default_rng(43)
    coords, mask = _pad_coords(rng.integers(0, 40, size=(200, 3)), 256)
    jt, tt = _topologies(coords, mask)
    x = (rng.normal(size=(256, 8)) * mask[:, None]).astype(np.float32)
    gt = rng.normal(size=(256, 16)).astype(np.float32)
    gt_mask = mask & (rng.uniform(size=256) < 0.8)
    model = J.mink_unet(8, 16, "MinkUNet14A")
    variables = jax.jit(lambda xx, t: model.init(jax.random.PRNGKey(0), xx, t))(
        jnp.asarray(x), jt)

    def loss_fn(params, train):
        out, mut = model.apply(dict(variables, params=params), jnp.asarray(x), jt, train=train,
                               mutable=["batch_stats"])
        return jax_cos_loss(out, jnp.asarray(gt), mask=jnp.asarray(gt_mask)), (out, mut)

    want = {}
    for train in (True, False):
        (loss, (out, mut)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True), static_argnums=1)(
            variables["params"], train)
        want[train] = dict(loss=float(loss), out=np.asarray(out), grads=grads,
                           stats=mut["batch_stats"])
    return dict(tt=tt, x=x, gt=gt, gt_mask=gt_mask, mask=mask,
                variables=jax.tree.map(np.asarray, variables), want=want)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unet_matches_jax(unet_case, train):
    c = unet_case
    want = c["want"][train]
    model = T.mink_unet(8, 16, "MinkUNet14A")
    model.load_state_dict(T.unet_state_from_flax(c["variables"], model))
    model.train(train)
    out = model(torch.from_numpy(c["x"]), c["tt"])
    loss = cosine_distill_loss(out, torch.from_numpy(c["gt"]), mask=torch.from_numpy(c["gt_mask"]))
    loss.backward()
    assert abs(float(loss.detach()) - want["loss"]) <= 1e-4 * abs(want["loss"])
    o = out.detach().numpy()
    assert np.abs(o - want["out"]).max() <= 1e-4 * np.abs(want["out"]).max()
    assert np.isfinite(o).all() and not o[~c["mask"]].any() and np.abs(o[c["mask"]]).sum() > 0
    grads = {k: p.grad for k, p in model.named_parameters()}
    _close_to_leaf_max(_as_flax_tree(model, grads)["params"], want["grads"], "grad")
    stats = T.unet_state_to_flax(model)["batch_stats"]
    _close_to_leaf_max(stats, want["stats"], "batch stats")
    moved = any(np.abs(s).sum() > 0 for s in jax.tree.leaves(
        jax.tree.map(lambda a, b: a - b, stats, c["variables"]["batch_stats"])))
    assert moved == train  # running stats move in training mode only


def test_relu_masks_replay_float32_in_float64(unet_case):
    """tools/relu_flips: recording the ReLU inputs leaves the gradients bit
    for bit as they were; float64 run through float32's ReLU masks gives
    float32's gradients within 1e-4 x each leaf's largest magnitude; where
    float32 and float64 differ in sign, the float64 pre-activation lies
    within 1e-5 x its call's largest magnitude of zero; and one mask entry
    forced off does move the gradients."""
    from semantic_gaussians_torch.tools.relu_flips import relu_calls, sign_flips

    c = unet_case

    def grads(dtype, masks=None, record=True):
        model = T.mink_unet(8, 16, "MinkUNet14A")
        model.load_state_dict(T.unet_state_from_flax(c["variables"], model))
        model.to(dtype).train()
        with relu_calls(masks) if record else contextlib.nullcontext([]) as pre:
            out = model(torch.from_numpy(c["x"]).to(dtype), c["tt"])
        cosine_distill_loss(out, torch.from_numpy(c["gt"]).to(dtype),
                            mask=torch.from_numpy(c["gt_mask"])).backward()
        return pre, {k: p.grad.double() for k, p in model.named_parameters()}

    def worst(a, b):
        return max(float((a[k] - b[k]).abs().max() / b[k].abs().max()) for k in b)

    _, plain = grads(torch.float32, record=False)
    pre32, g32 = grads(torch.float32)
    assert len(pre32) == 25  # MinkUNet14A: the stem, 4 + 4 stages, 8 blocks of two
    assert all(torch.equal(g32[k], plain[k]) for k in plain)
    pre64, g64 = grads(torch.float64)
    masks = [x > 0 for x in pre32]
    _, g64m = grads(torch.float64, masks)
    assert worst(g32, g64m) <= 1e-4
    assert all(f[2] <= 1e-5 for f in sign_flips(pre32, pre64))
    deep = masks[len(masks) // 2].clone()
    deep.view(-1)[int(torch.argmax(pre32[len(masks) // 2]))] = False
    _, forced = grads(torch.float64, masks[:len(masks) // 2] + [deep] + masks[len(masks) // 2 + 1:])
    assert worst(forced, g64m) > 1e-6


def test_converter_round_trips_exactly(unet_case):
    variables = unet_case["variables"]
    assert len(variables["params"]) == 27  # MinkUNet14A's top-level Flax names
    model = T.mink_unet(8, 16, "MinkUNet14A")
    model.load_state_dict(T.unet_state_from_flax(variables, model))
    back = T.unet_state_to_flax(model)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want) == len(model.state_dict())
    for path, a in want:
        assert got[path].dtype == np.float32 and got[path].shape == a.shape
        np.testing.assert_array_equal(got[path], a)
    assert back["params"]["Dense_0"]["kernel"].shape == (96, 16)  # Flax's (in, out)
    assert model.head.weight.shape == (16, 96)


def test_mink_unet34a_names_and_init():
    """MinkUNet34A (56 -> 768) has the JAX package's Flax tree, shape for
    shape, and Flax's initial distributions: he_normal conv kernels
    (std sqrt(2 / (K Cin))), lecun_normal dense kernels, zero dense bias,
    BN scale 1 and bias 0."""
    model = T.mink_unet(56, 768, "MinkUNet34A", seed=3)
    tree = T.unet_state_to_flax(model)
    jmodel = J.mink_unet(56, 768, "MinkUNet34A")
    coords, mask = _pad_coords(np.random.default_rng(44).integers(0, 32, size=(64, 3)), 64)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((64, 56)),
                                                _jit_topology(jnp.asarray(coords),
                                                              jnp.asarray(mask))))
    want = {jax.tree_util.keystr(p): s.shape for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(p): a.shape for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want
    stem = tree["params"]["SparseConv_0"]["kernel"]
    assert stem.shape == (125, 56, 32)
    assert abs(stem.std() / np.sqrt(2 / (125 * 56)) - 1) < 0.05 and np.abs(stem).max() <= 2 * np.sqrt(2 / 7000) / 0.8796 + 1e-6
    head = tree["params"]["Dense_0"]
    assert abs(head["kernel"].std() / np.sqrt(1 / 96) - 1) < 0.05 and not head["bias"].any()
    bn = tree["params"]["MaskedBatchNorm_0"]
    assert (bn["scale"] == 1).all() and not bn["bias"].any()
    assert (tree["batch_stats"]["MaskedBatchNorm_0"]["var"] == 1).all()
    again = T.unet_state_to_flax(T.mink_unet(56, 768, "MinkUNet34A", seed=3))
    np.testing.assert_array_equal(again["params"]["SparseConv_0"]["kernel"], stem)

"""Adam's two paths: the one-launch kernel (csrc/adam.cu) and the plain loop.

On the CPU, `adam_update` runs the plain loop whatever the leaves' layout,
the `adam` counter stays where it was, and no output shares memory with an
input; the leaves the kernel is handed are checked there too (`_kernel_rows`:
what it reads in place, what it copies, what it refuses). The `card` tests
hold the kernel against the plain loop bit for bit (`torch.equal` on every
output leaf): the RGB leaves and a 512-wide feature field, capacities that
are not multiples of a block's floats, leaves that are not 16-byte aligned,
gradients laid out as autograd hands them to the train step (rows of a
joined gradient, read where they lie) and column views such as gathering a
sharded state leaves, Adam steps 1, 2 and 10,000 (the bias corrections at
their extremes), zero gradients and gradients so small that the second
moment's update is subnormal; eagerly and in a captured one-step graph
replayed twice on new values. On the card every float32 state takes the
kernel, and anything else raises. This file imports neither JAX nor the JAX
package, so that the card tests run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_adam.py
"""
import dataclasses
import re

import pytest
import torch

from semantic_gaussians_torch.core import optimizer
from semantic_gaussians_torch.core.gaussians import GaussianParams, leaf_names
from semantic_gaussians_torch.core.grouping import CLASSIFIER_EPS, CLASSIFIER_FIELDS, CLASSIFIER_LR
from semantic_gaussians_torch.core.optimizer import (
    ADAM, AdamState, TrainHyper, adam_update, adam_update_with, bias_corrections, lr_tree,
)
from semantic_gaussians_torch.ops import kernels

SHAPES = {"means": (3,), "sh_dc": (1, 3), "sh_rest": (15, 3), "log_scales": (3,),
          "quats": (4,), "opacity_logits": (1,)}
HYPER = TrainHyper()


def _trees(n, dim, dev, seed=0, grads="normal", dtype=torch.float32):
    """(params, grads, mu, nu) of capacity n (with a dim-wide field where dim),
    drawn from `seed`; grads "normal", "tiny" (~1e-20, so that (1 - b2) g^2
    is subnormal) or "zero" (with zero moments too: a slot that densify
    zeroed and no pair reached)."""
    gen = torch.Generator().manual_seed(seed)
    shapes = dict(SHAPES, **({"features": (dim,)} if dim else {}))

    def tree(scale=1.0, positive=False):
        leaves = {f: torch.randn((n,) + s, generator=gen, dtype=dtype) * scale
                  for f, s in shapes.items()}
        return GaussianParams(**{f: (x.abs() if positive else x).to(dev)
                                 for f, x in leaves.items()})

    params, g = tree(), tree()
    scale = {"normal": 1.0, "zero": 0.0, "tiny": 1e-20}[grads]
    g = GaussianParams(**{f: x * scale for f, x in vars(g).items() if x is not None})
    mu, nu = tree(0.1), tree(0.01, positive=True)
    if grads == "zero":
        mu, nu = (GaussianParams(**{f: torch.zeros_like(getattr(t, f)) for f in shapes})
                  for t in (mu, nu))
    return params, g, mu, nu


def _lrs(dev, dim):
    return lr_tree(HYPER, 2.5, torch.full((), 7000, dtype=torch.int32, device=dev),
                   features=bool(dim))


def _plain(grads, state, params, lrs):
    """The plain loop on the same inputs, leaf by leaf: {leaf: (p', m', v')}."""
    bc1, bc2 = bias_corrections(state.count + 1, HYPER)
    return {f: optimizer._adam_plain(*(getattr(t, f) for t in (params, grads, state.mu,
                                                              state.nu, lrs)),
                                     bc1, bc2, HYPER)
            for f in leaf_names(params)}


def _outputs(new_params, new_state):
    return {f: (getattr(new_params, f), getattr(new_state.mu, f), getattr(new_state.nu, f))
            for f in leaf_names(new_params)}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for f in want:
        for name, a, b in zip(("p", "m", "v"), got[f], want[f]):
            assert a.dtype == b.dtype and torch.equal(a, b), f"{f}.{name}"


def _joined(grads):
    """The gradients laid out as autograd hands them to the train step:
    the SH leaves' as slices of one [n, 16, 3] gradient, the field's as the
    columns past 3 of an [n, 3 + D] one (the concatenations' backward);
    besides, opacity's as one column of an [n, 2] one (rows of one float)."""
    sh = torch.cat([grads.sh_dc, grads.sh_rest], dim=1)
    out = dict(vars(grads), sh_dc=sh[:, :1], sh_rest=sh[:, 1:],
               opacity_logits=torch.cat([grads.opacity_logits] * 2, dim=1)[:, :1])
    if grads.features is not None:
        out["features"] = torch.cat([grads.means, grads.features], dim=1)[:, 3:]
    return GaussianParams(**out)


def _views(tree, layout):
    """`tree`'s leaves laid out as `layout`: "contiguous" as they are,
    "offset" contiguous views one float past an allocation's start (not
    16-byte aligned), "columns" non-contiguous column slices."""
    if layout == "contiguous":
        return tree

    def view(x):
        if layout == "offset":
            big = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            big[1:] = x.reshape(-1)
            return big[1:].view(x.shape)
        return torch.cat([x, x], dim=-1)[..., :x.shape[-1]]

    return GaussianParams(**{f: view(getattr(tree, f)) for f in leaf_names(tree)})


def _no_alias(outs, inputs):
    held = [x.untyped_storage().data_ptr() for x in inputs]
    for f, triple in outs.items():
        for x in triple:
            assert x.untyped_storage().data_ptr() not in held, f


def _inputs(n, dim, dev, layout, seed, grads="normal", dtype=torch.float32):
    """(params, grads, mu, nu) laid out as `layout`; "joined" lays out the
    gradients alone, as autograd does (`_joined`)."""
    trees = _trees(n, dim, dev, seed=seed, grads=grads, dtype=dtype)
    if layout == "joined":
        params, g, mu, nu = trees
        return params, _joined(g), mu, nu
    return tuple(_views(t, layout) for t in trees)


CPU_CASES = {  # name: (capacity, field width, layout, grads, Adam count before the step)
    "rgb": (37, 0, "contiguous", "normal", 3),
    "features": (37, 16, "contiguous", "normal", 3),
    "joined_grads": (37, 16, "joined", "normal", 3),
    "offset_views": (37, 16, "offset", "normal", 0),
    "column_views": (37, 16, "columns", "tiny", 9999),
    "zero_grads": (37, 0, "contiguous", "zero", 1),
    "float64": (37, 0, "contiguous", "normal", 3),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_leaves_take_the_plain_loop_and_outputs_alias_no_input(case):
    n, dim, layout, kind, count = CPU_CASES[case]
    dtype = torch.float64 if case == "float64" else torch.float32
    params, grads, mu, nu = _inputs(n, dim, "cpu", layout, 1, kind, dtype)
    state = AdamState(count=torch.tensor(count, dtype=torch.int32), mu=mu, nu=nu)
    lrs = _lrs("cpu", dim)
    inputs = [getattr(t, f) for t in (params, grads, mu, nu) for f in leaf_names(params)]
    kept = [x.clone() for x in inputs]
    before = ADAM.snapshot()
    new_params, new_state = adam_update(grads, state, params, lrs, HYPER)
    assert ADAM.since(before) == (0, {})
    assert int(new_state.count) == count + 1
    got = _outputs(new_params, new_state)
    _assert_equal(got, _plain(grads, state, params, lrs))
    _no_alias(got, inputs)
    for x, y in zip(inputs, kept):  # functional: the inputs are left as they were
        assert torch.equal(x, y)
    if kind == "zero":  # no gradient and no moments: the parameters stay
        for f in leaf_names(params):
            assert torch.equal(getattr(new_params, f), getattr(params, f)), f


def _rows(params, grads, mu, nu, lrs):
    return [tuple(getattr(t, f) for t in (params, grads, mu, nu, lrs))
            for f in leaf_names(params)]


KERNEL_ROW_CASES = {  # name: (layout, {leaf: the gradient's row stride as the kernel reads it})
    "contiguous": ("contiguous", dict(sh_dc=3, sh_rest=45, features=16, opacity_logits=1)),
    "joined_grads": ("joined", dict(sh_dc=48, sh_rest=48, features=19, opacity_logits=2)),
    "offset_views": ("offset", dict(sh_dc=3, sh_rest=45, features=16, opacity_logits=1)),
    "column_views": ("columns", dict(sh_dc=6, sh_rest=45, features=32, opacity_logits=2)),
}


@pytest.mark.parametrize("case", sorted(KERNEL_ROW_CASES))
def test_the_kernel_reads_rows_in_place_and_copies_the_rest(case):
    """`_kernel_rows` hands the kernel p, m and v contiguous and each g with
    contiguous rows: a leaf that already is so is passed as it lies, any
    other a contiguous copy of the same values."""
    layout, strides = KERNEL_ROW_CASES[case]
    cpu = torch.device("cpu")
    params, grads, mu, nu = _inputs(37, 16, cpu, layout, 2)
    rows = _rows(params, grads, mu, nu, _lrs(cpu, 16))
    got = optimizer._kernel_rows(rows, cpu)
    for f, row, kernel_row in zip(leaf_names(params), rows, got):
        *tensors, lr, stride = kernel_row
        assert lr is row[4]
        for name, x, y in zip(("p", "g", "m", "v"), row[:4], tensors):
            assert torch.equal(x, y), f"{f}.{name}"
            rows_ok = (optimizer._row_stride(x) is not None if name == "g"
                       else x.is_contiguous())
            assert (y.data_ptr() == x.data_ptr()) == rows_ok, f"{f}.{name}"
        assert tensors[0].is_contiguous() and tensors[2].is_contiguous()
        assert tensors[3].is_contiguous() and optimizer._row_stride(tensors[1]) == stride
        if f in strides:
            assert stride == strides[f], f


def _bad_rows(case):
    cpu = torch.device("cpu")
    params, grads, mu, nu = _trees(5, 0, cpu, seed=3)
    lrs = _lrs(cpu, 0)
    if case == "float64_leaf":
        grads = dataclasses.replace(grads, quats=grads.quats.double())
    elif case == "shape_mismatch":
        mu = dataclasses.replace(mu, means=mu.means[:4])
    elif case == "scalar_leaf":
        params, grads, mu, nu = (dataclasses.replace(t, opacity_logits=t.opacity_logits[0, 0])
                                 for t in (params, grads, mu, nu))
    elif case == "python_lr":
        lrs = dataclasses.replace(lrs, sh_dc=0.0025)
    elif case == "float64_lr":
        lrs = dataclasses.replace(lrs, means=lrs.means.double())
    elif case == "vector_lr":
        lrs = dataclasses.replace(lrs, quats=lrs.quats.expand(2))
    return _rows(params, grads, mu, nu, lrs)


@pytest.mark.parametrize("case", ["float64_leaf", "shape_mismatch", "scalar_leaf", "python_lr",
                                  "float64_lr", "vector_lr"])
def test_the_kernel_refuses_leaves_it_cannot_update(case):
    with pytest.raises(ValueError, match="adam_update on cpu wants float32"):
        optimizer._kernel_rows(_bad_rows(case), torch.device("cpu"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build_all(["adam"])
    return torch.device("cuda:0")


ROW_CASES = {  # name: (a tensor's shape, the slice of it taken, its row stride or None)
    "contiguous": ((5, 15, 3), (slice(None),), 45),
    "sh_rest_of_joined": ((5, 16, 3), (slice(None), slice(1, None)), 48),
    "sh_dc_of_joined": ((5, 16, 3), (slice(None), slice(0, 1)), 48),
    "field_of_joined": ((5, 515), (slice(None), slice(3, None)), 515),
    "one_column": ((5, 2), (slice(None), slice(0, 1)), 2),
    "one_row": ((1, 7), (slice(None),), 7),
    "flat": ((9,), (slice(None),), 1),
    "every_other_row": ((10, 4), (slice(None, None, 2),), 8),
    "transposed": ((3, 5), (slice(None),), None),
    "column_steps": ((5, 8), (slice(None), slice(None, None, 2)), None),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_a_gradient_s_row_stride_where_its_rows_are_contiguous(case):
    shape, index, want = ROW_CASES[case]
    x = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
    if case == "transposed":
        x = x.T
    assert optimizer._row_stride(x[index]) == want


@pytest.mark.card
@pytest.mark.parametrize("grads", ["normal", "zero", "tiny"])
@pytest.mark.parametrize("count", [0, 1, 9999])
@pytest.mark.parametrize("layout", ["contiguous", "offset", "joined", "columns"])
@pytest.mark.parametrize("n,dim", [(4099, 0), (1001, 512)])
def test_the_kernel_matches_the_plain_loop_bit_for_bit(n, dim, layout, count, grads):
    dev = _card()
    params, g, mu, nu = _inputs(n, dim, dev, layout, count + n, grads)
    state = AdamState(count=torch.full((), count, dtype=torch.int32, device=dev), mu=mu, nu=nu)
    lrs = _lrs(dev, dim)
    inputs = [getattr(t, f) for t in (params, g, mu, nu) for f in leaf_names(params)]
    before = ADAM.snapshot()
    new_params, new_state = adam_update(g, state, params, lrs, HYPER)
    assert ADAM.since(before)[0] == 1
    got = _outputs(new_params, new_state)
    _assert_equal(got, _plain(g, state, params, lrs))
    _no_alias(got, inputs)
    for f, (p, m, v) in got.items():
        assert p.is_contiguous() and m.is_contiguous() and v.is_contiguous(), f


@pytest.mark.card
def test_cuda_column_views_take_the_kernel_bit_for_bit():
    """Parameters, gradients and moments that are column views of wider
    tensors (as gathering a sharded state leaves the moments) take one
    launch, and give the plain loop's outputs bit for bit."""
    dev = _card()
    params, g, mu, nu = _inputs(1001, 512, dev, "columns", 5)
    state = AdamState(count=torch.full((), 4, dtype=torch.int32, device=dev), mu=mu, nu=nu)
    lrs = _lrs(dev, 512)
    before = ADAM.snapshot()
    new_params, new_state = adam_update(g, state, params, lrs, HYPER)
    assert ADAM.since(before)[0] == 1
    _assert_equal(_outputs(new_params, new_state), _plain(g, state, params, lrs))


@pytest.mark.card
def test_cuda_leaves_that_are_not_float32_raise():
    dev = _card()
    params, g, mu, nu = _trees(1001, 0, dev, seed=6, dtype=torch.float64)
    state = AdamState(count=torch.full((), 4, dtype=torch.int32, device=dev), mu=mu, nu=nu)
    before = ADAM.snapshot()
    with pytest.raises(ValueError, match="wants float32 leaves"):
        adam_update(g, state, params, _lrs(dev, 0), HYPER)
    assert ADAM.since(before) == (0, {})


@pytest.mark.card
@pytest.mark.parametrize("dim", [0, 512])
def test_the_kernel_in_a_replayed_graph_reads_each_replay_s_values(dim):
    """One adam_update captured in a CUDA graph on static inputs; two
    replays, each on new parameters, gradients, moments, step and learning
    rates, give the plain loop's outputs on those inputs bit for bit."""
    dev = _card()
    n = 3001
    static = _inputs(n, dim, dev, "joined", 11)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    lrs = _lrs(dev, dim)

    def call():
        params, g, mu, nu = static
        return adam_update(g, AdamState(count=count, mu=mu, nu=nu), params, lrs, HYPER)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ADAM.snapshot()
    with torch.cuda.graph(graph):
        out = call()
    assert ADAM.since(before)[0] == 1  # the capture enqueued one launch
    for replay, (step, lr_scale) in enumerate(((0, 1.0), (9999, 3.0))):
        fresh = _inputs(n, dim, dev, "joined", 20 + replay, "normal" if replay else "tiny")
        for old, new in zip(static, fresh):
            for f in leaf_names(old):
                getattr(old, f).copy_(getattr(new, f))
        count.fill_(step)
        for f in leaf_names(lrs):
            getattr(lrs, f).mul_(lr_scale)
        graph.replay()
        torch.cuda.synchronize()
        params, g, mu, nu = static
        state = AdamState(count=count, mu=mu, nu=nu)
        _assert_equal(_outputs(*out), _plain(g, state, params, lrs))
        assert int(out[1].count) == step + 1


def test_the_kernel_s_table_holds_every_leaf_a_state_may_carry():
    """Every GaussianParams leaf and Gaussian Grouping's classifier (two
    leaves) in one launch."""
    src = (kernels.CSRC / "adam.cu").read_text()
    table = int(re.search(r"constexpr int MAX_LEAVES = (\d+);", src).group(1))
    assert len(dataclasses.fields(GaussianParams)) + len(CLASSIFIER_FIELDS) <= table


def _classifier(dev, seed):
    """Rows (p, g, m, v) of the classifier's two leaves, 256 x 16 and 256,
    the gradients and moments so small (g ~ 1e-9, sqrt(v) ~ 1e-10) that
    eps 1e-8 sets the step."""
    gen = torch.Generator().manual_seed(seed)

    def leaf(shape):
        p, g, m = (torch.randn(shape, generator=gen) * s for s in (1.0, 1e-9, 1e-10))
        v = (torch.randn(shape, generator=gen) * 1e-20).abs()
        return tuple(x.to(dev) for x in (p, g, m, v))

    return dict(zip(CLASSIFIER_FIELDS, (leaf((256, 16)), leaf((256,)))))


def _with_classifier(dev, count, seed):
    """adam_update_with the classifier's two leaves as extra rows (lr 5e-4,
    eps 1e-8) beside a 16-wide field (eps 1e-15) against the plain loop
    leaf by leaf at each leaf's eps: (outputs, plain outputs, launches
    counted). The Gaussians' eps would give the classifier other values."""
    params, g, mu, nu = _inputs(1001, 16, dev, "joined", seed)
    cls = _classifier(dev, seed)
    state = AdamState(count=torch.full((), count, dtype=torch.int32, device=dev), mu=mu, nu=nu)
    lrs = _lrs(dev, 16)
    lr = torch.full((), CLASSIFIER_LR, dtype=torch.float32, device=dev)
    before = ADAM.snapshot()
    new_params, new_state, out = adam_update_with(
        g, state, params, lrs, HYPER, [cls[f] + (lr, CLASSIFIER_EPS) for f in CLASSIFIER_FIELDS])
    launched = ADAM.since(before)[0]
    got = dict(_outputs(new_params, new_state),
               **{f"classifier.{f}": o for f, o in zip(CLASSIFIER_FIELDS, out)})
    bc1, bc2 = bias_corrections(state.count + 1, HYPER)

    def plain(f, eps):
        return optimizer._adam_plain(*cls[f], lr, bc1, bc2, HYPER, eps=eps)

    want = dict(_plain(g, state, params, lrs),
                **{f"classifier.{f}": plain(f, CLASSIFIER_EPS) for f in CLASSIFIER_FIELDS})
    for f in CLASSIFIER_FIELDS:
        assert not torch.equal(plain(f, HYPER.eps)[0], want[f"classifier.{f}"][0]), f
    return got, want, launched


def test_the_classifier_steps_at_its_own_eps_on_the_cpu():
    got, want, launched = _with_classifier(torch.device("cpu"), 3, 31)
    assert launched == 0
    _assert_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("count", [0, 9999])
def test_two_eps_in_one_launch_match_the_plain_loop_bit_for_bit(count):
    """The Gaussians' leaves at eps 1e-15 and the classifier's at 1e-8 in
    one launch of the kernel: every output as the plain loop gives it at
    each leaf's eps."""
    got, want, launched = _with_classifier(_card(), count, 40 + count)
    assert launched == 1
    _assert_equal(got, want)

"""Port parity on the adversarial composite cases
(semantic_gaussians_torch/tools/composite_cases.py, the inputs chip_smoke.py
also feeds both CUDA kernels): the port's plain forward composite against
the JAX Pallas kernel (`composite_pairs`, interpret mode), and its plain
backward against `jax.vjp` of the same, on identical pair buffers.

Tolerances are tests/test_torch_composite.py's: render and final_T at rtol
1e-4, atol 1e-5; depth at 1e-4/1e-4; n_contrib exact; backward rows at atol
1e-4 x each column's largest |value| (the two sum the pixels in different
orders).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from semantic_gaussians_tpu.ops.composite_pallas import (
    CompositeConfig, composite_pairs, pad_pair_cols,
)
from semantic_gaussians_torch.ops.composite import (
    composite_backward_plain, composite_forward_plain,
)
from semantic_gaussians_torch.tools.composite_cases import (
    CHANNEL_EDGES, case_names, composite_cases,
)
from torch_port_common import np_

CASES = {c.name: c for c in composite_cases()}
TOL = dict(render=(1e-4, 1e-5), final_T=(1e-4, 1e-5), depth=(1e-4, 1e-4))


def _jax_inputs(case):
    """(cfg, pair buffer, tile_start, tile_count) for composite_pairs: the
    case's Gaussians gathered into the JAX layout (geometry, colours, depth),
    slots outside every tile range zero."""
    packed = np.concatenate([case.geom[:, :6], case.colors, case.geom[:, 6:7]], axis=1)
    in_pairs = int(case.tile_count.sum())
    raw = np.zeros((case.pair_gaussian.shape[0], packed.shape[1]), np.float32)
    raw[:in_pairs] = packed[case.pair_gaussian[:in_pairs]]
    cfg = CompositeConfig(tile_h=case.tile_h, tile_w=case.tile_w, grid_h=case.grid_h,
                          grid_w=case.grid_w, num_channels=case.num_channels, interpret=True)
    return (cfg, pad_pair_cols(jnp.asarray(raw.T), cfg), jnp.asarray(case.tile_start),
            jnp.asarray(case.tile_count))


def _torch_args(case):
    return tuple(torch.from_numpy(x) for x in (
        case.geom, case.colors, case.pair_gaussian, case.tile_start, case.tile_count, case.bg))


def test_cases_cover_the_edges():
    """The generator yields what its docstring promises: every channel edge,
    ranges around every batch size, early termination, one writer per
    slot, and unique names."""
    names = case_names()
    assert len(names) == len(set(names))
    widths = {c.num_channels for c in CASES.values()}
    assert set(CHANNEL_EDGES) <= widths
    counts = np.concatenate([c.tile_count for c in CASES.values()])
    for edge in (32, 64, 128, 256, 512):
        assert (counts == edge - 1).any() or (counts == edge + 1).any()
        assert (counts > edge).any()
    assert (counts == 0).any() and (counts == 1).any()
    for c in CASES.values():
        ends = c.tile_start + c.tile_count
        assert (c.tile_start[1:] == ends[:-1]).all() and ends[-1] <= c.pair_gaussian.shape[0]
    assert any(c.tile_h * c.tile_w % 128 for c in CASES.values())
    assert any(c.tile_w != 32 for c in CASES.values())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_case_matches_jax_kernel(name):
    case = CASES[name]
    cfg, pairs, ts, tc = _jax_inputs(case)
    want = composite_pairs(cfg, pairs, jnp.asarray(case.bg), ts, tc)
    got = composite_forward_plain(*_torch_args(case), case.grid_w, case.tile_h, case.tile_w)
    names = ("render", "depth", "final_T", "n_contrib")
    want, got = dict(zip(names, want)), dict(zip(names, got))
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(np_(got[k]), np_(want[k]), rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_array_equal(np_(got["n_contrib"]), np_(want["n_contrib"]))
    if name == "early_exit":  # every pixel stops on its third pair
        assert (np_(got["n_contrib"]) == 2).all()
    if name == "last_warp_holds_max":
        nc = np_(got["n_contrib"])[0]
        assert nc.argmax() == nc.size - 1 and (nc[:-32] < nc.max()).all()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_case_matches_jax_vjp(name):
    case = CASES[name]
    cfg, pairs, ts, tc = _jax_inputs(case)
    _, vjp = jax.vjp(lambda pd, b: composite_pairs(cfg, pd, b, ts, tc)[0], pairs,
                     jnp.asarray(case.bg))
    want_pairs, _ = vjp(jnp.asarray(case.g_color))
    in_pairs = int(case.tile_count.sum())
    want = np_(want_pairs)[:6 + case.num_channels, :in_pairs].T

    args = _torch_args(case)
    frame = (case.grid_w, case.tile_h, case.tile_w)
    _, _, final_t, n_contrib = composite_forward_plain(*args, *frame)
    got = composite_backward_plain(*args, torch.from_numpy(case.g_color), final_t, n_contrib,
                                   *frame)
    assert got.shape == (case.pair_gaussian.shape[0], 6 + case.num_channels)
    got = np_(got)[:in_pairs]
    if not in_pairs:
        return
    scale = np.abs(want).max(axis=0) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)

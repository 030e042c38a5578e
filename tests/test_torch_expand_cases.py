"""Port parity on the adversarial expand cases
(semantic_gaussians_torch/tools/expand_cases.py, the inputs chip_smoke.py
also feeds the CUDA kernel): the port's plain expand against the JAX Pallas
kernel (`expand_pairs`, interpret mode), bit for bit, cull on and off.

The out-of-contract case (zero-count Gaussians between emitting ones, which
the JAX kernel's fixed window does not take) is held against the owner's
definition instead.

The JAX kernel takes budgets that are multiples of its 512-slot chunk only.
A case with another budget runs it at the next multiple of 512 with the same
inputs and compares the first `budget` slots: the extra slots lie past
num_pairs (<= budget), and no owner of a slot below the budget changes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from semantic_gaussians_tpu.ops.expand import CHUNK as JAX_CHUNK
from semantic_gaussians_tpu.ops.expand import expand_pairs as jax_expand
from semantic_gaussians_torch.ops.expand import CHUNK, SLOTS_PER_THREAD, expand_pairs
from semantic_gaussians_torch.tools.expand_cases import (
    TILE_H, TILE_W, beyond_contract_case, case_names, expand_cases, margin_forms,
)
from torch_port_common import np_

CASES = {c.name: c for c in expand_cases()}


def _runs(case):
    """(start, end) slot range of each emitting Gaussian's run."""
    k = case.num_dense
    starts = case.offsets[:k].astype(np.int64)
    ends = np.append(starts[1:], case.offsets[k] if k < case.n else np.iinfo(np.int64).max)
    return starts, ends


def test_cases_cover_the_edges():
    """The generator yields what its docstring promises."""
    names = case_names()
    assert len(names) == len(set(names))
    cases = list(CASES.values())
    for c in cases + [beyond_contract_case()]:  # the kernel's wrapper takes C order only
        assert all(a.flags.c_contiguous for a in (c.offsets, c.rect, c.idx, c.cull))
    for c in cases:
        assert c.offsets[0] == 0 and (np.diff(c.offsets) >= 0).all()
        assert c.budget <= 8192 and (c.offsets <= c.budget + 1).all()
        assert c.num_pairs <= c.budget
    starts_mid_run = crosses_chunks = 0
    for c in cases:
        s, e = _runs(c)
        edges = np.arange(CHUNK, c.num_pairs, CHUNK)
        starts_mid_run += int(((s[:, None] < edges) & (e[:, None] > edges)).any())
        crosses_chunks += int((np.minimum(e, c.num_pairs) - s >= 2 * CHUNK).any())
        if c.name == "widest-window":  # chunk 1 spans exactly CHUNK owners
            owners = np.searchsorted(c.offsets, np.arange(CHUNK, 2 * CHUNK), side="right")
            assert np.unique(owners).size == CHUNK
    assert starts_mid_run >= 3 and crosses_chunks >= 1
    overflow = [c for c in cases if c.num_pairs == c.budget and (c.offsets == c.budget + 1).any()]
    assert any(c.budget % SLOTS_PER_THREAD for c in overflow)
    assert any(c.num_pairs == 0 for c in cases)
    assert any(c.num_pairs == c.budget and not (c.offsets > c.budget).any() for c in cases)
    assert any(c.num_pairs % SLOTS_PER_THREAD and c.num_pairs < c.budget for c in cases)
    for m in (SLOTS_PER_THREAD, JAX_CHUNK, CHUNK):
        assert any(c.budget % m for c in cases)
    assert any(c.n == 1 for c in cases)
    widths = np.concatenate([c.rect[:c.num_dense] & 255 for c in cases])
    assert (widths == 1).any() and (widths == cases[0].grid_w).any()
    _, qn = margin_forms()
    margin = np.float32(1.0 + 1e-4)
    assert (qn > margin).any() and (qn == margin).any() and (qn < margin).any()
    assert ((np.abs(qn - margin) / np.spacing(margin)) <= 6).all()
    cull = CASES["cull-edges"].cull
    assert (cull[2] == 0).any() and (cull[4] == 0).any() and (cull[3] == 0).any()
    assert ((cull[2] > 0) & (cull[2] < 1e-20)).any() and ((cull[4] > 0) & (cull[4] < 1e-20)).any()


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_expand_case_matches_jax_kernel(name, cull):
    case = CASES[name]
    grid_kw = dict(ntx=case.grid_w, num_tiles=case.grid_w * case.grid_h, n=case.n,
                   tile_w=TILE_W, tile_h=TILE_H)
    jax_budget = -(-case.budget // JAX_CHUNK) * JAX_CHUNK
    want = jax_expand(
        jnp.asarray(case.offsets), jnp.asarray(case.rect), jnp.asarray(case.idx),
        jnp.asarray(case.cull) if cull else None, jnp.int32(case.num_pairs),
        jnp.int32(case.num_dense), pair_budget=jax_budget, interpret=True, **grid_kw,
    )
    got = expand_pairs(*case.torch_args(cull))
    for a, b, what in zip(want, got, ("tile", "g_key", "gen_owner")):
        assert b.dtype == torch.int32 and b.shape == (case.budget,), what
        np.testing.assert_array_equal(np_(a)[:case.budget], np_(b), err_msg=what)
    if cull and name == "cull-edges":
        # the 13 margin Gaussians' second tiles: culled exactly where qn > margin
        _, qn = margin_forms()
        second = np_(got[0])[case.offsets[:qn.size] + 1]
        np.testing.assert_array_equal(second == grid_kw["num_tiles"], qn > np.float32(1 + 1e-4))


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
def test_plain_expand_beyond_contract_matches_definition(cull):
    case = beyond_contract_case()
    num_tiles = case.grid_w * case.grid_h
    tile, gkey, owner = (np_(t) for t in expand_pairs(*case.torch_args(cull)))
    p = np.arange(case.budget)
    valid = p < case.num_pairs
    o = np.searchsorted(case.offsets, p, side="right") - 1  # the last row with offset <= p
    assert (np.diff(case.offsets) == 0).sum() > case.num_dense // 2
    np.testing.assert_array_equal(owner, np.where(valid, o, case.num_dense))
    r, local = case.rect[o], p - case.offsets[o]
    w = r & 255
    want_tile = ((r >> 8 & 255) + local // w) * case.grid_w + (r >> 16) + local % w
    live = tile < num_tiles
    assert not (live & ~valid).any()
    assert cull or (live == valid).all()
    np.testing.assert_array_equal(tile[live], want_tile[live])
    np.testing.assert_array_equal(gkey[live], case.idx[o][live])
    assert (gkey[~live] == case.n).all() and (tile[~live] == num_tiles).all()

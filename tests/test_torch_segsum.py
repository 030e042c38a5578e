"""Port parity: the contiguous segment sum (plain version) vs the JAX
`segsum_contiguous` on both of its TPU kernels: the whole-accumulator path
and, with `VMEM_ACC_BYTES` forced to 0, the rolling-panel path. The cases
and tolerances are tests/test_segsum.py's. The JAX kernel takes the
cotangent as (D, P); the port as [P, D].

The adversarial cases of tools/summing_cases.py (the ones chip_smoke.py feeds
the kernel on the card) pin the contract: the plain version against a
float64 numpy loop and, where owners step by at most 1, against the JAX
kernel."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import semantic_gaussians_tpu.ops.segsum as segsum_mod
from semantic_gaussians_tpu.ops.segsum import CHUNK
from semantic_gaussians_torch.ops import segsum as port
from semantic_gaussians_torch.ops.segsum import segsum_contiguous, segsum_contiguous_plain
from semantic_gaussians_torch.tools.summing_cases import segsum_cases


def _owners(p, num_rows, rng):
    """Random valid owners: non-decreasing, steps of at most 1."""
    steps = (rng.uniform(size=p) < min(1.0, num_rows / p)).astype(np.int32)
    steps[0] = 0
    return np.minimum(np.cumsum(steps), num_rows - 1).astype(np.int32)


def _straddle_owners():
    """One long segment pinned across the panel kernel's first slide."""
    p = 24 * CHUNK
    ramp = np.arange(p, dtype=np.int32)
    hold_at = segsum_mod.STRIDE - 64
    resume = hold_at + 6 * CHUNK
    owners = np.minimum(ramp, hold_at)
    return np.where(ramp >= resume, hold_at + (ramp - resume), owners).astype(np.int32)


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "random":
        d, p, rows = 11, 4 * CHUNK, 700
        owners = _owners(p, rows, rng)
    elif name == "row_boundary":  # owners end at num_rows - 1, past a 128 boundary
        d, p, rows = 4, 2 * CHUNK, 129
        owners = np.minimum(np.arange(p) // 4, rows - 1).astype(np.int32)
    elif name == "single_owner":
        d, p, rows = 5, 3 * CHUNK, 7
        owners = np.zeros(p, np.int32)
    elif name == "many_slides":
        d, p, rows = 7, 32 * CHUNK, 14000
        owners = _owners(p, rows, rng)
    else:  # straddles_slide
        owners = _straddle_owners()
        d, p, rows = 5, owners.size, int(owners[-1]) + 1
    cot = rng.normal(size=(p, d)).astype(np.float32)
    return cot, owners, rows


# atol: the long pinned segment (3.1k pairs) is summed in another order
# than the JAX kernel's per-chunk partials (tests/test_segsum.py's bound)
TOL = dict(random=(1e-6, 2e-5), row_boundary=(1e-6, 2e-5), single_owner=(1e-5, 1e-5),
           many_slides=(1e-6, 2e-5), straddles_slide=(1e-4, 5e-4))


def _jax_segsum(cot, owners, rows):
    return np.asarray(segsum_mod.segsum_contiguous.__wrapped__(
        jnp.asarray(cot.T), jnp.asarray(owners), rows, interpret=True
    )).T


@pytest.mark.parametrize("path", ["vmem", "panel"])
@pytest.mark.parametrize("name", list(TOL))
def test_plain_segsum_matches_jax(monkeypatch, name, path):
    if path == "panel":
        monkeypatch.setattr(segsum_mod, "VMEM_ACC_BYTES", 0)
    cot, owners, rows = _case(name)
    want = _jax_segsum(cot, owners, rows)
    got = segsum_contiguous(torch.from_numpy(cot), torch.from_numpy(owners), rows)
    assert got.shape == (rows, cot.shape[1])
    rtol, atol = TOL[name]
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_limit_skips_the_tail():
    """Rows at or past `limit` count as zero (the invalid pair slots)."""
    cot, owners, rows = _case("random")
    limit = torch.tensor(1000, dtype=torch.int32)
    got = segsum_contiguous_plain(torch.from_numpy(cot), torch.from_numpy(owners), rows, limit)
    cut = cot.copy()
    cut[1000:] = 0
    want = segsum_contiguous_plain(torch.from_numpy(cut), torch.from_numpy(owners), rows)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


CASES = {c.name: c for c in segsum_cases()}


def _atol(case, floor):
    live = case.owners[:case.limit]
    longest = np.diff(np.flatnonzero(np.r_[True, np.diff(live) != 0, True])).max(initial=0)
    return floor if longest <= 300 else 1e-7 * longest


def _run_plain(case, **kw):
    limit = None if case.limit is None else torch.tensor(case.limit, dtype=torch.int32)
    return segsum_contiguous(
        torch.from_numpy(case.cot), torch.from_numpy(case.owners), case.num_rows, limit, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_adversarial_case_matches_a_float64_loop(name):
    """The wrapper on the CPU (the plain version) against a row-by-row
    float64 loop: rtol 1e-6, atol 1e-5 where the longest run has up to 300
    rows, else 1e-7 a row of it (a float32 sum of L N(0, 1) values)."""
    case = CASES[name]
    want = np.zeros((case.num_rows, case.cot.shape[1]), np.float64)
    live = case.owners.size if case.limit is None else case.limit
    for i in range(live):
        want[case.owners[i]] += case.cot[i]
    got = _run_plain(case)
    assert got.shape == want.shape and got.dtype == torch.float32
    atol = _atol(case, 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)
    unowned = np.setdiff1d(np.arange(case.num_rows), case.owners[:live])
    assert not got.numpy()[unowned].any()  # exactly zero, not merely small


@pytest.mark.parametrize("path", ["vmem", "panel"])
@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.unit_steps and c.owners.size])
def test_adversarial_case_matches_jax(monkeypatch, name, path):
    """Where owners step by at most 1 (what the JAX kernels take): the rows
    past `limit` zeroed and the stream padded with zero rows of the last
    owner to the JAX kernel's multiple of 512. rtol 1e-5, atol 2e-5 (the
    cases above) where the longest run has up to 300 rows, else 1e-7 a row."""
    if path == "panel":
        monkeypatch.setattr(segsum_mod, "VMEM_ACC_BYTES", 0)
    case = CASES[name]
    p, d = case.cot.shape
    padded = -(-p // CHUNK) * CHUNK
    cot = np.zeros((padded, d), np.float32)
    live = p if case.limit is None else case.limit
    cot[:live] = case.cot[:live]
    owners = np.r_[case.owners, np.full(padded - p, case.owners[-1], np.int32)]
    want = _jax_segsum(cot, owners, case.num_rows)
    got = _run_plain(case).numpy()
    atol = _atol(case, 2e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("d", [1, 4, 9, 16, 33, 64, 128, 129, 774])
def test_tile_shape_fits_the_kernel(d):
    """What csrc/segsum.cu checks of the tile shape, and its memory bound."""
    cw, rows, slices = port.tile_shape(d)
    assert 0 < cw <= min(d, port.MAX_PANEL)
    assert slices * (cw if cw % 4 else cw // 4) <= port.THREADS
    assert rows % slices == 0 and (rows // slices) % 4 == 0
    assert rows * cw <= port.GROWN_FLOATS
    panels = -(-d // cw)
    assert panels == 1 or cw % 4 == 0
    assert d - (panels - 1) * cw > 0  # the ragged last panel is not empty


def test_scratch_holds_every_level():
    """Two carries a tile, level after level, down to one tile."""
    d = 4
    _, rows, _ = port.tile_shape(d)
    assert port._scratch_floats(rows, d, rows) == 0  # one tile: no carries
    p = (rows // 2 + 40) * rows + 17
    t0 = -(-p // rows)
    t1 = -(-2 * t0 // rows)
    assert t1 > 1 and 2 * t1 <= rows  # three levels
    pad4 = lambda x: (x + 3) // 4 * 4  # values and owners start 16-byte aligned
    assert port._scratch_floats(p, d, rows) == sum(
        pad4(2 * t * d) + pad4(2 * t) for t in (t0, t1))

"""Port parity: the contiguous segment sum (plain version) vs the JAX
`segsum_contiguous` on both of its TPU kernels: the whole-accumulator path
and, with `VMEM_ACC_BYTES` forced to 0, the rolling-panel path. The cases
and tolerances are tests/test_segsum.py's. The JAX kernel takes the
cotangent as (D, P); the port as [P, D]."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import semantic_gaussians_tpu.ops.segsum as segsum_mod
from semantic_gaussians_tpu.ops.segsum import CHUNK
from semantic_gaussians_torch.ops.segsum import segsum_contiguous, segsum_contiguous_plain


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


@pytest.mark.parametrize("path", ["vmem", "panel"])
@pytest.mark.parametrize("name", list(TOL))
def test_plain_segsum_matches_jax(monkeypatch, name, path):
    if path == "panel":
        monkeypatch.setattr(segsum_mod, "VMEM_ACC_BYTES", 0)
    cot, owners, rows = _case(name)
    want = segsum_mod.segsum_contiguous.__wrapped__(
        jnp.asarray(cot.T), jnp.asarray(owners), rows, interpret=True
    )
    got = segsum_contiguous(torch.from_numpy(cot), torch.from_numpy(owners), rows)
    assert got.shape == (rows, cot.shape[1])
    rtol, atol = TOL[name]
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, rtol=rtol, atol=atol)


def test_limit_skips_the_tail():
    """Rows at or past `limit` count as zero (the invalid pair slots)."""
    cot, owners, rows = _case("random")
    limit = torch.tensor(1000, dtype=torch.int32)
    got = segsum_contiguous_plain(torch.from_numpy(cot), torch.from_numpy(owners), rows, limit)
    cut = cot.copy()
    cut[1000:] = 0
    want = segsum_contiguous_plain(torch.from_numpy(cut), torch.from_numpy(owners), rows)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

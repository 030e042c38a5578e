"""Port parity: the segment-sum probe (kernels 6 and 7 of the port).

The plain version is held against (a) the probe's definition re-stated in
numpy in float64, (b) a JAX run, in Pallas interpret mode, of the body of
tools/exp_panel2.py's `kern_a` (tools/exp_panel.py's `_k_noslide` is the same
body with `static_off` for `mode`), re-written here at a reduced p; the two
tools' `main` run with --scale on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import semantic_gaussians_tpu.ops.segsum as sg
from semantic_gaussians_torch.ops import segsum_probe as sp
from semantic_gaussians_torch.tools import exp_panel, exp_panel2, summing_cases
from torch_port_common import np_

D = 16


def _data(n_chunks, rows, seed=0, shuffle=False):
    """The tools' data law at a reduced p, from the generator that the card
    run shares: cot as the JAX tools lay it out, (d, p), and step owners."""
    cot, owners = summing_cases.probe_data(n_chunks, rows, seed, shuffle)
    return np.ascontiguousarray(cot.T), owners


def _definition(cot_dp, owners, mode):
    """The probe as defined, chunk by chunk, in float64."""
    out = np.zeros((sp.PANEL, D), np.float64)
    blk_w, blk_p, blk_s = sp.WIN // 128, sp.PANEL // 128, sp.STRIDE // 128
    for c in range(len(owners) // sp.CHUNK):
        sl = slice(c * sp.CHUNK, (c + 1) * sp.CHUNK)
        base_blk = int(owners[c * sp.CHUNK]) // 128
        pb_blk = max(0, -((-(base_blk + blk_w - blk_p)) // blk_s)) * blk_s
        off = 0 if mode == "fold" else 128 * (base_blk - pb_blk)
        col = owners[sl].astype(np.int64) - 128 * base_blk
        for j in np.unique(col[(col >= 0) & (col < sp.WIN)]):
            out[off + j] += cot_dp[:, sl][:, col == j].astype(np.float64).sum(axis=1)
    return out


def _jax_probe(cot_dp, owners, mode):
    """tools/exp_panel2.py's `kern_a` and its caller, in interpret mode."""
    CHUNK, WIN, PANEL, STRIDE = sg.CHUNK, sg.WIN, sg.PANEL, sg.STRIDE
    d, p = cot_dp.shape
    owners = jnp.asarray(owners)
    base_blk = owners[::CHUNK] // 128
    blk_w, blk_p, blk_s = WIN // 128, PANEL // 128, STRIDE // 128
    need = base_blk + blk_w - blk_p
    pb_blk = jnp.maximum(0, -((-need) // blk_s)) * blk_s
    scalars = jnp.stack([base_blk, pb_blk]).astype(jnp.int32)

    def kern_a(s_ref, o_ref, cot_ref, out_ref, acc, *, mode):
        c = pl.program_id(0)

        @pl.when(c == 0)
        def _():
            acc[...] = jnp.zeros_like(acc)

        base = s_ref[0, c] * 128
        col = o_ref[...] - base
        onehot_t = (
            col == jax.lax.broadcasted_iota(jnp.int32, (WIN, CHUNK), 0)
        ).astype(jnp.bfloat16)
        partial = sg._onehot_dot(cot_ref[...], onehot_t)  # (d, WIN)
        if mode == "fold":
            acc[:, 0:WIN] = acc[:, 0:WIN] + partial
        else:
            off = (s_ref[0, c] - s_ref[1, c]) * 128
            acc[:, pl.ds(off, WIN)] = acc[:, pl.ds(off, WIN)] + partial

        @pl.when(c == pl.num_programs(0) - 1)
        def _():
            out_ref[...] = acc[...]

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(p // CHUNK,),
        in_specs=[
            pl.BlockSpec((1, CHUNK), lambda i, s: (0, i)),
            pl.BlockSpec((d, CHUNK), lambda i, s: (0, i)),
        ],
        out_specs=pl.BlockSpec((d, PANEL), lambda i, s: (0, 0)),
        scratch_shapes=[pltpu.VMEM((d, PANEL), jnp.float32)],
    )
    f = pl.pallas_call(
        functools.partial(kern_a, mode=mode),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((d, PANEL), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(scalars, owners.reshape(1, p), jnp.asarray(cot_dp)))


def _torch_inputs(cot_dp, owners):
    return torch.from_numpy(np.ascontiguousarray(cot_dp.T)), torch.from_numpy(owners)


def test_constants_are_the_jax_segment_sums():
    assert (sp.CHUNK, sp.WIN, sp.PANEL, sp.STRIDE) == (sg.CHUNK, sg.WIN, sg.PANEL, sg.STRIDE)


@pytest.mark.parametrize("mode", sp.MODES)
@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_plain_matches_the_definition(mode, shuffle):
    """48 chunks over 22,000 rows: the window slides past the panel's end
    several times. Float64 on both sides: 1e-9 of the largest entry."""
    cot, owners = _data(48, 22_000, seed=3, shuffle=shuffle)
    want = _definition(cot, owners, mode)
    got = sp.segsum_probe_plain(*_torch_inputs(cot, owners), mode, acc_dtype=torch.float64)
    assert got.shape == (sp.PANEL, D) and got.dtype == torch.float64
    np.testing.assert_allclose(np_(got), want, rtol=0, atol=1e-9 * np.abs(want).max())
    # float32, as the wrapper runs it on the CPU: sums of up to a few
    # hundred N(0,1) values in another order, 1e-5 of the largest entry
    got32 = sp.segsum_probe(*_torch_inputs(cot, owners), mode)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(np_(got32), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if mode == "fold":
        assert not np_(got32)[sp.WIN:].any()
    else:
        assert np_(got32)[sp.WIN:].any()  # the offsets really move


# The adversarial cases that the card run feeds the kernels, sized here for
# four chunk groups.
CASES = {c.name: c for c in summing_cases.probe_cases(4)}


@pytest.mark.parametrize("mode", sp.MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_adversarial_case_matches_the_definition(name, mode):
    """The wrapper on the CPU (the plain version, float32) against the
    definition in float64: rtol 1e-5, atol 1e-5 of the largest entry (one
    entry sums up to 9 x 512 values in `one_owner`)."""
    case = CASES[name]
    assert case.cot.shape[0] % sp.CHUNK == 0 and case.cot.shape[1] == D
    inside = np.diff(case.owners.reshape(-1, sp.CHUNK).astype(np.int64), axis=1)
    assert bool((inside >= 0).all()) == case.sorted
    want = _definition(np.ascontiguousarray(case.cot.T), case.owners, mode)
    got = np_(sp.segsum_probe(torch.from_numpy(case.cot), torch.from_numpy(case.owners), mode))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 1.0


@pytest.mark.parametrize("n_chunks, max_groups, want", [
    (7168, 132, (131, 55)),  # the tools' full size on an H100: the last group takes 18
    (9, 4, (3, 3)), (10, 4, (4, 3)), (3, 132, (3, 1)), (1, 1, (1, 1)), (133, 132, (67, 2)),
])
def test_chunk_groups_cover_every_chunk(n_chunks, max_groups, want):
    """Consecutive chunks to at most `max_groups` groups, none of them empty,
    also where the count does not divide."""
    groups, per_group = sp.chunk_groups(n_chunks, max_groups)
    assert (groups, per_group) == want
    assert groups <= max_groups and (groups - 1) * per_group < n_chunks <= groups * per_group


@pytest.mark.parametrize("d", range(1, sp.MAX_D + 2))
def test_shared_memory_plan_fits_a_block(d):
    """The kernel's shared memory for rows of d floats: an accumulator of a
    power of two of 128-row blocks that holds a window at any offset, two to
    four chunks of the stream, within a block's 227 KB; one D past the
    widest raises."""
    if d > sp.MAX_D:
        with pytest.raises(ValueError, match="does not fit"):
            sp.shared_memory_plan(d)
        return
    stages, acc_blocks = sp.shared_memory_plan(d)
    assert 2 <= stages <= 4 and acc_blocks & (acc_blocks - 1) == 0
    assert acc_blocks * sp.BLK >= sp.WIN + sp.BLK and acc_blocks <= sp.PANEL // sp.BLK
    stream = stages * sp.CHUNK * (d + 1) * 4
    assert acc_blocks * sp.BLK * d * 4 + stream <= sp.SMEM_BYTES


@pytest.mark.parametrize("mode", sp.MODES)
def test_plain_matches_the_jax_kernel_body(mode):
    """The JAX body's one-hot products are exact in f32 (three bf16 pieces),
    so both sides are f32 sums of the same terms in another order: rtol
    1e-5, atol 1e-5 of the largest entry."""
    cot, owners = _data(16, 7_000, seed=4)
    want = _jax_probe(cot, owners, mode).T  # (d, PANEL) -> [PANEL, d]
    got = np_(sp.segsum_probe(*_torch_inputs(cot, owners), mode))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 1.0


def test_scalars_match_the_jax_precompute():
    _, owners = _data(64, 30_000, seed=5)
    base, off = sp.probe_scalars(torch.from_numpy(owners), "window")
    base_blk = owners[:: sp.CHUNK] // 128
    need = base_blk + sp.WIN // 128 - sp.PANEL // 128
    blk_s = sp.STRIDE // 128
    pb_blk = np.maximum(0, -((-need) // blk_s)) * blk_s
    np.testing.assert_array_equal(np_(base), base_blk * 128)
    np.testing.assert_array_equal(np_(off), (base_blk - pb_blk) * 128)
    assert base.dtype == off.dtype == torch.int32
    assert 0 <= int(off.min()) and int(off.max()) <= sp.STRIDE and int(off.max()) > 0
    base_f, off_f = sp.probe_scalars(torch.from_numpy(owners), "fold")
    assert torch.equal(base_f, base) and not off_f.any()


def test_wrapper_rejects_bad_inputs():
    cot, owners = _torch_inputs(*_data(2, 300))
    with pytest.raises(ValueError, match="unknown mode"):
        sp.segsum_probe(cot, owners, "slide")
    with pytest.raises(ValueError, match="multiple of 512"):
        sp.segsum_probe(cot[:-1], owners[:-1], "fold")
    with pytest.raises(ValueError, match="float32"):
        sp.segsum_probe(cot.double(), owners, "fold")
    with pytest.raises(ValueError, match="int32"):
        sp.segsum_probe(cot, owners.long(), "fold")


@pytest.mark.parametrize("tool", [exp_panel, exp_panel2], ids=["exp_panel", "exp_panel2"])
def test_tools_run_scaled_on_the_cpu(tool, capsys):
    lines = tool.main(["--device", "cpu", "--scale", "0.004"])
    out = capsys.readouterr().out
    labels = [l["label"] for l in lines]
    assert all(l["card"] == "cpu" for l in lines)
    timed = [l for l in lines if "ms" in l]
    assert all(l["ms"] > 0 and l["p"] % sp.CHUNK == 0 for l in timed)
    if tool is exp_panel:
        assert [l.split()[0] for l in labels] == ["V4", "V0", "V1", "V2", "index_add_"]
    else:
        assert [l.split()[0] for l in labels] == [
            "resident", "resident", "index_add_", "A", "A", "B", "B"]
        sums = {l["label"]: l["value"] for l in lines if "value" in l}
        # fold and window add the same terms to other rows: equal totals
        assert sums["A sum"] == pytest.approx(sums["B sum"], rel=1e-4, abs=1e-2)
    for label in labels:
        assert label in out

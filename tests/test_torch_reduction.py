"""The port's reduction functions (wayne_tpu_torch.reduction) against the
JAX package's on the same NumPy inputs, made from a seed. The JAX
package's hit-list functions take one exposure; the port's take a leading
exposure axis, so each exposure's JAX result is stacked."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from wayne_tpu import reduction as red_j
from wayne_tpu_torch import reduction as red

torch.set_num_threads(1)

FW = 78000.0
READ_TIMES = np.array([0.0, 2.93, 12.93, 22.93, 32.93, 42.93, 52.93, 62.93,
                       72.93], np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _nonlin(rng, S):
    base = np.array([0.30, 0.30, 0.40]) * 0.04
    return (base[:, None, None] * (1.0 + 0.03 * rng.standard_normal(
        (3, S, S)))).astype(np.float32)


def _ramps(rng, B, nr, S, rate_max=400.0, bias=2500.0):
    """(B, NR, S, S) reads: a pedestal, per-pixel rates with a spectral
    structure along columns, read noise; and the rates."""
    t = READ_TIMES[:nr]
    rate = rate_max * rng.random((B, 1, S, S)) * (
        1.0 + np.sin(np.arange(S) / 3.0))[None, None, None, :]
    reads = (bias + rate * t[None, :, None, None]
             + 10.0 * rng.standard_normal((B, nr, S, S)))
    return reads.astype(np.float32), t


@pytest.mark.parametrize("gain_map", [False, True], ids=["scalar", "map"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_linearize_reads_matches_jax(gain_map, bias):
    """Raw DN from the forward cubic (compressed charge, plus the pedestal,
    over the gain), a tenth of the pixels past full well: the inversion
    agrees at rtol 1e-6, the saturated pixels at exactly full well."""
    rng = np.random.default_rng(0)
    S, nr = 32, 4
    c = _nonlin(rng, S)
    Q = rng.uniform(0.0, 1.0, (2, nr, S, S)) * FW
    Q[:, :, :3] *= 1.5                                   # saturated rows
    q = np.minimum(Q, FW) / FW
    measured = np.minimum(Q, FW) * (1.0 - ((c[2] * q + c[1]) * q + c[0]) * q)
    gain = (2.5 * (1.0 + 0.01 * rng.standard_normal((S, S)))
            if gain_map else np.float32(2.5)).astype(np.float32)
    bias_e = (2500.0 + 12.0 * rng.standard_normal((S, S))).astype(np.float32)
    reads = ((measured + (bias_e if bias else 0.0)) / gain).astype(np.float32)
    want = np.asarray(red_j.linearize_reads(
        jnp.asarray(reads), jnp.asarray(c), FW, jnp.asarray(gain),
        bias_e=jnp.asarray(bias_e) if bias else None))
    got = red.linearize_reads(_t(reads), _t(c), FW, _t(gain),
                              bias_e=_t(bias_e) if bias else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[:, :, :3] == np.float32(FW)).mean() > 0.2
    np.testing.assert_array_equal(got == np.float32(FW),
                                  want == np.float32(FW))


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "batched"])
def test_ramp_slope_frame_matches_jax(batch):
    """The least-squares slope over the leading (time) axis, at rtol 1e-5
    with an absolute floor of 1e-5 of the frame's largest slope (pixels
    of near-zero rate are differences of near-equal reads)."""
    rng = np.random.default_rng(1)
    S, nr = 32, 6
    reads, t = _ramps(rng, 1, nr, S)
    reads = reads[0].reshape((nr,) + (1,) * len(batch) + (S, S))
    reads = np.broadcast_to(reads, (nr,) + batch + (S, S)) + np.float32(
        5.0) * rng.standard_normal((nr,) + batch + (S, S)).astype(np.float32)
    reads = reads.astype(np.float32)
    want = np.asarray(red_j.ramp_slope_frame(jnp.asarray(reads),
                                             jnp.asarray(t)))
    got = red.ramp_slope_frame(_t(reads), _t(t)).numpy()
    assert got.shape == batch + (S, S)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_repair_read_stack_matches_jax_with_random_masks():
    """Random masks, whole bad columns on the frame's edges, a hot pixel
    (every interval bad) and a 3 x 3 cluster: rtol 1e-5 with a floor of
    1e-5 of the largest read."""
    rng = np.random.default_rng(2)
    B, nr, S = 2, 5, 32
    reads, _ = _ramps(rng, B, nr, S)
    good = rng.random((B, nr - 1, S, S)) > 0.15
    good[:, 1, :, 0] = False                              # edge columns
    good[:, 2, :, S - 1] = False
    good[0, :, 7, 9] = False                              # hot pixel
    good[1, 0, 10:13, 10:13] = False                      # cluster
    want = np.stack([np.asarray(red_j.repair_read_stack(
        jnp.asarray(reads[b]), jnp.asarray(good[b]))) for b in range(B)])
    got = red.repair_read_stack(_t(reads), _t(good)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    assert not np.allclose(got, reads, rtol=1e-4)        # it repaired


def test_repair_read_stack_all_good_returns_the_stack():
    """All-good masks: the diffs telescope back. Integer-valued DN (as the
    ADC gives them, < 2^24) make that exact in float32."""
    rng = np.random.default_rng(3)
    reads = np.round(_ramps(rng, 2, 4, 16)[0]).astype(np.float32)
    good = np.ones((2, 3, 16, 16), bool)
    got = red.repair_read_stack(_t(reads), _t(good)).numpy()
    np.testing.assert_array_equal(got, reads)
    np.testing.assert_array_equal(got, np.asarray(red_j.repair_read_stack(
        jnp.asarray(reads), jnp.asarray(good))))


def _hits(rng, B, nsamp, n_cr, S, kind):
    """Hit lists (B, nsamp, 2, MAX_CR) int32 and counts (B, nsamp): the
    entries beyond each count are random positions, as the simulator's
    candidate lists hold them."""
    pos = rng.integers(0, S, (B, nsamp, 2, n_cr)).astype(np.int32)
    if kind == "over_budget":
        return pos, np.full((B, nsamp), n_cr, np.int32)
    count = rng.integers(0, n_cr + 1, (B, nsamp)).astype(np.int32)
    # exposure 0: interval 0 hits columns 0 and S-1, two adjacent columns
    # and one pixel twice; interval 1 that pixel once more and a pixel
    # beside a column-0 hit; a padded entry on a hit pixel
    special = {0: [(5, 0), (5, S - 1), (10, 7), (10, 8), (12, 12), (12, 12)],
               1: [(12, 12), (5, 1), (20, 30)],
               2: [(3, 4)]}
    for k, hits in special.items():
        for i, (y, x) in enumerate(hits):
            pos[0, k, :, i] = (y, x)
        count[0, k] = len(hits)
    pos[0, 2, :, 1] = (5, 0)                               # padded entry
    return pos, count


def _reads_with_hits(rng, reads, pos, count):
    """Add each valid hit's charge step to the reads after its interval."""
    reads = reads.copy()
    B, nsamp, _, n_cr = pos.shape
    for b in range(B):
        for k in range(nsamp):
            for i in range(count[b, k]):
                y, x = pos[b, k, :, i]
                reads[b, k + 1:, y, x] += rng.uniform(200.0, 5000.0)
    return reads


@pytest.mark.parametrize("ramp", [False, True], ids=["cds", "ramp"])
@pytest.mark.parametrize("kind", ["edges_and_duplicates", "over_budget"])
def test_extract_spectra_cr_matches_jax(kind, ramp):
    """CDS and up-the-ramp, rtol 1e-5 with a floor of 1e-5 of the largest
    column. ``over_budget`` fills every list, past the static hit budget,
    so both packages keep the largest diffs through a stable argsort; the
    budget sits below the padded total only beyond 6 intervals (it is at
    least H/2 + 3 MAX_CR), hence 8 intervals there."""
    rng = np.random.default_rng(4)
    S, n_cr = 32, (4 if kind == "over_budget" else 8)
    nsamp = 8 if kind == "over_budget" else 3
    B = 2
    if kind == "over_budget":
        assert red.hit_budget(nsamp, n_cr) < nsamp * n_cr
    pos, count = _hits(rng, B, nsamp, n_cr, S, kind)
    reads, t = _ramps(rng, B, nsamp + 1, S)
    reads = _reads_with_hits(rng, reads, pos, count)
    rt = t if ramp else None
    want = np.stack([np.asarray(red_j.extract_spectra_cr(
        jnp.asarray(reads[b]), jnp.asarray(pos[b]), jnp.asarray(count[b]),
        None if rt is None else jnp.asarray(rt))) for b in range(B)])
    got = red.extract_spectra_cr(_t(reads), _t(pos), _t(count),
                                 None if rt is None else _t(rt)).numpy()
    assert got.shape == (B, S)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # the repair moved the hit columns
    plain = (reads[:, -1] - reads[:, 0]).sum(axis=-2)
    if not ramp:
        assert np.abs(got - plain).max() > 100.0


def test_cr_bad_diff_masks_matches_jax():
    """Exactly the JAX package's masks, padded entries on hit pixels
    included."""
    rng = np.random.default_rng(5)
    S = 32
    pos, count = _hits(rng, 2, 3, 8, S, "edges_and_duplicates")
    want = np.stack([np.asarray(red_j.cr_bad_diff_masks(
        jnp.asarray(pos[b]), jnp.asarray(count[b]), S)) for b in range(2)])
    got = red.cr_bad_diff_masks(_t(pos), _t(count), S).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 12, 12] and got[0, 2, 3, 4] and not got[0, 2, 5, 0]

"""The port's file-level reduction (wayne_tpu_torch.reduction: the
extraction helpers, the baselines, the drift helpers and reduce_visit)
against the JAX package's on the same NumPy inputs, made from a seed.

Bars: masks and channel edges exact; spectra and net frames rtol 1e-5 with
a floor of 1e-5 of the frame's peak; normalised light curves atol 5e-6;
x_shifts atol 1e-4 px. The measured gaps are written beside each check.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu import reduction as red_j
from wayne_tpu.calibration import quadrant_map as quadrant_map_j
from wayne_tpu.ops.kepler import OrbitParams as OrbitJ
from wayne_tpu_torch import reduction as red
from wayne_tpu_torch.calibration import quadrant_map
from wayne_tpu_torch.ops.kepler import OrbitParams

torch.set_num_threads(1)

S, NR, N_EXP = 64, 5, 24
READ_TIMES = np.array([0.0, 2.93, 12.93, 22.93, 32.93], np.float32)
ORBIT = dict(period_s=0.813475 * 86400.0, t0_s=3.0 * 3600.0, sma_rs=4.855,
             inc_rad=math.radians(82.1))
LD = np.array([0.65, -0.25, 0.45, -0.2], np.float32)
Y_WIN, X_WIN = (22, 43), (8, 57)
MID = np.linspace(0.0, 6.0 * 3600.0, N_EXP).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _orbits():
    return OrbitJ.create(**ORBIT), OrbitParams.create(**ORBIT)


def _close_frac(got, want, rtol=1e-5, floor=1e-5):
    """Spectra and net frames: rtol, with an absolute floor of ``floor``
    of the reference's peak. Returns the largest gap over its allowance."""
    got, want = _np(got), _np(want)
    atol = floor * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def _visit(seed=0, drift=0.0, offsets=False, hits=False):
    """(reads (N_EXP, NR, S, S) DN, dq (N_EXP, NR, S, S) int16): a scanned
    spectrum on rows ~22-42 over columns 8-56 with a sharp blue edge, a
    2% transit, per-exposure drifts of up to ``drift`` px, sky, bias and
    read noise; ``offsets`` adds per-exposure per-quadrant pedestals,
    ``hits`` cosmic-ray steps flagged in DQ."""
    rng = np.random.default_rng(seed)
    y = np.arange(S)[:, None]
    x = np.arange(S)[None, :].astype(np.float64)
    prof = np.exp(-0.5 * ((y - 32.0) / 4.0) ** 2)
    dx = drift * np.sin(np.arange(N_EXP) / 3.0)
    _, orb = _orbits()
    oot = _np(red.out_of_transit_mask(_t(MID), orb))
    reads = np.empty((N_EXP, NR, S, S), np.float64)
    quad = _np(quadrant_map(S))
    for i in range(N_EXP):
        xx = x - dx[i]
        spec = (1.0 / (1.0 + np.exp(-(xx - 10.0) / 0.6))
                * np.exp(-((xx - 34.0) / 20.0) ** 2)
                * (xx < 55.0) * (1.0 + 0.2 * np.sin(xx / 2.5)))
        lc = 1.0 if oot[i] else 0.98 - 0.002 * np.sin(xx / 7.0)
        rate = 300.0 * prof * spec * lc + 1.5
        pedestal = 2000.0
        if offsets:
            pedestal = pedestal + rng.normal(0.0, 3.0, 4)[quad]
        reads[i] = (pedestal + rate[None] * READ_TIMES[:, None, None]
                    + rng.normal(0.0, 4.0, (NR, S, S)))
    dq = np.zeros((N_EXP, NR, S, S), np.int16)
    if hits:
        for i in range(N_EXP):
            for _ in range(6):
                k = rng.integers(1, NR)
                yy, xx = rng.integers(0, S, 2)
                reads[i, k:, yy, xx] += 900.0
                dq[i, k:, yy, xx] |= red.DQ_COSMIC_RAY
        dq[:, :, 5, 5] |= red.DQ_HOT_PIXEL
        dq[:, 3:, 30, 40] |= red.DQ_SATURATED
    return reads.astype(np.float32), dq


# ---------------------------------------------------------------------------
# The median and the shared helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [6, 7], ids=["even", "odd"])
@pytest.mark.parametrize("nan", [False, True], ids=["median", "nanmedian"])
@pytest.mark.parametrize("with_nan", [False, True], ids=["clean", "nans"])
def test_median_matches_jnp(n, nan, with_nan):
    """_median = jnp.median / jnp.nanmedian bit for bit on even and odd
    counts (torch.median takes the lower middle value), with and without
    NaNs, over either axis; an all-NaN row gives NaN."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(5, n)).astype(np.float32)
    if with_nan:
        x[1, 2] = np.nan
        x[3, :] = np.nan
    ref = jnp.nanmedian if nan else jnp.median
    for axis in (0, 1):
        want = np.asarray(ref(jnp.asarray(x), axis=axis))
        got = red._median(_t(x), axis, nan=nan).numpy()
        np.testing.assert_array_equal(got, want)
    if not with_nan:
        assert red._median(_t(x), 1)[0] != torch.median(_t(x), 1)[0][0] \
            or n % 2


def test_channel_edges_and_reduced_visit_fields():
    """The float64 linspace recipe: the JAX package's edges exactly, the
    same refusal of zero-width channels; ReducedVisit has its fields."""
    for window, n in [((8, 57), 16), ((0, 512), 7), ((13, 114), 9),
                      ((3, 6), 3)]:
        np.testing.assert_array_equal(
            red._channel_edges(window, n),
            np.asarray(red_j._channel_edges(window, n)))
    with pytest.raises(ValueError, match="zero-width"):
        red._channel_edges((3, 6), 4)
    assert [f.name for f in dataclasses.fields(red.ReducedVisit)] == \
        [f.name for f in dataclasses.fields(red_j.ReducedVisit)]
    assert (red.DQ_BAD_BITS, red.DQ_STATIC_BAD, red.OOT_Z) == \
        (red_j.DQ_BAD_BITS, red_j.DQ_STATIC_BAD, red_j.OOT_Z)
    for nr in (2, 5, 16):
        for ramp in (False, True):
            assert red.read_noise_var_e2(12.5, nr, ramp) == \
                red_j.read_noise_var_e2(12.5, nr, ramp)


def test_good_diff_masks_from_dq_exact():
    rng = np.random.default_rng(2)
    bits = np.array([0, 4, 16, 32, 128, 256, 512, 8192, 8192 | 256],
                    np.int16)
    dq = bits[rng.integers(0, len(bits), (2, NR, 16, 16))]
    want = np.asarray(red_j.good_diff_masks_from_dq(jnp.asarray(dq)))
    got = red.good_diff_masks_from_dq(_t(dq)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


@pytest.mark.parametrize("border", [True, False], ids=["border", "no_ref"])
def test_ref_pixel_correct_matches_jax(border):
    """Per-read per-quadrant drifts on a 5-px reference border with two
    cosmic rays on it: the corrected stack at rtol 1e-6, the offsets at
    atol 2e-3 DN (measured 8.5e-4: float32 sums of ~1200 pixels at 1000
    DN, 8.5e-7 of the level, in another order); without reference pixels
    both are no-ops."""
    rng = np.random.default_rng(3)
    quad = np.asarray(quadrant_map_j(S))
    drift = rng.normal(0.0, 2.0, (NR, 4)).astype(np.float32)
    reads = (1000.0 + drift[:, quad] + rng.normal(0, 1.0, (NR, S, S))
             ).astype(np.float32)
    ref = np.zeros((S, S), bool)
    if border:
        ref[:5], ref[-5:], ref[:, :5], ref[:, -5:] = True, True, True, True
        reads[2:, 1, 1] += 500.0
        reads[3:, 60, 2] += 800.0
    want, off_w = red_j.ref_pixel_correct(jnp.asarray(reads),
                                          jnp.asarray(ref))
    got, off = red.ref_pixel_correct(_t(reads), _t(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(off.numpy(), np.asarray(off_w), atol=2e-3)
    assert (np.abs(off.numpy()).max() > 0.5) == border


def test_repair_read_stack_sparse_matches_dense_and_jax():
    """Isolated hits: the sparse repair = the port's dense repair (rtol
    1e-5, atol 1e-2, as the JAX package holds its pair) and = the JAX
    sparse repair (atol 1e-3 DN); both recover the linear ramps."""
    rng = np.random.RandomState(3)
    nsamp, s, n_cr = 4, 32, 8
    rate = rng.uniform(5.0, 50.0, (s, s)).astype(np.float32)
    t = np.arange(nsamp + 1, dtype=np.float32)
    reads = rate[None] * t[:, None, None]
    truth = reads.copy()
    cr_pos = np.zeros((nsamp, 2, n_cr), np.int32)
    cr_count = np.asarray([2, 0, 3, 1], np.int32)
    per_k = {0: [(5, 5), (10, 20)], 2: [(5, 10), (20, 8), (28, 25)],
             3: [(15, 15)]}
    for k, lst in per_k.items():
        for i, (y, x) in enumerate(lst):
            cr_pos[k, 0, i], cr_pos[k, 1, i] = y, x
            reads[k + 1:, y, x] += 700.0
    sparse = red.repair_read_stack_sparse(_t(reads), _t(cr_pos),
                                          _t(cr_count)).numpy()
    bad = red.cr_bad_diff_masks(_t(cr_pos)[None], _t(cr_count)[None], s)[0]
    dense = red.repair_read_stack(_t(reads), ~bad).numpy()
    np.testing.assert_allclose(sparse, dense, rtol=1e-5, atol=1e-2)
    want = np.asarray(red_j.repair_read_stack_sparse(
        jnp.asarray(reads), jnp.asarray(cr_pos), jnp.asarray(cr_count)))
    np.testing.assert_allclose(sparse, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(sparse, truth, rtol=1e-5, atol=0.5)


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ramp", [False, True], ids=["cds", "ramp"])
@pytest.mark.parametrize("dq", [False, True], ids=["plain", "good_diffs"])
def test_net_frame_and_extract_exposure_match_jax(ramp, dq):
    """One exposure per JAX call against the port's batch of three: net
    frames and spectra within rtol 1e-5 and 1e-5 of the peak (measured
    gap at most 0.014 of the allowance). bg_rows (0, 16) is an even count."""
    reads, dqs = _visit(seed=4, hits=dq)
    reads, dqs = reads[:3], dqs[:3]
    gain = np.float32(2.5)
    rt = READ_TIMES if ramp else None
    good = red.good_diff_masks_from_dq(_t(dqs)) if dq else None
    nets = red.net_frame(_t(reads), torch.tensor(gain),
                         None if rt is None else _t(rt), good)
    specs = red.extract_exposure(_t(reads), torch.tensor(gain), Y_WIN,
                                 (0, 16), None if rt is None else _t(rt),
                                 good)
    for i in range(3):
        g_j = None if good is None else jnp.asarray(good[i].numpy())
        rt_j = None if rt is None else jnp.asarray(rt)
        want = red_j.net_frame(jnp.asarray(reads[i]), gain, rt_j, g_j)
        assert _close_frac(nets[i], want) < 0.2
        want = red_j.extract_exposure(jnp.asarray(reads[i]), gain, Y_WIN,
                                      (0, 16), rt_j, g_j)
        assert _close_frac(specs[i], want) < 0.2


def test_spatial_profile_and_optimal_extract_match_jax():
    """The visit-mean profile (smoothed, thresholded, normalised) at atol
    1e-6, the optimal spectra of every exposure at the spectra's bar."""
    reads, _ = _visit(seed=5)
    gain = np.float32(2.5)
    nets = red.net_frame(_t(reads), torch.tensor(gain))
    nets = nets - red._median(nets[:, :16], -2)[:, None, :]
    mean = nets.mean(0)
    for smooth in (0, 8):
        prof = red.spatial_profile(mean, Y_WIN, smooth_x=smooth)
        want = red_j.spatial_profile(jnp.asarray(mean.numpy()), Y_WIN,
                                     smooth_x=smooth)
        np.testing.assert_allclose(prof.numpy(), np.asarray(want), atol=1e-6)
    floor = red.read_noise_var_e2(12.0, NR)
    got = red.optimal_extract(nets, prof, Y_WIN, floor)
    want = red_j.optimal_extract(jnp.asarray(nets.numpy()),
                                 jnp.asarray(prof.numpy()), Y_WIN, floor)
    assert _close_frac(got, want) < 0.5


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def test_out_of_transit_mask_and_scan_direction_factor_match_jax():
    orb_j, orb = _orbits()
    oot = red.out_of_transit_mask(_t(MID), orb)
    np.testing.assert_array_equal(
        oot.numpy(), np.asarray(red_j.out_of_transit_mask(jnp.asarray(MID),
                                                          orb_j)))
    assert 0 < int(oot.sum()) < N_EXP
    rng = np.random.default_rng(6)
    white = (1e6 * (1.0 + 0.01 * rng.normal(size=N_EXP))).astype(np.float32)
    rev = (np.arange(N_EXP) % 2).astype(np.float32)
    white[rev > 0] *= 1.004
    for r in (rev, np.zeros(N_EXP, np.float32)):
        want = red_j.scan_direction_factor(jnp.asarray(white),
                                           jnp.asarray(_np(oot)),
                                           jnp.asarray(r))
        got = red.scan_direction_factor(_t(white), oot, _t(r))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # a batch of realisations, one call
    batch = np.stack([white, white * 1.1])
    got = red.scan_direction_factor(_t(batch), oot, _t(rev))
    np.testing.assert_allclose(got[1].numpy(), got[0].numpy(), rtol=1e-6)


@pytest.mark.parametrize("window", [(Y_WIN, X_WIN), ((0, 40), (0, 64))],
                         ids=["box", "covers_two_quadrants"])
def test_amp_offset_correct_matches_jax(window):
    """Per-quadrant medians of the off-source pixels (NaN-skipping, even
    and odd counts), 0 for a quadrant the box covers: atol 1e-4 e-."""
    rng = np.random.default_rng(7)
    quad = np.asarray(quadrant_map_j(S))
    nets = (rng.normal(0.0, 5.0, (3, S, S))
            + rng.normal(0.0, 20.0, (3, 4))[:, quad]).astype(np.float32)
    want = red_j.amp_offset_correct(jnp.asarray(nets), jnp.asarray(quad),
                                    *window)
    got = red.amp_offset_correct(_t(nets), quadrant_map(S), *window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# Drift helpers
# ---------------------------------------------------------------------------

def _drift_spectra():
    reads, _ = _visit(seed=8, drift=0.3)
    nets = red.net_frame(_t(reads), torch.tensor(2.5))
    nets = nets - red._median(nets[:, :16], -2)[:, None, :]
    return nets[:, Y_WIN[0]: Y_WIN[1]].sum(1)


def test_catmull_rom_and_shift_helpers_match_jax():
    """_catmull_rom (value and slope, inside and beyond the grid),
    spectral_shifts (atol 1e-4 px; measured 8.5e-7), align_spectra
    and drift_binned_flux (the spectra's bar), dispersion_centroid (atol
    1e-4 px)."""
    spectra = _drift_spectra()
    sp_j = jnp.asarray(spectra.numpy())
    f = np.cumsum(np.random.default_rng(9).normal(size=20)).astype(np.float32)
    q = np.linspace(-2.0, 22.0, 97).astype(np.float32)
    val, dval = red._catmull_rom(_t(f), _t(q))
    val_j, dval_j = red_j._catmull_rom(jnp.asarray(f), jnp.asarray(q))
    np.testing.assert_allclose(val.numpy(), np.asarray(val_j), atol=1e-5)
    np.testing.assert_allclose(dval.numpy(), np.asarray(dval_j), atol=1e-5)

    shifts = red.spectral_shifts(spectra, X_WIN)
    shifts_j = red_j.spectral_shifts(sp_j, X_WIN)
    np.testing.assert_allclose(shifts.numpy(), np.asarray(shifts_j),
                               atol=1e-4)
    assert np.ptp(shifts.numpy()) > 0.3            # the drift is seen
    assert _close_frac(red.align_spectra(spectra, shifts),
                       red_j.align_spectra(sp_j, shifts_j)) < 1.0
    edges = red._channel_edges(X_WIN, 6)
    assert _close_frac(
        red.drift_binned_flux(spectra, shifts, _t(edges)),
        red_j.drift_binned_flux(sp_j, shifts_j, jnp.asarray(edges))) < 1.0
    np.testing.assert_allclose(
        red.dispersion_centroid(spectra, X_WIN).numpy(),
        np.asarray(red_j.dispersion_centroid(sp_j, X_WIN)), atol=1e-4)


def test_drift_regressors_and_detrend_match_jax():
    """drift_regressor, both contamination bases (the model basis through
    forward-mode autodiff), clean_drift_regressor and shift_detrend."""
    orb_j, orb = _orbits()
    spectra = _drift_spectra()
    sp_j = jnp.asarray(spectra.numpy())
    oot = red.out_of_transit_mask(_t(MID), orb)
    oot_j = jnp.asarray(oot.numpy())
    white = spectra[:, X_WIN[0]: X_WIN[1]].sum(1)
    white_j = jnp.asarray(white.numpy())
    np.testing.assert_allclose(
        red.drift_regressor(spectra, X_WIN, white, oot).numpy(),
        np.asarray(red_j.drift_regressor(sp_j, X_WIN, white_j, oot_j)),
        atol=1e-4)
    basis = red.transit_drift_basis(_t(MID), orb, _t(LD), 0.15)
    basis_j = red_j.transit_drift_basis(jnp.asarray(MID), orb_j,
                                        jnp.asarray(LD), 0.15)
    np.testing.assert_allclose(basis.numpy(), np.asarray(basis_j),
                               atol=2e-6)
    wb = red.white_drift_basis(white, oot, _t(MID))
    wb_j = red_j.white_drift_basis(white_j, oot_j, jnp.asarray(MID))
    np.testing.assert_allclose(wb.numpy(), np.asarray(wb_j), atol=1e-6)
    cen = red.dispersion_centroid(spectra, X_WIN)
    for b, b_j in ((basis, basis_j), (wb, wb_j)):
        reg = red.clean_drift_regressor(cen, b, _t(MID))
        reg_j = red_j.clean_drift_regressor(jnp.asarray(cen.numpy()), b_j,
                                            jnp.asarray(MID))
        np.testing.assert_allclose(reg.numpy(), np.asarray(reg_j), atol=1e-4)
    chan = red._channel_flux(spectra, red._channel_edges(X_WIN, 5))
    for flux in (white, chan):
        got = red.shift_detrend(flux, reg, oot)
        want = red_j.shift_detrend(jnp.asarray(flux.numpy()),
                                   jnp.asarray(reg.numpy()), oot_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)


# ---------------------------------------------------------------------------
# reduce_visit
# ---------------------------------------------------------------------------

OPTIONS = {
    "box": {},
    "box_odd_bg": {"bg_rows": (0, 15)},
    "optimal": {"optimal": True},
    "ramp": {"read_times": True},
    "good_diffs": {"good_diffs": True, "read_times": True},
    "align": {"align": True},
    "align_ld": {"align": True, "ld": True},
    "scan_dir": {"scan_dir": True},
    "quad_map": {"quad_map": True},
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_reduce_visit_matches_jax(option):
    """Every option of reduce_visit, the port's one batched call against
    the JAX package's jitted vmap: spectra at rtol 1e-5 and 1e-5 of the
    peak (measured at most 0.077 of the allowance), white and channel
    curves at atol 5e-6 (measured <= 2.4e-7 and <= 1.8e-6), x_shifts at
    atol 1e-4 px (measured 8.1e-7), the channel columns exactly (the align
    options against the JAX function in float64, see below). The default sky
    rows (0, 16) are an even count (the median of the middle two);
    ``box_odd_bg`` takes 15."""
    opt = dict(OPTIONS[option])
    orb_j, orb = _orbits()
    reads, dq = _visit(seed=10, drift=0.25 if "align" in opt else 0.0,
                       offsets="quad_map" in opt,
                       hits="good_diffs" in opt)
    gain = (2.5 * (1.0 + 0.01 * np.random.default_rng(11).normal(
        size=(S, S)))).astype(np.float32)
    kw_j, kw = {}, {}
    for name, value in opt.items():
        if name == "read_times":
            kw_j[name], kw[name] = jnp.asarray(READ_TIMES), _t(READ_TIMES)
        elif name == "good_diffs":
            good = red.good_diff_masks_from_dq(_t(dq))
            kw_j[name], kw[name] = jnp.asarray(good.numpy()), good
        elif name == "ld":
            kw_j[name], kw[name] = jnp.asarray(LD), _t(LD)
        elif name == "scan_dir":
            rev = (np.arange(N_EXP) % 2).astype(np.float32)
            reads[rev > 0] *= np.float32(1.003)
            kw_j[name], kw[name] = jnp.asarray(rev), _t(rev)
        elif name == "quad_map":
            kw_j[name], kw[name] = jnp.asarray(quadrant_map_j(S)), \
                quadrant_map(S)
        else:
            kw_j[name] = kw[name] = value
    if "align" in opt:
        # The reference's float32 align path cancels the ~30 px centroid
        # level inside a near-singular solve (clean_drift_regressor): its
        # channel curves sit 7.3e-6 (align) and 3.6e-6 (align_ld) from the
        # same JAX function in float64, and 7.4e-6 / 3.4e-6 from the port,
        # which takes the level off first. The port is held to the JAX
        # function in float64 (measured 1.8e-6 / 9.2e-7).
        with jax.enable_x64(True):
            f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
            want = red_j.reduce_visit(
                f64(reads), f64(gain), f64(MID),
                jax.tree_util.tree_map(f64, orb_j), y_window=Y_WIN,
                x_window=X_WIN, n_chan=6,
                **{k: f64(v) if k == "ld" else v for k, v in kw_j.items()})
            want = jax.tree_util.tree_map(
                lambda a: np.asarray(a).astype(
                    np.int32 if a.dtype.kind == "i" else np.float32), want)
    else:
        want = red_j.reduce_visit(jnp.asarray(reads), jnp.asarray(gain),
                                  jnp.asarray(MID), orb_j, y_window=Y_WIN,
                                  x_window=X_WIN, n_chan=6, **kw_j)
    got = red.reduce_visit(_t(reads), _t(gain), _t(MID), orb,
                           y_window=Y_WIN, x_window=X_WIN, n_chan=6, **kw)
    assert _close_frac(got.spectra_e, want.spectra_e) < 1.0
    np.testing.assert_allclose(got.white_lc.numpy(),
                               np.asarray(want.white_lc), rtol=0, atol=5e-6)
    np.testing.assert_allclose(got.channel_lc.numpy(),
                               np.asarray(want.channel_lc), rtol=0,
                               atol=5e-6)
    np.testing.assert_allclose(got.x_shifts.numpy(),
                               np.asarray(want.x_shifts), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.channel_cols.numpy(),
                                  np.asarray(want.channel_cols))
    assert got.channel_lc.shape == (N_EXP, 6)
    dip = 1.0 - got.white_lc.numpy().min()
    assert 0.01 < dip < 0.04, dip                 # the 2% transit is seen

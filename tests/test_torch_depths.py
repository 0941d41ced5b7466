"""The port's depth fits (wayne_tpu_torch.reduction: fit_depths, _beta_red,
common_mode_correct, divide_white_fit_depths, spectra_to_depths,
constrained_mask) against the JAX package's on the same NumPy light curves
and spectra, made from a seed.

Bars: rp atol 1e-5; rp_sigma (total, rel, common) rtol 1e-3; corrected
curves atol 5e-6; constrained masks exact. Measured gaps beside each.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu import reduction as red_j
from wayne_tpu.ops.kepler import OrbitParams as OrbitJ
from wayne_tpu.ops.transit import transit_light_curve as tlc_j
from wayne_tpu_torch import reduction as red
from wayne_tpu_torch.ops.kepler import OrbitParams

torch.set_num_threads(1)

N_EXP, N_CHAN, S = 24, 4, 64
ORBIT = dict(period_s=0.813475 * 86400.0, t0_s=3.0 * 3600.0, sma_rs=4.855,
             inc_rad=math.radians(82.1))
LD = np.array([0.65, -0.25, 0.45, -0.2], np.float32)
MID = np.linspace(0.0, 6.0 * 3600.0, N_EXP).astype(np.float32)
RP = np.array([0.150, 0.156, 0.147, 0.160], np.float32)
X_WIN = (10, 54)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _orbits():
    return OrbitJ.create(**ORBIT), OrbitParams.create(**ORBIT)


def _ld_chan():
    return (LD[None, :] * np.array([1.1, 1.0, 0.95, 0.9],
                                   np.float32)[:, None]).astype(np.float32)


def _curves(seed, n_mc=None, ld=LD, noise=3e-4, red_amp=0.0):
    """Channel curves (n_exp, n_chan) [or (n_mc, n_exp, n_chan)] of the
    injected RP through the JAX transit model, white noise of ``noise``
    and a red (random-walk) term of ``red_amp``."""
    orb_j, _ = _orbits()
    model = np.asarray(tlc_j(jnp.asarray(MID), orb_j, jnp.asarray(RP),
                             jnp.asarray(ld), n_quad=32))    # (n_exp, n_chan)
    rng = np.random.default_rng(seed)
    shape = (N_EXP, N_CHAN) if n_mc is None else (n_mc, N_EXP, N_CHAN)
    lc = model + noise * rng.standard_normal(shape)
    if red_amp:
        lc = lc + red_amp * np.cumsum(rng.standard_normal(shape), axis=-2)
    return lc.astype(np.float32)


def _fit(lc, ld=LD, **kw):
    orb_j, orb = _orbits()
    kw_j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    want = red_j.fit_depths(jnp.asarray(lc), jnp.asarray(MID), orb_j,
                            jnp.asarray(ld), 0.15, **kw_j)
    got = red.fit_depths(_t(lc), _t(MID), orb, _t(ld), 0.15,
                         **{k: _t(v) if isinstance(v, np.ndarray) else v
                            for k, v in kw.items()})
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


def _assert_depths(got, want, sigmas=1):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:1 + sigmas], want[1:1 + sigmas]):
        np.testing.assert_allclose(g, w, rtol=1e-3)


@pytest.mark.parametrize("ld", ["shared", "per_channel"])
@pytest.mark.parametrize("baseline_var", [True, False],
                         ids=["bvar", "no_bvar"])
@pytest.mark.parametrize("red_noise", [True, False], ids=["beta", "no_beta"])
def test_fit_depths_matches_jax(ld, baseline_var, red_noise):
    """12 Newton steps through autograd (the JAX package: grad of grad and
    jacfwd, vmapped over channels): rp at atol 1e-5 (measured <= 1.6e-7),
    sigma at rtol 1e-3 (measured <= 2.1e-5), with shared and per-channel
    limb darkening, the baseline term and the red-noise beta on and off;
    the fit recovers the injected depths."""
    ld_arr = LD if ld == "shared" else _ld_chan()
    lc = _curves(1, ld=ld_arr, red_amp=1e-4)
    got, want = _fit(lc, ld=ld_arr, baseline_var=baseline_var,
                     red_noise=red_noise)
    _assert_depths(got, want)
    assert np.all(np.abs(got[0] - RP) < 6.0 * got[1] + 1e-3)


def test_fit_depths_with_weights_and_a_batch_matches_jax():
    """Exposure weights (three clipped to 0) and a leading batch of three
    realisations fitted in one call, each against its own JAX fit."""
    w = np.ones(N_EXP, np.float32)
    w[[2, 9, 17]] = 0.0
    lc = _curves(2, n_mc=3)
    _, orb = _orbits()
    got = red.fit_depths(_t(lc), _t(MID), orb, _t(LD), 0.15, weights=_t(w))
    for b in range(3):
        _, want = _fit(lc[b], weights=w)
        _assert_depths([got[0][b].numpy(), got[1][b].numpy()], want)


def test_beta_red_matches_jax():
    rng = np.random.default_rng(3)
    resid = np.cumsum(rng.normal(size=(3, N_EXP)), axis=1).astype(np.float32)
    w = (rng.random(N_EXP) > 0.1).astype(np.float32)
    got = red._beta_red(_t(resid), _t(w), 3).numpy()
    want = [float(red_j._beta_red(jnp.asarray(r), jnp.asarray(w), 3))
            for r in resid]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.max() > 1.0


def _white(lc, seed):
    common = 1.0 + 4e-4 * np.sin(np.arange(N_EXP) / 2.0)    # systematics
    rng = np.random.default_rng(seed)
    white = lc.mean(axis=-1) + 1e-4 * rng.standard_normal(lc.shape[:-1])
    return ((white * common).astype(np.float32),
            (lc * common[:, None]).astype(np.float32))


def test_common_mode_correct_and_divide_white_match_jax():
    """The white fit's template divided out (curves atol 5e-6, measured
    0), then the per-channel fit with the common-mode sigma (rp atol 1e-5,
    measured 1.8e-7; total, rel and common sigma rtol 1e-3, measured
    <= 4.7e-6), with return_components."""
    orb_j, orb = _orbits()
    white, chan = _white(_curves(4), 5)
    args_j = (jnp.asarray(white), jnp.asarray(chan), jnp.asarray(MID), orb_j,
              jnp.asarray(LD), 0.15)
    args = (_t(white), _t(chan), _t(MID), orb, _t(LD), 0.15)
    corr, sig = red.common_mode_correct(*args, return_white_sigma=True)
    corr_j, sig_j = red_j.common_mode_correct(*args_j,
                                              return_white_sigma=True)
    np.testing.assert_allclose(corr.numpy(), np.asarray(corr_j), atol=5e-6)
    np.testing.assert_allclose(float(sig), float(sig_j), rtol=1e-3)
    got = [x.numpy() for x in red.divide_white_fit_depths(
        *args, return_components=True)]
    want = [np.asarray(x) for x in red_j.divide_white_fit_depths(
        *args_j, return_components=True)]
    _assert_depths(got, want, sigmas=3)
    np.testing.assert_allclose(got[1], np.sqrt(got[2] ** 2 + got[3] ** 2),
                               rtol=1e-6)
    got2 = red.divide_white_fit_depths(*args)
    assert len(got2) == 2 and torch.equal(got2[0], torch.from_numpy(got[0]))


def _spectra(seed, n_mc=3, sky=0.0, reverse=None):
    """(n_mc, n_exp, S) column spectra: a 1e5-e- spectrum over X_WIN whose
    four channels transit with RP, sky on every column, shot-like noise,
    and a 0.4% reverse-scan offset on ``reverse``."""
    lc = _curves(seed, n_mc=n_mc, noise=2e-4)
    edges = red._channel_edges(X_WIN, N_CHAN)
    chan_of = np.searchsorted(edges, np.arange(S), side="right") - 1
    inside = (np.arange(S) >= X_WIN[0]) & (np.arange(S) < X_WIN[1])
    prof = 1e5 * (1.0 + 0.3 * np.sin(np.arange(S) / 4.0)) * inside
    col_lc = np.where(inside, lc[..., np.clip(chan_of, 0, N_CHAN - 1)], 1.0)
    rng = np.random.default_rng(seed + 100)
    sp = prof * col_lc + sky + 30.0 * rng.standard_normal(col_lc.shape)
    if reverse is not None:
        sp = sp * np.where(reverse > 0, 1.004, 1.0)[:, None]
    return sp.astype(np.float32)


CASES = {
    "one_visit": dict(batch=False),
    "batch": dict(),
    "subtract_bg": dict(sky=800.0, subtract_bg=True),
    "scan_dir": dict(scan_dir=True),
    "no_divide_white": dict(divide_white=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spectra_to_depths_matches_jax(case):
    """Binning (cumulative sums at the edges), the off-window sky median
    (44 of 64 columns inside: 20 outside, an even count), per-direction
    baselines, divide-white and the fits, every realisation in one call:
    rp atol 1e-5 (measured <= 8.1e-7), sigmas rtol 1e-3 (measured <=
    3.5e-4: the residual scatter they scale with, ~2e-4, carries the
    curves' float32 rounding), the constrained flags exact."""
    opt = dict(CASES[case])
    batch = opt.pop("batch", True)
    rev = (np.arange(N_EXP) % 2).astype(np.float32) \
        if opt.pop("scan_dir", False) else None
    sp = _spectra(6, sky=opt.pop("sky", 0.0), reverse=rev)
    if not batch:
        sp = sp[0]
    orb_j, orb = _orbits()
    kw = dict(x_window=X_WIN, n_chan=N_CHAN, sigma_components=True, **opt)
    want = red_j.spectra_to_depths(
        jnp.asarray(sp), jnp.asarray(MID), orb_j, jnp.asarray(LD), 0.15,
        scan_dir=None if rev is None else jnp.asarray(rev), **kw)
    got = red.spectra_to_depths(
        _t(sp), _t(MID), orb, _t(LD), 0.15,
        scan_dir=None if rev is None else _t(rev), **kw)
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    assert got[0].shape == ((N_CHAN,) if not batch else (3, N_CHAN))
    assert got[3].shape == got[0].shape[:-1]
    _assert_depths(got[:3], want[:3], sigmas=2)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-3, atol=1e-12)
    np.testing.assert_array_equal(
        red.constrained_mask(_t(got[0]), _t(got[1])).numpy(),
        np.asarray(red_j.constrained_mask(want[0], want[1])))
    assert np.all(np.abs(got[0] - RP) < np.maximum(6.0 * got[1], 0.01))
    two = red.spectra_to_depths(_t(sp), _t(MID), orb, _t(LD), 0.15,
                                x_window=X_WIN, n_chan=N_CHAN,
                                scan_dir=None if rev is None else _t(rev),
                                **opt)
    assert len(two) == 2 and np.array_equal(two[0].numpy(), got[0])


def test_constrained_mask_exact():
    depth = np.array([0.15, 0.01, 0.5, np.nan, 0.2, 0.0106, 0.494],
                     np.float32)
    sigma = np.array([1e-3, 1e-3, 1e-3, 1e-3, 0.06, 1e-3, np.inf],
                     np.float32)
    want = np.asarray(red_j.constrained_mask(depth, sigma))
    np.testing.assert_array_equal(red.constrained_mask(depth, sigma), want)
    np.testing.assert_array_equal(
        red.constrained_mask(_t(depth), _t(sigma)).numpy(), want)
    np.testing.assert_array_equal(
        red.constrained_mask(depth, sigma, bounds=None, sigma_floor=0.02),
        np.asarray(red_j.constrained_mask(depth, sigma, bounds=None,
                                          sigma_floor=0.02)))


def test_fit_depths_launches_do_not_grow_with_channels():
    """One tensor program: the torch operators one fit dispatches (9443)
    are the same for 2, 4 and 16 channels and for 1 or 8 realisations."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    _, orb = _orbits()
    counts = set()
    for shape in ((N_EXP, 2), (N_EXP, 4), (N_EXP, 16), (8, N_EXP, 4)):
        lc = torch.ones(shape)
        Count.n = 0
        with Count():
            red.fit_depths(lc, _t(MID), orb, _t(LD), 0.15)
        counts.add(Count.n)
    assert len(counts) == 1, counts

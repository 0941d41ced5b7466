"""The port's exact Poisson sampler (``exact_poisson``: Knuth below 10,
PTRS above, on Philox counters) against ``jax.random.poisson``, by law,
never by bits; and the exact mode of the readout (``ExposureStatic(
exact_poisson=True)``) against the JAX package's XLA path, Poisson only.

The sampler's kernel twin (csrc/detector.cuh) is held to this plain
version bit for bit on the card (tests/test_torch_cuda.py,
chip_smoke.py); here its constants are held to the source."""

import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2, poisson

from wayne_tpu.calibration import synthetic_tables
from wayne_tpu.config import ExposureStatic, NoiseFlags
from wayne_tpu.ops.exposure import simulate_exposure as simulate_exposure_j
from wayne_tpu.scene import example_scene
from wayne_tpu_torch import config as config_t
from wayne_tpu_torch.convert import (
    numpy_leaves, scenes_from_numpy, tables_from_numpy,
)
from wayne_tpu_torch.ops import random as rnd
from wayne_tpu_torch.ops.exposure import simulate_exposure
from wayne_tpu_torch.ops.readout import (
    exposure_readout, read_step, read_step_banded, sample_band,
)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DETECTOR = os.path.join(HERE, "..", "wayne_tpu_torch", "csrc",
                        "detector.cuh")
LAMS = (0.5, 2.9, 3.1, 9.9, 10.1, 50.0, 150.0, 1e4)


def _exact(lam: float, n: int, seed: int = 11) -> np.ndarray:
    return rnd.exact_poisson(torch.full((n,), lam), seed, 12, 0,
                             torch.arange(n), rnd.TAG_BG_UNIFORM).numpy()


def _fast(lam: float, n: int, seed: int = 11) -> np.ndarray:
    w0, w1, w2, _ = rnd.philox4x32(seed, 12, 0, torch.arange(n),
                                   rnd.TAG_BOX_MULLER, 0)
    return rnd.fast_poisson(torch.full((n,), lam), rnd.uniform24(w2),
                            rnd.box_muller(w0, w1)[0]).numpy()


def _jax(lam: float, n: int) -> np.ndarray:
    return np.asarray(jax.random.poisson(jax.random.PRNGKey(3), lam, (n,)),
                      np.float64)


def chi2_p(x: np.ndarray, lam: float) -> float:
    """p-value of Pearson's chi-square of the sample ``x`` against the
    Poisson(lam) pmf: one bin per k whose expected count is >= 5, and the
    two tails."""
    n = x.size
    k = np.arange(int(poisson.ppf(1 - 1e-12, lam)) + 2)
    keep = k[n * poisson.pmf(k, lam) >= 5]
    lo, hi = keep[0], keep[-1]
    inner = np.arange(lo, hi + 1)
    obs = np.array([np.sum(x < lo)] + [np.sum(x == j) for j in inner]
                   + [np.sum(x > hi)], float)
    exp = n * np.concatenate([[poisson.cdf(lo - 1, lam)],
                              poisson.pmf(inner, lam),
                              [poisson.sf(hi, lam)]])
    m = exp > 0
    return float(chi2.sf(((obs[m] - exp[m]) ** 2 / exp[m]).sum(),
                         m.sum() - 1))


@pytest.mark.parametrize("lam", LAMS)
def test_moments_match_the_law_and_jax(lam):
    """Mean and variance at each lambda within 5 sigma of the law, and of
    jax.random.poisson's sample of the same size; integer values >= 0."""
    n = 20_000
    x, j = _exact(lam, n).astype(np.float64), _jax(lam, n)
    assert np.array_equal(x, np.round(x)) and x.min() >= 0.0
    se_mean = math.sqrt(lam / n)
    se_var = math.sqrt((lam + 2.0 * lam * lam) / n)
    assert abs(x.mean() - lam) < 5 * se_mean
    assert abs(x.var() - lam) < 5 * se_var
    assert abs(x.mean() - j.mean()) < 5 * math.sqrt(2.0) * se_mean
    assert abs(x.var() - j.var()) < 5 * math.sqrt(2.0) * se_var


@pytest.mark.parametrize("lam", [2.5, 5.0, 20.0])
def test_pmf_chi_square(lam):
    """The pmf's chi-square passes (p > 1e-3) for the exact sampler and
    for jax.random.poisson at the same size; at lambda = 5 the default
    three-regime sampler fails it (p < 1e-6): the test can tell."""
    n = 50_000
    assert chi2_p(_exact(lam, n), lam) > 1e-3
    assert chi2_p(_jax(lam, n), lam) > 1e-3
    if lam == 5.0:
        assert chi2_p(_fast(lam, n), lam) < 1e-6


def test_zero_and_negative_lambda_give_exactly_zero():
    lam = torch.tensor([0.0, -1.0, -0.0, 1e-30])
    x = rnd.exact_poisson(lam, 1, 2, 3, torch.arange(4), rnd.TAG_BG_UNIFORM)
    assert x[:3].tolist() == [0.0, 0.0, 0.0] and x[3] == 0.0


def test_draw_depends_only_on_counters():
    """A draw is a function of (key, read, pixel, tag): the same element
    gives the same value alone or in any batch, and another read, pixel
    or tag gives an independent one."""
    lam = torch.tensor([0.7, 4.0, 12.0, 300.0])
    pix = torch.tensor([5, 77, 1000, 3])
    full = rnd.exact_poisson(lam, 9, 8, 2, pix, rnd.TAG_BAND_UNIFORM)
    for i in range(4):
        one = rnd.exact_poisson(lam[i:i + 1], 9, 8, 2, pix[i:i + 1],
                                rnd.TAG_BAND_UNIFORM)
        assert one.item() == full[i].item()
    big = torch.full((4000,), 30.0)
    a = rnd.exact_poisson(big, 9, 8, 2, torch.arange(4000), 2)
    b = rnd.exact_poisson(big, 9, 8, 3, torch.arange(4000), 2)
    assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 0.1


def test_log_factorial_and_kernel_constants():
    """log k! matches lgamma to float32 round-off on the table and the
    Stirling side; the kernel source carries the same table, thresholds,
    block counts and PTRS constants as the plain version."""
    k = torch.tensor([0.0, 1, 2, 9, 15, 16, 17, 40, 1000, 1e6])
    want = np.array([math.lgamma(v + 1.0) for v in k.tolist()])
    np.testing.assert_allclose(rnd.log_factorial(k).numpy(), want,
                               rtol=2e-7, atol=1e-7)
    src = open(DETECTOR).read()
    table = re.search(r"kLogFactorial\[16\] = \{([^}]*)\}", src).group(1)
    vals = [float(v.strip().rstrip("f")) for v in table.split(",")]
    assert [float(np.float32(v)) for v in vals] == list(rnd.LOG_FACTORIAL)
    assert f"EXACT_T = {rnd.EXACT_T:.1f}f" in src
    assert f"KNUTH_BLOCKS = {rnd.KNUTH_BLOCKS};" in src
    assert f"PTRS_BLOCKS = {rnd.PTRS_BLOCKS};" in src
    for c in ("0.931f", "2.53f", "-0.059f", "0.02483f", "1.1239f",
              "1.1328f", "3.4f", "0.9277f", "3.6224f", "0.43f", "0.07f",
              "0.013f", "0.918938518f", "0.0833333358f", "0.00277777785f"):
        assert c in src, c
    assert float(np.float32(0.918938518)) == rnd._HALF_LOG_2PI
    assert float(np.float32(0.0833333358)) == rnd._INV12
    assert float(np.float32(0.00277777785)) == rnd._INV360


def _readout_args(B=2, NR=4, W=16, S=64, n_cr=4):
    g = torch.Generator().manual_seed(5)
    r = lambda *shape: torch.rand(shape, generator=g)
    dts = torch.full((B, NR), 3.0)
    dts[:, 0] = 0.0
    bands = 40.0 * r(B, NR, W, S)
    bands[:, 0] = 0.0
    y0s = torch.tensor([0, 8, 24, 40], dtype=torch.int32).expand(B, NR)
    bg = 4.0 * r(B, S, S)
    bg[:, :, :3] = 0.0
    cr_pos = torch.randint(0, S, (B, NR, 2, n_cr), generator=g,
                           dtype=torch.int32)
    cr_q = 500.0 * r(B, NR, n_cr)
    cr_q[:, 0] = 0.0
    seed = torch.tensor([[3, 7], [-1, 9]], dtype=torch.int32)[:B]
    return (seed, y0s.contiguous(), dts, bands, bg, 1000.0 + r(S, S),
            1.0 / (2.5 + 0.02 * r(S, S)),
            torch.tensor([0.012, 0.012, 0.016])[:, None, None]
            * torch.ones(3, S, S), cr_pos, cr_q, (20.0, 78000.0, 2.5, 0.015))


@pytest.mark.parametrize("ipc", [False, True])
def test_exact_readout_per_read_equals_whole_exposure(ipc):
    """In exact mode, as by default, the per-read steps (B2's and B3's
    plain versions) draw exactly what the whole-exposure readout draws:
    the same reads bit for bit (B3 to rtol 1e-5: it sums in another
    order); and exact mode changes the draws."""
    args = _readout_args()
    seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q, c = args
    B, NR, W, S = bands.shape
    flags = dict(ipc=ipc, exact_poisson=True)
    whole, cum_w = exposure_readout(*args, **flags)
    default, _ = exposure_readout(*args, ipc=ipc)
    assert not torch.equal(whole, default)
    cum = torch.zeros((B, S, S))
    for k in range(NR):
        cum, dn = read_step_banded(
            seed, k, y0s[:, k].contiguous(), dts[:, k].contiguous(), cum,
            bands[:, k].contiguous(), bg, bias, inv_gain, nl,
            cr_pos[:, k].contiguous(), cr_q[:, k].contiguous(), c, **flags)
        assert torch.equal(dn, whole[:, k])
    assert torch.equal(cum, cum_w)
    if ipc:
        return
    # the full-frame step on the band sampled in torch (exact) + no hits
    no_cr = dict(with_cr=False, exact_poisson=True)
    whole, _ = exposure_readout(*args, **no_cr)
    cum = torch.zeros((B, S, S))
    for k in range(NR):
        rows = y0s[:, k].long()[:, None] + torch.arange(W)
        frame = torch.zeros((B, S, S)).scatter(
            1, rows[:, :, None].expand(B, W, S), bands[:, k])
        frame = sample_band(seed, k, torch.zeros_like(y0s[:, k]), frame,
                            exact_poisson=True)
        cum, dn = read_step(seed, k, dts[:, k].contiguous(), cum, frame, bg,
                            bias, inv_gain, nl, c, exact_poisson=True)
        torch.testing.assert_close(dn, whole[:, k], rtol=1e-5, atol=0)


def _static_t(cfg_j: ExposureStatic) -> config_t.ExposureStatic:
    kw = dataclasses.asdict(cfg_j)
    kw["noise"] = config_t.NoiseFlags(**kw["noise"])
    return config_t.ExposureStatic(**kw)


def test_poisson_only_exposure_matches_jax_law():
    """A Poisson-only ``simulate_exposure(exact_poisson=True)`` (sky, dark
    and the spectrum on, every other effect off), port against the JAX
    package's XLA path (jax.random.poisson), over 24 seeds each: reads
    are integer charges over the scalar gain, and each pixel's last-read
    mean across seeds agrees within 5 sigma; both packages' pooled
    variance-to-mean ratio is 1 within 5 sigma."""
    S, NL, NSAMP, N = 64, 32, 2, 24
    flags = dataclasses.replace(NoiseFlags.none(), poisson=True, sky=True,
                                dark=True)
    cfg = ExposureStatic(subarray=S, n_lambda=NL, n_sub=2, nsamp=NSAMP,
                         samp_seq="RAPID", scan=False, noise=flags,
                         exact_poisson=True, transit_quad=16)
    tables = synthetic_tables("G141", subarray=S, n_lambda=NL,
                              samp_seq="RAPID", nsamp=NSAMP)
    # the spectrum's pixels take the PTRS branch, the sky and dark Knuth's
    scene = dataclasses.replace(
        example_scene(NL, scan_speed=0.0), x_ref=jnp.float32(10.0),
        y_ref=jnp.float32(30.0))
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    ref = np.stack([np.asarray(simulate_exposure_j(
        dataclasses.replace(scene, key=k), tables, cfg).reads_dn)
        for k in keys]) * 2.5
    batched = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[scene] * N)
    scenes_t = scenes_from_numpy(numpy_leaves(batched), "cpu")
    scenes_t.seed = rnd.seed_words(7, torch.arange(N))
    got = simulate_exposure(scenes_t, tables_from_numpy(
        numpy_leaves(tables), "cpu"), _static_t(cfg)).reads_dn.numpy() * 2.5
    for x in (got, ref):
        np.testing.assert_allclose(x, np.round(x), atol=2e-3)
    last_p, last_j = got[:, -1], ref[:, -1]
    assert last_p.max() > 100.0 and np.median(last_p) < 10.0   # both
    m_p, m_j = last_p.mean(0), last_j.mean(0)
    se = np.sqrt((last_p.var(0, ddof=1) + last_j.var(0, ddof=1)) / N)
    ok = se > 0
    assert np.abs((m_p - m_j)[ok] / se[ok]).max() < 5.0
    lit = m_j > 0.5
    for x in (last_p, last_j):
        ratio = x.var(0, ddof=1)[lit].sum() / x.mean(0)[lit].sum()
        assert abs(ratio - 1.0) < 5.0 * math.sqrt(2.0 / (N - 1)
                                                  / lit.sum())

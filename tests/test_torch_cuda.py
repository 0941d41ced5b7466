"""Tests of the port that need a CUDA card (marker ``cuda``); they skip on
a machine without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed (the repo's conftest imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from wayne_tpu_torch.config import config_from_dict
from wayne_tpu_torch.io.ima import read_ima
from wayne_tpu_torch.observation import Observation
from wayne_tpu_torch.ops.readout import (
    exposure_readout, exposure_readout_plain, read_step, read_step_banded,
    read_step_banded_plain, read_step_plain, sample_band,
)

torch.set_num_threads(1)

TINY = {"grism": "G141", "subarray": 128, "NSAMP": 4, "SAMPSEQ": "SPARS10",
        "scan": True, "x_ref": 30.0, "y_ref": 40.0, "num_orbits": 1,
        "exposures_per_orbit": 5, "n_lambda": 64, "n_sub": 4}
DETERMINISTIC = {"preset": "all", "poisson": False, "read_noise": False,
                 "cosmic_rays": False, "bias_drift": False}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_cuda.py --noconftest -m cuda)")
    return torch.device("cuda")


def _readout_inputs(dev, B=3, NR=5, W=32, S=128, n_cr=6):
    g = torch.Generator().manual_seed(3)
    r = lambda *shape: torch.rand(shape, generator=g)
    dts = torch.full((B, NR), 2.9)
    dts[:, 0] = 0.0
    bands = 800.0 * r(B, NR, W, S)
    bands[:, 0] = 0.0
    y0s = torch.tensor([0, 8, 48, 96, 88], dtype=torch.int32).expand(B, NR)
    bg = 3.0 * r(B, S, S)
    bg[:, :, :4] = 0.0
    cr_pos = torch.randint(0, S, (B, NR, 2, n_cr), generator=g,
                           dtype=torch.int32)
    cr_pos[:, 2, :, :2] = torch.tensor([[10, 10], [31, 31]], dtype=torch.int32)
    cr_q = 1000.0 * r(B, NR, n_cr)
    cr_q[:, 0] = 0.0
    args = (torch.tensor([[3, 7], [-1, 9], [5, -5]], dtype=torch.int32)[:B],
            y0s.contiguous(), dts, bands, bg,
            1000.0 + r(S, S), 1.0 / (2.5 + 0.02 * r(S, S)),
            torch.tensor([0.012, 0.012, 0.016])[:, None, None]
            * (1 + 0.03 * r(3, S, S)), cr_pos, cr_q)
    consts = (20.0, 78000.0, 2.5, 0.015)          # host scalars
    return tuple(a.to(dev).contiguous() for a in args) + (consts,)


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("ipc", [False, True])
def test_kernel_matches_plain(card, noise, ipc):
    """Kernel = plain version on the same card (the same Philox draws)."""
    args = _readout_inputs(card)
    kw = dict(poisson=noise, read_noise=noise, ipc=ipc)
    got, cum = exposure_readout(*args, **kw)
    want, cum_w = exposure_readout_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(cum, cum_w, rtol=1e-5, atol=0)
    assert exposure_readout(*args, **kw)[0].equal(got)     # reproducible


def _edge_inputs(dev, B, NR, W, S, n_cr, crowd):
    """Readout inputs at an edge of the kernel's tiling and hit staging:
    bands at any row, zero, small-lambda and Gaussian background columns,
    and in every read with hits (all but read 0) a hit pair on one pixel
    that is hit again in every read, plus ``crowd`` hits packed into one
    8 x 8 patch (zero charges scattered among them)."""
    g = torch.Generator().manual_seed(S * 1000 + NR * 10 + n_cr)
    r = lambda *shape: torch.rand(shape, generator=g)
    dts = torch.full((B, NR), 2.9)
    dts[:, 0] = 0.0
    bands = 800.0 * r(B, NR, W, S) ** 3                  # many small values
    bands[:, 0] = 0.0
    y0s = torch.randint(0, S - W + 1, (B, NR), generator=g, dtype=torch.int32)
    bg = 3.0 * r(B, S, S)
    bg[:, :, :3] = 0.0
    cr_pos = torch.randint(0, S, (B, NR, 2, n_cr), generator=g,
                           dtype=torch.int32)
    c = min(crowd, n_cr - 2)
    corner = S // 2 - 4
    cr_pos[:, :, :, 2:2 + c] = corner + torch.randint(
        0, 8, (B, NR, 2, c), generator=g, dtype=torch.int32)
    cr_pos[:, :, :, :2] = S // 3                     # one pixel, every read
    cr_q = 1000.0 * r(B, NR, n_cr)
    cr_q[:, :, 5::7] = 0.0
    cr_q[:, 0] = 0.0
    args = (torch.tensor([[3, 7], [-1, 9], [5, -5]], dtype=torch.int32)[:B],
            y0s, dts, bands, bg, 1000.0 + r(S, S),
            1.0 / (2.5 + 0.02 * r(S, S)),
            torch.tensor([0.012, 0.012, 0.016])[:, None, None]
            * (1 + 0.03 * r(3, S, S)), cr_pos, cr_q)
    return tuple(a.to(dev).contiguous() for a in args) + (
        (20.0, 78000.0, 2.5, 0.015),)


# (B, NR, W, S, n_cr, hits crowded into one patch)
EDGES = {
    "S=100": (2, 4, 16, 100, 8, 0),             # not a multiple of a tile
    "S=136": (2, 4, 32, 136, 8, 0),
    "NR=1": (2, 1, 32, 64, 8, 0),
    "W=S": (1, 5, 96, 96, 8, 0),                # the direct image's window
    "crowded tile": (2, 6, 32, 128, 64, 60),    # every hit in one tile
    "staging > 48 KB": (1, 5, 32, 64, 1024, 200),
    "staged in groups": (1, 5, 32, 64, 2048, 200),  # re-staged mid-exposure
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", sorted(EDGES))
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("ipc", [False, True])
def test_kernel_matches_plain_bit_for_bit_at_edges(card, edge, noise, ipc):
    """Kernel = plain version bit for bit at the edges of its tiling and
    hit staging: frames that no tile divides, one read, a band as tall as
    the frame, hits crowded into one tile with repeats on one pixel within
    a read and across reads, and hit lists whose staging exceeds 48 KB of
    shared memory or is staged in several groups of reads."""
    args = _edge_inputs(card, *EDGES[edge])
    kw = dict(poisson=noise, read_noise=noise, ipc=ipc)
    got, cum = exposure_readout(*args, **kw)
    want, cum_w = exposure_readout_plain(*args, **kw)
    assert torch.equal(got, want) and torch.equal(cum, cum_w)
    assert exposure_readout(*args, **kw)[0].equal(got)     # reproducible


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(card):
    args = list(_readout_inputs(card))
    args[4] = args[4].cpu()                                  # bg on the CPU
    with pytest.raises(ValueError, match="bg_rate"):
        exposure_readout(*args)
    args = list(_readout_inputs(card))
    args[1] = args[1].to(torch.int64)                        # y0s dtype
    with pytest.raises(TypeError, match="y0s"):
        exposure_readout(*args)


def _step_inputs(dev, B=3, W=32, S=128, n_cr=6):
    """One read's inputs: charge, an expected band at unaligned rows, the
    full-frame add, hits (two on one pixel) and the shared planes."""
    g = torch.Generator().manual_seed(4)
    r = lambda *shape: torch.rand(shape, generator=g)
    cr_pos = torch.randint(0, S, (B, 2, n_cr), generator=g,
                           dtype=torch.int32)
    cr_pos[:, :, 1] = cr_pos[:, :, 0]
    cr_q = 1000.0 * r(B, n_cr)
    cr_q[:, -1] = 0.0
    bg = 3.0 * r(B, S, S)
    bg[:, :, :4] = 0.0
    t = dict(seed=torch.tensor([[3, 7], [-1, 9], [5, -5]],
                               dtype=torch.int32)[:B],
             y0=torch.tensor([0, 41, 93], dtype=torch.int32)[:B],
             dt=torch.tensor([0.0, 2.9, 5.0])[:B], cum=7e4 * r(B, S, S),
             band=torch.round(800.0 * r(B, W, S)), add=800.0 * r(B, S, S),
             bg_rate=bg, bias_map=1000.0 + r(S, S),
             inv_gain=1.0 / (2.5 + 0.02 * r(S, S)),
             nl_coeffs=torch.tensor([0.012, 0.012, 0.016])[:, None, None]
             * (1 + 0.03 * r(3, S, S)), cr_pos=cr_pos, cr_q=cr_q)
    t = {k: v.to(dev).contiguous() for k, v in t.items()}
    t["consts"] = (20.0, 78000.0, 2.5, 0.015)             # host scalars
    return t


def _banded_args(t):
    return {k: v for k, v in t.items() if k != "add"}


def _full_frame_args(t):
    return {k: v for k, v in t.items()
            if k not in ("y0", "band", "cr_pos", "cr_q")}


def _banded_reference(**kw):
    """The banded step's plain reference: the expected band sampled when
    ``poisson``, then the plain step."""
    if kw["poisson"]:
        kw = dict(kw, band=sample_band(kw["seed"], kw["read"], kw["y0"],
                                       kw["band"],
                                       kw.get("exact_poisson", False)))
    return read_step_banded_plain(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("ipc", [False, True])
def test_banded_step_matches_plain(card, noise, ipc):
    """The banded read step's kernel = its plain version on the card (the
    expected band drawn in the kernel; sampled by ``sample_band`` for the
    plain version)."""
    args = _banded_args(_step_inputs(card))
    kw = dict(poisson=noise, read_noise=noise, ipc=ipc)
    cum, dn = read_step_banded(read=7, **args, **kw)
    cum_w, dn_w = _banded_reference(read=7, **args, **kw)
    torch.testing.assert_close(dn, dn_w, rtol=1e-5, atol=0)
    torch.testing.assert_close(cum, cum_w, rtol=1e-5, atol=0)
    assert read_step_banded(read=7, **args, **kw)[1].equal(dn)


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [False, True])
def test_full_frame_step_matches_plain(card, noise):
    """The full-frame read step's kernel = its plain version on the card."""
    args = _full_frame_args(_step_inputs(card))
    kw = dict(poisson=noise, read_noise=noise)
    cum, dn = read_step(read=7, **args, **kw)
    cum_w, dn_w = read_step_plain(read=7, **args, **kw)
    torch.testing.assert_close(dn, dn_w, rtol=1e-5, atol=0)
    torch.testing.assert_close(cum, cum_w, rtol=1e-5, atol=0)
    assert read_step(read=7, **args, **kw)[1].equal(dn)


def _step_edge_inputs(dev, B, W, S, n_cr, crowd, rows):
    """One read's inputs at an edge of the per-read kernels' tiling: the
    expected band (many small values) at ``rows`` ("any", "bottom" or
    "unaligned" y0), zero, small-lambda and Gaussian background columns, a
    hit pair on one pixel and ``crowd`` hits packed into one 8 x 8 patch
    (zero charges scattered among them)."""
    g = torch.Generator().manual_seed(S * 100 + W + n_cr)
    r = lambda *shape: torch.rand(shape, generator=g)
    y0 = {"any": torch.randint(0, S - W + 1, (B,), generator=g),
          "bottom": torch.full((B,), S - W),
          "unaligned": torch.tensor([3, 41, 93])[:B]}[rows]
    bg = 3.0 * r(B, S, S)
    bg[:, :, :3] = 0.0
    cr_pos = torch.randint(0, S, (B, 2, n_cr), generator=g,
                           dtype=torch.int32)
    c = min(crowd, n_cr - 2)
    cr_pos[:, :, 2:2 + c] = S // 2 - 4 + torch.randint(
        0, 8, (B, 2, c), generator=g, dtype=torch.int32)
    cr_pos[:, :, :2] = S // 3                          # one pixel, twice
    cr_q = 1000.0 * r(B, n_cr)
    cr_q[:, 5::7] = 0.0
    t = dict(seed=torch.tensor([[3, 7], [-1, 9], [5, -5]],
                               dtype=torch.int32)[:B],
             y0=y0.to(torch.int32), dt=torch.tensor([2.9, 5.0, 0.7])[:B],
             cum=5e4 * r(B, S, S), band=800.0 * r(B, W, S) ** 3,
             add=800.0 * r(B, S, S), bg_rate=bg,
             bias_map=1000.0 + r(S, S), inv_gain=1.0 / (2.5 + 0.02 * r(S, S)),
             nl_coeffs=torch.tensor([0.012, 0.012, 0.016])[:, None, None]
             * (1 + 0.03 * r(3, S, S)), cr_pos=cr_pos, cr_q=cr_q)
    t = {k: v.to(dev).contiguous() for k, v in t.items()}
    t["consts"] = (20.0, 78000.0, 2.5, 0.015)
    return t


# (B, W, S, n_cr, hits crowded into one patch, band rows)
STEP_EDGES = {
    "S=100": (2, 16, 100, 8, 0, "any"),         # not a multiple of a tile
    "S=136": (2, 32, 136, 8, 0, "any"),
    "odd S=77": (2, 16, 77, 8, 0, "any"),       # B3: no 4-pixel alignment
    "W=S": (2, 96, 96, 8, 0, "any"),            # the band-off window
    "band at the bottom rows": (2, 32, 128, 8, 0, "bottom"),
    "unaligned y0": (3, 32, 128, 8, 0, "unaligned"),
    "crowded tile": (2, 32, 128, 64, 60, "any"),  # every hit in one tile
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", sorted(STEP_EDGES))
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("ipc", [False, True])
def test_banded_step_matches_plain_bit_for_bit_at_edges(card, edge, noise,
                                                        ipc):
    """The banded step's kernel = its plain reference bit for bit at the
    edges of its tiling and hit staging, the band drawn in the kernel."""
    args = _banded_args(_step_edge_inputs(card, *STEP_EDGES[edge]))
    kw = dict(poisson=noise, read_noise=noise, ipc=ipc)
    cum, dn = read_step_banded(read=5, **args, **kw)
    cum_w, dn_w = _banded_reference(read=5, **args, **kw)
    assert torch.equal(dn, dn_w) and torch.equal(cum, cum_w)
    assert read_step_banded(read=5, **args, **kw)[1].equal(dn)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", sorted(STEP_EDGES))
@pytest.mark.parametrize("noise", [False, True])
def test_full_frame_step_matches_plain_bit_for_bit_at_edges(card, edge,
                                                            noise):
    """The full-frame step's kernel = its plain version bit for bit at
    frames that no tile or 4-pixel group divides."""
    args = _full_frame_args(_step_edge_inputs(card, *STEP_EDGES[edge]))
    kw = dict(poisson=noise, read_noise=noise)
    cum, dn = read_step(read=5, **args, **kw)
    cum_w, dn_w = read_step_plain(read=5, **args, **kw)
    assert torch.equal(dn, dn_w) and torch.equal(cum, cum_w)


@pytest.mark.cuda
def test_steps_reject_bad_inputs(card):
    t = _step_inputs(card)
    with pytest.raises(ValueError, match="bg_rate"):
        read_step_banded(read=1, **dict(_banded_args(t),
                                        bg_rate=t["bg_rate"].cpu()))
    with pytest.raises(TypeError, match="y0"):
        read_step_banded(read=1, **dict(_banded_args(t),
                                        y0=t["y0"].to(torch.int64)))
    with pytest.raises(ValueError, match="cum"):
        read_step(read=1, **dict(_full_frame_args(t), cum=t["cum"][:1]))
    with pytest.raises(ValueError, match="contiguous"):
        read_step(read=1, **dict(_full_frame_args(t),
                                 add=t["add"].transpose(1, 2)))


@pytest.mark.cuda
def test_per_read_route_on_the_card(card):
    """A tiny visit through the per-read kernels (fused_reads=False): the
    deterministic effects agree with the CPU's plain versions to the
    tolerance of tests/test_torch_observation.py, and with the noise on
    the reads equal the whole-exposure route's on >= 99.9% of pixels."""
    def simulate(noise, dev, fused, band):
        obs = Observation(config_from_dict(dict(TINY, noise=noise)),
                          device=dev)
        obs.static = dataclasses.replace(obs.static, fused_reads=fused,
                                         band_px=band)
        return obs.simulate(chunk=4).reads_dn.cpu()
    # band 0 without IPC runs the full-frame step, else the banded one
    for band, ipc in ((0, False), (0, True), (32, True)):
        quiet = dict(DETERMINISTIC, ipc=ipc)
        got = simulate(quiet, "cuda", False, band)
        want = simulate(quiet, "cpu", False, band)
        torch.testing.assert_close(got, want, rtol=2e-5,
                                   atol=max(1e-3, 5e-6 * float(want.max())))
        noisy = {"preset": "all", "ipc": ipc}
        per = simulate(noisy, "cuda", False, band)
        fused = simulate(noisy, "cuda", True, band)
        assert float((per == fused).float().mean()) >= 0.999, (band, ipc)


@pytest.mark.cuda
def test_generate_on_the_card_matches_cpu(card, tmp_path):
    """A tiny visit on the card (readout kernel, pinned async host copies,
    on-device uint16 quantization) and on the CPU (plain version): the
    deterministic effects agree to the tolerance of
    tests/test_torch_observation.py; with the noise on, the integer DN
    agree except where the two devices' float32 transcendentals round a
    Poisson draw differently."""
    for noise, exact in ((DETERMINISTIC, True), ({"preset": "all"}, False)):
        params = dict(TINY, noise=noise, quantize_adc=not exact)
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = str(tmp_path / f"{dev}{exact}")
            Observation(config_from_dict(params), device=dev).generate(
                outs[dev], chunk=4, progress=lambda s: None)
        names = sorted(os.listdir(outs["cpu"]))
        assert names == sorted(os.listdir(outs["cuda"])) and len(names) == 6
        for name in names:
            hc, rc, _ = read_ima(os.path.join(outs["cuda"], name))
            hp, rp, _ = read_ima(os.path.join(outs["cpu"], name))
            assert hc == hp, name
            if exact:
                np.testing.assert_allclose(
                    rc, rp, rtol=2e-5, atol=max(1e-3, 5e-6 * float(rp.max())))
            else:   # spectra are quantized; the direct image is not
                if name.endswith("_ima.fits"):
                    assert np.array_equal(rc, np.round(rc)), name
                assert float(np.isclose(rc, rp, rtol=0, atol=1e-3).mean()
                             ) > 0.99, name


# --- the Monte-Carlo dataset path -------------------------------------------

DATASET = dict(TINY, subarray=64, x_ref=10.0, y_ref=10.0, n_lambda=32)


def _dataset(out, dev, noise, n_mc=4, chunk_mc=2, chunk=2):
    from wayne_tpu_torch.parallel.dataset import (
        generate_dataset, load_dataset,
    )
    obs = Observation(config_from_dict(dict(DATASET, noise=noise)),
                      device=dev)
    generate_dataset(obs.scenes, obs.tables, obs.static, str(out),
                     n_mc=n_mc, chunk_mc=chunk_mc, device=dev, chunk=chunk)
    return load_dataset(str(out))["spectra_e"]


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [{"preset": "none"}, DETERMINISTIC],
                         ids=["none", "deterministic"])
def test_generate_dataset_on_the_card_matches_cpu(card, tmp_path, noise):
    """generate_dataset on the card (B1, NLINCORR and the extraction on the
    device) against the same call with device="cpu", the noise off: rtol
    1e-5 with an absolute floor of 1e-5 of the largest column (faint PSF
    wings are float32 erf values the two devices round differently)."""
    got = _dataset(tmp_path / "cuda", "cuda", noise)
    want = _dataset(tmp_path / "cpu", "cpu", noise)
    assert got.shape == (4, 5, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.cuda
def test_ensemble_launches_b1_once_per_exposure_batch(card, tmp_path):
    """4 realisations of 5 exposures in batches of 2 (the last padded): 3
    B1 launches a realisation, 12 in all, no per-read step."""
    for f in (exposure_readout, read_step_banded, read_step):
        f.launches = 0
    _dataset(tmp_path, "cuda", {"preset": "all"})
    assert exposure_readout.launches == 4 * 3
    assert read_step_banded.launches == 0 and read_step.launches == 0


@pytest.mark.cuda
def test_generate_dataset_chunk_size_invariant_on_the_card(card, tmp_path):
    """The whole noise chain on: realisations chunked 2 and 4 per file give
    bit-identical spectra on the card, and so do 2 and 5 exposures per
    launch."""
    a = _dataset(tmp_path / "two", "cuda", {"preset": "all"}, chunk_mc=2)
    b = _dataset(tmp_path / "four", "cuda", {"preset": "all"}, chunk_mc=4)
    c = _dataset(tmp_path / "five", "cuda", {"preset": "all"}, chunk=5)
    assert np.isfinite(a).all() and not np.array_equal(a[0], a[1])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


@pytest.mark.cuda
def test_extract_spectra_cr_on_the_card_matches_cpu(card):
    """One batch's noisy reads and hit lists (cosmic rays on), extracted on
    the card and on the CPU: rtol 1e-5 with a floor of 1e-5 of the largest
    column (the two devices sum in other orders)."""
    from wayne_tpu_torch.ops.exposure import simulate_exposure
    from wayne_tpu_torch.parallel.ensemble import mc_scenes
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.reduction import extract_spectra_cr

    obs = Observation(config_from_dict(dict(DATASET, noise={"preset": "all"})),
                      device="cuda")
    obs.tables.cr_rate_px_s.fill_(2e-4)
    res = simulate_exposure(tree_map(lambda x: x[0], mc_scenes(obs.scenes, 1)),
                            obs.tables, obs.static)
    assert int(res.cr_count.sum()) > 10
    for rt in (None, obs.tables.read_times):
        got = extract_spectra_cr(res.reads_dn, res.cr_pos, res.cr_count, rt)
        want = extract_spectra_cr(
            res.reads_dn.cpu(), res.cr_pos.cpu(), res.cr_count.cpu(),
            None if rt is None else rt.cpu())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


# --- the visit-level physics -------------------------------------------------

# a tiny visit with every systematic on: persistence (with the direct
# image), RECTE, a companion 12 rows up in the band, starspots, unstable
# pixels, IPC
PHYSICS = dict(TINY, persistence=True, recte=True, unstable_pixel_frac=0.01,
               companions=[{"dx_px": 8.0, "dy_px": 12.0,
                            "temperature_k": 3200.0, "mag_j": 10.5}],
               target={"spots": [{"lon_deg": -1.0, "lat_deg": 41.8,
                                  "radius": 0.1, "temp_k": 3800.0}],
                       "rotation_period_d": 15.6},
               trends={"hook_amplitude": 0.0})


def _recorded(module, name, run, index=0):
    """``run()`` with ``module.name`` wrapped: the keyword arguments of its
    call number ``index``."""
    real, seen = getattr(module, name), []

    def record(*args, **kw):
        assert not args
        seen.append(kw)
        return real(**kw)

    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, real)
    return seen[index]


def _physics_observation(noise):
    obs = Observation(config_from_dict(dict(PHYSICS, noise=noise)),
                      device="cuda")
    obs._ensure_persistence(4)
    obs._ensure_recte(4)
    assert float(obs.scenes.persist_rate.max()) > 0.0
    assert float(obs.scenes.trap_mult.min()) < 1.0
    assert obs.static.band_px and obs.static.noise.ipc
    return obs


@pytest.mark.cuda
def test_b1_and_b2_match_plain_on_a_visit_physics_chunk(card):
    """B1 and B2 against their plain versions on the main path's own
    arguments for a chunk whose background carries persistence, whose
    bands carry the RECTE thinning and a companion: bit for bit, noise on
    (IPC on, as the visit has it) and off."""
    import wayne_tpu_torch.ops.exposure as ex

    obs = _physics_observation({"preset": "all", "ipc": True})
    kw = _recorded(ex, "exposure_readout", lambda: obs.simulate(chunk=4))
    assert kw["bg_poisson"] and kw["ipc"]
    for noise in (True, False):
        f = dict(kw, poisson=noise, read_noise=noise)
        got, cum = exposure_readout(**f)
        want, cum_w = exposure_readout_plain(**f)
        assert torch.equal(got, want) and torch.equal(cum, cum_w), noise

    obs.static = dataclasses.replace(obs.static, fused_reads=False)
    nr = obs.static.nsamp + 1
    kw = _recorded(ex, "read_step_banded", lambda: obs.simulate(chunk=4),
                   index=nr // 2)
    assert kw["read"] == nr // 2 and float(kw["band"].max()) > 0.0
    for noise in (True, False):
        f = dict(kw, poisson=noise, read_noise=noise)
        cum, dn = read_step_banded(**f)
        cum_w, dn_w = _banded_reference(**f)
        assert torch.equal(dn, dn_w) and torch.equal(cum, cum_w), noise


@pytest.mark.cuda
def test_visit_physics_on_the_card_matches_cpu(card):
    """The tiny every-systematic visit, the deterministic effects on, on
    the card and on the CPU (the unstable pixels' states come from the
    same Philox stream on both): the charge-memory maps and the reads
    agree to the tolerance of tests/test_torch_observation.py."""
    outs = {}
    for dev in ("cuda", "cpu"):
        obs = Observation(config_from_dict(dict(PHYSICS,
                                                noise=DETERMINISTIC)),
                          device=dev)
        res = obs.simulate(chunk=4)
        outs[dev] = (res.reads_dn.cpu(), obs.scenes.persist_rate.cpu(),
                     obs.scenes.trap_mult.cpu())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=2e-5,
                                   atol=max(1e-3, 5e-6 * float(want.max())))


@pytest.mark.cuda
def test_program_on_the_card(card, tmp_path):
    """``run_program`` without ``--cpu`` runs every visit on the card: a
    two-visit program whose second visit reads the first one's carry."""
    import yaml

    from wayne_tpu_torch.run_program import main as run_program

    params = dict(TINY, program={"num_visits": 2}, persistence=True,
                  noise={"preset": "all"})
    yml = tmp_path / "prog.yml"
    yml.write_text(yaml.safe_dump(params))
    exposure_readout.launches = 0
    assert run_program(["-p", str(yml), "-o", str(tmp_path / "out"),
                        "--chunk", "4"]) == 0
    # per visit: the fluence pass and the visit (2 chunks each), the
    # direct image twice (its ideal stimulus and its product)
    assert exposure_readout.launches == 2 * (2 + 2 + 2)
    summary = (tmp_path / "out" / "program_summary.json").read_text()
    assert summary.count('"carry"') == 2
    assert (tmp_path / "out" / "visit_00" / "carry_fluence.npy").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("ipc", [False, True])
@pytest.mark.parametrize("edge", ["S=136", "crowded tile", "W=S"])
def test_exact_mode_matches_plain_bit_for_bit(card, edge, ipc):
    """``exact_poisson``: B1, B2 and B3 (the kernels' second
    instantiation, detector.cuh's exact sampler: Knuth on the small
    background, PTRS on the band) = their plain versions bit for bit, a
    second run identical; the default mode still = plain and differs."""
    args = _edge_inputs(card, *EDGES[edge])
    on = dict(poisson=True, read_noise=True, ipc=ipc)
    got, cum = exposure_readout(*args, **on, exact_poisson=True)
    want, cum_w = exposure_readout_plain(*args, **on, exact_poisson=True)
    assert torch.equal(got, want) and torch.equal(cum, cum_w)
    assert exposure_readout(*args, **on, exact_poisson=True)[0].equal(got)
    default, _ = exposure_readout(*args, **on)
    assert torch.equal(default, exposure_readout_plain(*args, **on)[0])
    assert not torch.equal(default, got)
    t = _step_edge_inputs(card, *STEP_EDGES[edge])
    kw = dict(on, exact_poisson=True)
    cum2, dn = read_step_banded(read=5, **_banded_args(t), **kw)
    cum2_w, dn_w = _banded_reference(read=5, **_banded_args(t), **kw)
    assert torch.equal(dn, dn_w) and torch.equal(cum2, cum2_w)
    if not ipc:
        kw = dict(poisson=True, read_noise=True, exact_poisson=True)
        cum3, dn3 = read_step(read=5, **_full_frame_args(t), **kw)
        cum3_w, dn3_w = read_step_plain(read=5, **_full_frame_args(t), **kw)
        assert torch.equal(dn3, dn3_w) and torch.equal(cum3, cum3_w)


@pytest.mark.cuda
def test_write_ima_raises_when_the_native_library_cannot_load(
        card, tmp_path, monkeypatch):
    """No quiet Python write: without g++ and a built library the native
    writer raises naming g++ and leaves no file."""
    from wayne_tpu_torch.io import native
    from wayne_tpu_torch.io.ima import default_primary_header, write_ima

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    reads = np.ones((3, 16, 16), np.float32)
    hdr = default_primary_header(
        targname="T", grism="G141", nsamp=2, samp_seq="RAPID", subarray=64,
        expstart_mjd=56000.0, exptime_s=1.0, scan=False, scan_rate_pix_s=0.0)
    path = tmp_path / "x_ima.fits"
    with pytest.raises(native.NativeWriterError, match="g\\+\\+"):
        write_ima(str(path), reads, np.arange(3.0), hdr)
    assert not path.exists()


# --- the closed reduction loop (no kernel of its own) ----------------------

# a tiny transit visit: 3 orbits of 6 exposures, the second orbit in the
# transit of a 0.81-day orbit, the spectrum on the 128^2 frame
LOOP = dict(TINY, num_orbits=3, exposures_per_orbit=6,
            noise={"preset": "all", "bias_drift": True},
            planet={"period": 0.813475, "t0": 56000.07, "sma_over_rs": 4.855,
                    "inclination": 82.1, "rp_over_rs": 0.155},
            start_mjd=56000.0)


def _loop_visit(tmp_path):
    import yaml
    yml = tmp_path / "loop.yml"
    yml.write_text(yaml.safe_dump(LOOP))
    obs = Observation(config_from_dict(LOOP), device="cuda")
    paths = obs.generate(str(tmp_path / "visit"), chunk=4,
                         progress=lambda s: None)
    return str(yml), obs, paths


@pytest.mark.cuda
def test_calwf3_and_reduce_visit_on_the_card_match_cpu(card, tmp_path):
    """run_calwf3 on the card against --cpu on the same ima files (SCI and
    ERR rtol 1e-5, atol 1e-3 e-/s; DQ, SAMP and TIME exact), then
    reduce_visit of the files' reads (up-the-ramp, DQ repair, amplifier
    offsets; box and optimal) on the card and on the CPU: light curves
    atol 5e-6. ``align`` is not held card against CPU: its centroid
    regressor turns a 1e-7 relative change of the spectra (the two
    devices' sum orders) into up to 1.4e-4 of the channel curves on this
    visit (measured on the CPU by perturbing the reads); that sensitivity
    is the reference algorithm's."""
    from wayne_tpu_torch import reduction as red
    from wayne_tpu_torch.calibration import quadrant_map
    from wayne_tpu_torch.io.fits import read_fits
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.run_calwf3 import main as run_calwf3

    yml, obs, paths = _loop_visit(tmp_path)
    outs = {}
    for where, extra in (("cuda", []), ("cpu", ["--cpu"])):
        outs[where] = str(tmp_path / where)
        assert run_calwf3(["-d", str(tmp_path / "visit"), "-p", yml,
                           "-o", outs[where]] + extra) == 0
    for name in sorted(os.listdir(outs["cpu"])):
        a, b = ({h.get("EXTNAME"): d for h, d in read_fits(
            os.path.join(outs[w], name))[1:]} for w in ("cuda", "cpu"))
        for ext in ("SCI", "ERR"):
            np.testing.assert_allclose(a[ext], b[ext], rtol=1e-5, atol=1e-3)
        for ext in ("DQ", "SAMP", "TIME"):
            np.testing.assert_array_equal(a[ext], b[ext])

    reads, dqs = zip(*[read_ima(p, with_dq=True)[1::2] for p in paths])
    reads = torch.from_numpy(np.stack(reads).astype(np.float32))
    dqs = torch.from_numpy(np.stack(dqs))
    sc = obs.scenes
    mid = sc.exp_start_s + float(obs.tables.read_times[-1]) / 2.0
    orbit = tree_map(lambda x: x[0], sc.orbit)
    assert 0 < int(red.out_of_transit_mask(mid, orbit).sum()) < len(paths)
    for optimal in (False, True):
        got = {}
        for dev in ("cuda", "cpu"):
            got[dev] = red.reduce_visit(
                reads.to(dev), obs.tables.gain.to(dev), mid.to(dev),
                tree_map(lambda x: x.to(dev), orbit), y_window=(30, 80),
                x_window=(60, 128), bg_rows=(96, 128), n_chan=4,
                read_times=obs.tables.read_times.to(dev),
                good_diffs=red.good_diff_masks_from_dq(dqs.to(dev)),
                optimal=optimal, quad_map=quadrant_map(128, device=dev))
        for field in ("white_lc", "channel_lc"):
            torch.testing.assert_close(getattr(got["cuda"], field).cpu(),
                                       getattr(got["cpu"], field), rtol=0,
                                       atol=5e-6)


@pytest.mark.cuda
def test_recovered_labels_on_the_card_match_cpu(card, tmp_path):
    """generate_dataset(recover=...) on the card: its stored labels = a CPU
    spectra_to_depths of its stored spectra (rp atol 1e-5, sigmas rtol
    1e-3, the flags exact), and one spectra_to_depths on the card launches
    as many kernels at 2 channels as at 6."""
    from torch.profiler import ProfilerActivity, profile

    from wayne_tpu_torch import reduction as red
    from wayne_tpu_torch.parallel.dataset import (
        generate_dataset, load_dataset,
    )
    from wayne_tpu_torch.pytree import tree_map

    obs = Observation(config_from_dict(LOOP), device="cuda")
    sc = obs.scenes
    kw = dict(x_window=(60, 128), n_chan=4, subtract_bg=True,
              sigma_components=True)
    rec = dict(kw, exp_mid_s=sc.exp_start_s + float(
        obs.tables.read_times[-1]) / 2.0,
               orbit=tree_map(lambda x: x[0], sc.orbit), ld=sc.ld[0],
               rp0=0.155)
    generate_dataset(sc, obs.tables, obs.static, str(tmp_path), n_mc=4,
                     chunk_mc=2, device="cuda", recover=rec)
    data = load_dataset(str(tmp_path))
    want = red.spectra_to_depths(
        torch.from_numpy(data["spectra_e"]), rec["exp_mid_s"].cpu(),
        tree_map(lambda x: x.cpu(), rec["orbit"]), rec["ld"].cpu(), 0.155,
        **kw)
    np.testing.assert_allclose(data["recovered_rp"], want[0].numpy(),
                               rtol=0, atol=1e-5)
    for key, w in zip(("recovered_rp_sigma", "recovered_rp_sigma_rel",
                       "recovered_rp_sigma_common"), want[1:]):
        np.testing.assert_allclose(data[key], w.numpy(), rtol=1e-3)
    np.testing.assert_array_equal(data["recovered_constrained"],
                                  red.constrained_mask(want[0], want[1]))

    # the host's launch calls: CUPTI drops a few kernel records in a
    # trace of ~16 000 kernels, never a launch call
    sp = torch.from_numpy(data["spectra_e"][:2]).cuda()
    args = (sp, rec["exp_mid_s"], rec["orbit"], rec["ld"], 0.155)
    counts = []
    for n_chan in (2, 6):
        red.spectra_to_depths(*args, **dict(kw, n_chan=n_chan))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            red.spectra_to_depths(*args, **dict(kw, n_chan=n_chan))
            torch.cuda.synchronize()
        counts.append(sum(
            1 for e in prof.profiler.kineto_results.events()
            if re.match(r"cu(da)?Launch\w*Kernel", e.name())))
    assert counts[0] == counts[1] > 0, counts


# --- the white-light fits, run_reduce and the ETC (no kernel of their own)


_ORBIT_S = 95.47 * 60.0                 # HST orbital period


def _fit_inputs(kind, seed=2):
    """(light curve(s), mid-times, orbit, ld) on the CPU, made with the
    port's own models: a transit x the hook trend (5 orbits of 14
    exposures), with ``kind`` "recte"
    the RECTE ramp instead, with "geometry" a shifted, wider,
    lower-inclination ephemeris than the fit's, with
    "clip" two outliers, with "eclipse" 4 channel curves over the
    secondary eclipse, with "phase" 4 channel curves over a whole
    planetary orbit."""
    from wayne_tpu_torch.ops import recte
    from wayne_tpu_torch.ops.kepler import (
        OrbitParams, orbital_phase_angle, projected_separation)
    from wayne_tpu_torch.ops.transit import (
        eclipse_visibility, transit_depth_curve)

    period = 0.813475 * 86400.0
    # the geometry fit needs the transit's middle in an orbit's window
    t0 = 7088.0 if kind == "geometry" else 9700.0
    orbit = OrbitParams.create(period, t0, 4.855, np.deg2rad(82.1))
    ld = torch.tensor([0.65, -0.25, 0.45, -0.2])
    rng = np.random.default_rng(seed)
    if kind in ("eclipse", "phase"):
        if kind == "eclipse":
            c = t0 + period / 2.0
            t = np.linspace(c - 3 * 3600.0, c + 3 * 3600.0, 60)
        else:
            t = np.linspace(0.0, period, 240)
        t = torch.from_numpy(t.astype(np.float32))
        z, front = projected_separation(t, orbit)
        vis = eclipse_visibility(z, front, torch.tensor(0.1595))
        phi = orbital_phase_angle(t, orbit)
        fp = torch.tensor([4e-4, 8e-4, 1.2e-3, 1.5e-3])[:, None]
        mod = (1.0 if kind == "eclipse"
               else 1.0 - 0.6 * 0.5 * (1.0 - torch.cos(phi + 0.3)))
        lc = (1.0 + fp * mod * vis).T * (1.0 + 1e-4 * torch.from_numpy(
            rng.standard_normal((t.numel(), 4)).astype(np.float32)))
        return lc, t, orbit, ld
    t = np.array([k * _ORBIT_S + 60.0 + i * 200.0 for k in range(5)
                  for i in range(14)], np.float32)
    t_orb = (t - 60.0) % _ORBIT_S + 60.0
    truth = orbit
    if kind == "geometry":
        truth = OrbitParams.create(period, t0 + 90.0, 4.855 * 1.04,
                                   np.deg2rad(81.7))
    z, front = projected_separation(torch.from_numpy(t), truth)
    tr = (1.0 - (1.0 - transit_depth_curve(z, torch.tensor(0.1595), ld,
                                           32)) * front).numpy()
    if kind == "recte":
        sys_ = recte.white_ramp(450.0, torch.from_numpy(t - 50.0), 100.0,
                                f0_s=0.3, f0_f=0.6).numpy()
    else:
        amp = np.where(t < _ORBIT_S, 0.006, 0.003)
        sys_ = 1.0 - amp * np.exp(-t_orb / 300.0)
    lc = tr * sys_ * (1.0 - 0.01 / 86400.0 * (t - t[0])) * (
        1.0 + 1e-4 * rng.standard_normal(t.size))
    if kind == "clip":
        lc[5] *= 1.006
        lc[40] *= 1.004
    return (torch.from_numpy(lc.astype(np.float32)), torch.from_numpy(t),
            orbit, ld)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ramp", "geometry", "clip", "recte",
                                  "eclipse", "phase"])
def test_white_fits_on_the_card_match_cpu(card, kind):
    """fit_white_ramp (plain; fit_geometry; clip_sigma on outliers),
    fit_white_recte, fit_eclipse_depths and fit_phase_curve on the card
    against the CPU on the same curves, at the CPU tests' bars: depths
    within max(1e-5, 0.01 sigma) (the phase fit's as in
    tests/test_torch_sky_phase_fits.py::_assert_phase), sigmas rtol 1e-3,
    the clip weights identical."""
    from wayne_tpu_torch import reduction as red
    from wayne_tpu_torch.pytree import tree_map

    lc, t, orbit, ld = _fit_inputs(kind)
    out = {}
    for dev in ("cuda", "cpu"):
        on = (lambda x: x.to(dev))
        args = (on(lc), on(t), tree_map(on, orbit))
        if kind in ("ramp", "geometry", "clip"):
            kw = {"ramp": {}, "geometry": dict(fit_geometry=True),
                  "clip": dict(clip_sigma=4.0)}[kind]
            out[dev] = red.fit_white_ramp(*args, on(ld), 0.15, **kw)
        elif kind == "recte":
            out[dev] = red.fit_white_recte(*args, on(ld), 0.15,
                                           rate_e_s=450.0, exptime_s=100.0)
        elif kind == "eclipse":
            out[dev] = red.fit_eclipse_depths(*args, 0.1595)
        else:
            out[dev] = red.fit_phase_curve(*args, 0.1595)
    got, want = (tree_map(lambda x: x.cpu(), out[d]) if not isinstance(
        out[d], tuple) else tuple(x.cpu() for x in out[d])
        for d in ("cuda", "cpu"))
    if kind == "eclipse":
        (fp_g, sig_g), (fp_w, sig_w) = got, want
        assert bool(((fp_g - fp_w).abs()
                     <= torch.clamp_min(0.01 * sig_w, 1e-5)).all())
        torch.testing.assert_close(sig_g, sig_w, rtol=1e-3, atol=0)
    elif kind == "phase":
        fp = want.fp.abs()
        s_off = want.amp_sigma / want.amp.clamp_min(1e-9)
        for k, bar in (
                ("fp", torch.clamp_min(0.1 * want.fp_sigma, 1e-5)),
                ("amp", torch.maximum(0.1 * want.amp_sigma, 3e-5 / fp)),
                ("offset_rad", torch.maximum(
                    0.1 * s_off, 2e-5 / (want.amp * fp)))):
            assert bool(((getattr(got, k) - getattr(want, k)).abs()
                         <= bar).all()), k
        torch.testing.assert_close(got.fp_sigma, want.fp_sigma, rtol=1e-3,
                                   atol=0)
        rel = (got.amp_sigma / want.amp_sigma - 1.0).abs()
        assert bool((rel <= 1e-3 + 0.2 * want.fp_sigma
                     / want.fp.abs()).all()), rel
    else:
        bar = max(1e-5, 0.01 * float(want.rp_sigma))
        assert abs(float(got.rp) - float(want.rp)) <= bar
        torch.testing.assert_close(got.rp_sigma, want.rp_sigma, rtol=1e-3,
                                   atol=0)
        if kind != "recte":
            assert torch.equal(got.weights, want.weights)
        if kind == "clip":
            assert got.weights[[5, 40]].tolist() == [0.0, 0.0]


@pytest.mark.cuda
def test_run_reduce_and_etc_on_the_card_match_cpu(card, tmp_path):
    """run_reduce on the card against --cpu on the same files (divide-white;
    optimal extraction without detrending), compared with compare_reports
    (the white fits card against CPU: test_white_fits_on_the_card_match_cpu
    and chip_smoke.py phase 10, on visits that constrain them);
    etc.predict on the card against the CPU at rtol 1e-5, the background
    within 4 ulps of the peak charge (one B1 launch, the noise flags
    off)."""
    import json

    from wayne_tpu_torch.etc import predict
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.run_reduce import compare_reports
    from wayne_tpu_torch.run_reduce import main as run_reduce

    yml, obs, paths = _loop_visit(tmp_path)
    for flags in ([], ["--detrend", "none", "--extract", "optimal"]):
        reports = []
        for extra in ([], ["--cpu"]):
            out = str(tmp_path / f"r{len(extra)}.json")
            assert run_reduce(["-d", str(tmp_path / "visit"), "-p", yml,
                               "-o", out, "--n-chan", "4", *flags,
                               *extra]) == 0
            with open(out) as fh:
                reports.append(json.load(fh))
        assert compare_reports(reports[1], reports[0]) == []

    cfg = config_from_dict(TINY)
    ro.exposure_readout.launches = 0
    got = predict(cfg)
    assert ro.exposure_readout.launches == 1
    want = predict(cfg, device="cpu")
    ulp = float(np.spacing(np.float32(max(want.peak_e_per_read))))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "background_e_per_px":   # two charges' difference
            assert abs(a - b) <= 4.0 * ulp, (a, b)
        elif isinstance(b, float) or (isinstance(b, list) and b
                                      and isinstance(b[0], float)):
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f.name)
        else:
            assert a == b, f.name


def _depth_jacobian(dev):
    """The Jacobian of a transit visit's channel sums (6 exposures of a
    128^2 scan, NSAMP 4, the noise off) with respect to four channel
    depths, by ``torch.func.jacfwd`` through the model twin on ``dev``;
    and the whole-exposure kernel's launches in that call."""
    from wayne_tpu_torch import retrieval as ret
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.reduction import _channel_edges, _channel_flux

    cfg = config_from_dict({**TINY, "exposures_per_orbit": 6,
                            "start_mjd": 55999.975, "t0": 56000.0,
                            "period": 0.813475, "rp_over_rs": 0.1595,
                            "noise": DETERMINISTIC})
    obs = Observation(cfg, device=dev)
    twin = ret.deterministic_cfg(obs.static)
    scenes = ret.deterministic_scenes(obs.scenes)
    x_window, n_chan = (70, 126), 4
    idx, in_win = ret.bin_channel_map(scenes, obs.tables, x_window, n_chan)
    idx = torch.as_tensor(idx, device=dev)
    in_win = torch.as_tensor(in_win, dtype=torch.float32, device=dev)
    edges = _channel_edges(x_window, n_chan)
    fixed = scenes.rp_over_rs[0]

    def channels(depth):
        rp = in_win * depth[idx] + (1.0 - in_win) * fixed
        sc = dataclasses.replace(scenes, rp_over_rs=rp[None].expand(
            scenes.n, -1))
        return _channel_flux(ret.forward_spectra(sc, obs.tables, twin,
                                                 chunk=6), edges)

    ro.exposure_readout.launches = 0
    J = torch.func.jacfwd(channels)(torch.tensor(
        [0.158, 0.160, 0.157, 0.161], device=dev))
    return J.cpu(), ro.exposure_readout.launches


@pytest.mark.cuda
def test_retrieval_jacobian_on_the_card_matches_cpu(card):
    """The depth Jacobian through B1's autograd Function: on the card one
    B1 launch for the chunk, every depth column nonzero, and within 2e-3
    of each column's largest entry of the CPU's (the bar of
    tests/test_torch_retrieval.py's Jacobian against JAX's)."""
    got, launches = _depth_jacobian("cuda")
    want, _ = _depth_jacobian("cpu")
    assert launches == 1
    for c in range(4):
        col = want[..., c]
        assert float(got[..., c].abs().max()) > 0.0
        torch.testing.assert_close(got[..., c], col, rtol=0,
                                   atol=2e-3 * float(col.abs().max()))


@pytest.mark.cuda
def test_readout_function_value_is_the_kernels_under_jvp(card):
    """Under ``torch.func.jvp`` the whole-exposure readout's value is B1's,
    bit for bit with the plain version, its tangent the CPU's within rtol
    1e-6 of the largest entry, and the kernel launched once."""
    import wayne_tpu_torch.ops.readout as ro

    args = _readout_inputs(card)
    off = dict(poisson=False, read_noise=False, with_cr=False, ipc=True)
    tangent = torch.rand(args[3].shape, generator=torch.Generator(
    ).manual_seed(5)).to(card)

    def run(a, t):
        fn = lambda b: ro.exposure_readout(*a[:3], b, *a[4:], **off)
        return torch.func.jvp(fn, (a[3],), (t,))

    ro.exposure_readout.launches = 0
    (reads, cum), (d_reads, d_cum) = run(args, tangent)
    assert ro.exposure_readout.launches == 1
    want, cum_w = exposure_readout_plain(*args, **off)
    assert torch.equal(reads, want) and torch.equal(cum, cum_w)
    cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
    _, (d_w, dc_w) = run(cpu, tangent.cpu())
    for a, b in ((d_reads, d_w), (d_cum, dc_w)):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


@pytest.mark.cuda
def test_channel_posteriors_on_the_card_match_cpu(card):
    """sample_channel_posteriors on the card against the CPU on the same
    curves: the two runs draw different numbers (each device's
    generator), so they are held by their law, as the CPU tests hold the
    port against JAX: medians within 0.25 of the half-width, half-widths
    within 25%."""
    from wayne_tpu_torch.mcmc import sample_channel_posteriors
    from wayne_tpu_torch.ops.kepler import OrbitParams, projected_separation
    from wayne_tpu_torch.ops.transit import transit_depth_curve

    t = torch.linspace(0.0, 4.0 * 3600.0, 56)
    orbit = OrbitParams.create(0.813475 * 86400.0, 2.0 * 3600.0, 4.855,
                               np.deg2rad(82.1))
    ld = torch.tensor([0.65, -0.25, 0.45, -0.2])
    z, infr = projected_separation(t, orbit)
    g = torch.Generator().manual_seed(3)
    rp = torch.tensor([0.155, 0.158, 0.1595, 0.162])
    chans = (1.0 - (1.0 - transit_depth_curve(z[:, None], rp[None], ld, 32))
             * infr[:, None]) + 4e-4 * torch.randn((56, 4), generator=g)
    post = {}
    for dev in ("cuda", "cpu"):
        on = lambda x: x.to(dev)
        post[dev] = sample_channel_posteriors(
            on(chans), on(t), OrbitParams(*(on(getattr(orbit, f.name))
                                            for f in dataclasses.fields(
                                                OrbitParams))),
            on(ld), 0.158, 7, n_steps=1500, n_burn=400)
    a, b = post["cuda"], post["cpu"]
    w_a = (0.5 * (a.rp_minus + a.rp_plus)).cpu()
    w_b = 0.5 * (b.rp_minus + b.rp_plus)
    assert bool(((a.rp_median.cpu() - b.rp_median).abs() <= 0.25 * w_b).all())
    assert bool(((w_a / w_b - 1.0).abs() <= 0.25).all())


# --- the (mc, exp) mesh -----------------------------------------------------

@pytest.mark.cuda
def test_sharded_ensemble_on_the_card_equals_one_device(card):
    """simulate_ensemble_spectra on make_mesh(["cuda:0"] * 2) (two worker
    threads on one card) against mesh=None, a 64^2 visit with the noise
    on, chunk = n_exp / d_exp on both: bit for bit, B1 once per batch."""
    from wayne_tpu_torch.parallel import make_mesh, mc_scenes
    from wayne_tpu_torch.parallel.ensemble import simulate_ensemble_spectra

    obs = Observation(config_from_dict(dict(DATASET, exposures_per_orbit=4,
                                            noise={"preset": "all"})),
                      device="cuda")
    ens = mc_scenes(obs.scenes, 4, seed=5)
    mesh = make_mesh(["cuda:0"] * 2)                 # (2, 1)
    assert mesh.shape == {"mc": 2, "exp": 1}
    exposure_readout.launches = 0
    one = simulate_ensemble_spectra(ens, obs.tables, obs.static, chunk=4)
    sharded = simulate_ensemble_spectra(ens, obs.tables, obs.static, mesh,
                                        chunk=4)
    torch.cuda.synchronize()
    assert exposure_readout.launches == 4 + 4
    assert sharded.device == torch.device("cuda", 0)
    assert torch.equal(sharded, one) and bool(torch.isfinite(one).all())


@pytest.mark.cuda
def test_generate_on_a_mesh_writes_the_one_device_files(card, tmp_path):
    """Observation.generate(mesh=make_mesh(["cuda:0"] * 4)) with the
    on-device uint16 copy path (quantize_adc) writes the files of the
    one-device run byte for byte: each shard's pinned copy is waited for
    by its device's event before the writer reads it."""
    from wayne_tpu_torch.parallel import make_mesh

    obs = Observation(config_from_dict(dict(TINY, quantize_adc=True,
                                            exposures_per_orbit=9)),
                      device="cuda")
    one = obs.generate(str(tmp_path / "one"), chunk=2,
                       progress=lambda s: None)
    sharded = obs.generate(str(tmp_path / "mesh"), chunk=2,
                           mesh=make_mesh(["cuda:0"] * 4),
                           progress=lambda s: None)
    assert len(one) == len(sharded) == 9
    for a, b in zip(one, sharded):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)


# (lam, z) where the Cornish-Fisher sum lands within an ulp of a
# half-integer (the same table as tests/test_torch_readout.py, which holds
# the CPU): a quotient by 6 taken as a multiply by float32(1/6) rounds them
# to the other integer.
HALF_INTEGER_DRAWS = [
    (41.329315185546875, -0.41872110962867737),
    (12.244315147399902, 0.12001407146453857),
    (12.309959411621094, 0.10118179023265839),
    (6.654434680938721, 0.004740480333566666),
    (8.736632347106934, -0.023702245205640793),
    (28.831836700439453, -0.030789947137236595),
    (19.979833602905273, 0.15278778970241547),
    (37.24016571044922, -2.7600533962249756),
]


@pytest.mark.cuda
def test_fast_poisson_on_the_card_rounds_as_the_kernel(card):
    """The plain three-regime sampler on CUDA tensors gives the CPU's draws
    (one correctly rounded division by 6, as the kernels take it) where the
    skew term's last ulp moves round()."""
    from wayne_tpu_torch.ops.random import fast_poisson

    lam, z = (torch.tensor(c) for c in zip(*HALF_INTEGER_DRAWS))
    u = torch.full_like(lam, 0.5)
    want = fast_poisson(lam, u, z)
    got = fast_poisson(lam.to(card), u.to(card), z.to(card))
    assert torch.equal(got.cpu(), want), (got.cpu(), want)


@pytest.mark.cuda
def test_kernel_matches_plain_bit_for_bit_over_two_billion_draws(card):
    """B1 = its plain version bit for bit with every noise on, over 64
    launches of 8 exposures x 16 reads at 512^2 whose background and band
    sit in the Cornish-Fisher regime (3 <= lam < 100): 2.1e9 such draws,
    where a plain version one ulp off in the skew term (about one draw in
    3e8) would differ by one electron a few times."""
    B, NR, W, S, n_cr = 8, 16, 32, 512, 20
    g = torch.Generator(device=card).manual_seed(11)
    u = lambda *shape: torch.rand(shape, generator=g, device=card)
    dts = torch.full((B, NR), 2.9, device=card)
    dts[:, 0] = 0.0
    bands = 3.0 + 97.0 * u(B, NR, W, S)
    bands[:, 0] = 0.0
    y0s = (torch.randint(0, (S - W) // 8 + 1, (B, NR), generator=g,
                         device=card) * 8).to(torch.int32)
    bg = (3.0 + 97.0 * u(B, S, S)) / 2.9
    cr_pos = torch.randint(0, S, (B, NR, 2, n_cr), generator=g,
                           device=card).to(torch.int32)
    cr_q = 1000.0 * u(B, NR, n_cr)
    cr_q[:, 0] = 0.0
    bias = 2500.0 + 12.0 * u(S, S)
    inv_gain = 1.0 / (2.5 * (1 + 0.003 * u(S, S)))
    nl = torch.tensor([0.012, 0.012, 0.016], device=card)[:, None, None] \
        * (1 + 0.03 * u(3, S, S))
    consts = (20.0, 78000.0, 2.5, 0.015)
    for launch in range(64):
        seed = torch.randint(-2**31, 2**31 - 1, (B, 2), generator=g,
                             device=card).to(torch.int32)
        args = (seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q,
                consts)
        got, cum = exposure_readout(*args, ipc=True)
        want, cum_w = exposure_readout_plain(*args, ipc=True)
        diff = got != want
        assert not bool(diff.any()) and torch.equal(cum, cum_w), (
            launch, int(diff.sum()), float((got - want).abs().max()))


@pytest.mark.cuda
def test_validation_main_reference_on_the_card_matches_cpu(card):
    """validate_recovery's main noise-free core (simulation, NLINCORR,
    reduce_visit and fit_depths of the chromatic transit visit at 128^2,
    16 exposures, 4 channels) on the card against the CPU: Rp/Rs atol
    1e-5 (chip_smoke.py phase 13a's bar at the full size)."""
    from wayne_tpu_torch.tools import validate_recovery as vr

    small = dict(S=128, NL=64, NSAMP=3, N_EXP=16, N_CHAN=4,
                 samp_seq="SPARS10", band_px=32, x_ref=-60.0, y_ref=30.0,
                 x_window=(4, 124), y_window=(20, 50), bg_rows=(90, 125))
    got = vr.main_reference(vr.build_core(card, **small))
    want = vr.main_reference(vr.build_core("cpu", **small))
    assert np.all(np.isfinite(got)) and got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

"""The port's calwf3 (wayne_tpu_torch.calwf3, run_calwf3) against the JAX
package's on the same ima files: one file written from seeded reads,
calibrated by both packages, staring and scan, with and without the DQ-128
reference border; the error messages; write_flt read back by the JAX
package; run_calwf3 --cpu on a visit directory.

Bars: SCI / ERR rtol 1e-5 with atol 1e-3 e-/s; DQ, SAMP and TIME exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from wayne_tpu import calwf3 as calwf3_j
from wayne_tpu.calibration import synthetic_tables
from wayne_tpu.config import config_from_dict as config_from_dict_j
from wayne_tpu.models.grism import make_calibrated_grism as grism_j
from wayne_tpu_torch import calwf3
from wayne_tpu_torch.config import config_from_dict, load_yaml
from wayne_tpu_torch.convert import numpy_leaves, tables_from_numpy
from wayne_tpu_torch.io.ima import default_primary_header, write_ima
from wayne_tpu_torch.observation import Observation
from wayne_tpu_torch.run_calwf3 import main as run_calwf3

torch.set_num_threads(1)

S, NSAMP = 64, 4
CHAIN_ON = {"preset": "none", "non_linearity": True, "bias": True,
            "gain_variations": True, "dark": True, "cosmic_rays": True}
PARS = {"grism": "G141", "subarray": S, "NSAMP": NSAMP,
        "SAMPSEQ": "SPARS10", "scan": True, "x_ref": 10.0, "y_ref": 20.0,
        "num_orbits": 1, "exposures_per_orbit": 3, "n_lambda": 32,
        "n_sub": 2, "seed": 3, "noise": CHAIN_ON}
TABLES_J = synthetic_tables("G141", subarray=S, n_lambda=32,
                            samp_seq="SPARS10", nsamp=NSAMP)
TABLES = tables_from_numpy(numpy_leaves(TABLES_J), "cpu")


def _flags(noise=CHAIN_ON):
    pars = dict(PARS, noise=noise)
    return config_from_dict_j(pars).noise, config_from_dict(pars).noise


def _write(path, *, scan=True, border=False, nsamp=NSAMP, s=S,
           units="counts", seed=0):
    """An ima file of seeded reads through the forward chain: a scanned
    trace (0-400 e-/s), dark, the non-linear response (a tenth of a row
    past full well), bias, the gain map; cosmic-ray steps flagged 8192, a
    hot pixel (16), a saturated pixel (256) and, with ``border``, the
    5-px reference border (128) with a per-read per-quadrant drift."""
    rng = np.random.default_rng(seed)
    leaves = numpy_leaves(TABLES_J)
    t = np.asarray(leaves["read_times"], np.float64)[: nsamp + 1]
    nr = nsamp + 1
    rate = (400.0 * np.exp(-0.5 * ((np.arange(s)[:, None] - 30.0) / 6.0) ** 2)
            * (np.arange(s)[None, :] > 8) + 2.0)
    rate[40, :6] = 2.0e4                                     # saturates
    q = rate[None] * t[:, None, None] + leaves["dark_map"][:s, :s] * \
        t[:, None, None]
    q = q + rng.normal(0.0, 15.0, (nr, s, s))
    dq = np.zeros((nr, s, s), np.int16)
    for _ in range(8 if nr > 1 else 0):
        k = rng.integers(1, nr)
        y, x = rng.integers(0, s, 2)
        q[k:, y, x] += 3000.0
        dq[k:, y, x] |= 8192
    dq[:, 7, 9] |= 16
    fw = float(leaves["full_well_e"])
    c = leaves["nonlin_coeffs"][:, :s, :s]
    qq = np.minimum(q, fw) / fw
    meas = np.minimum(q, fw) * (1.0 - ((c[2] * qq + c[1]) * qq + c[0]) * qq)
    dq[:, 40, :6] |= np.where(q[:, 40, :6] >= fw, 256, 0).astype(np.int16)
    dn = (meas + leaves["bias_map"][:s, :s]) / leaves["gain_map"][:s, :s]
    if border:
        ref = np.zeros((s, s), bool)
        ref[:5], ref[-5:], ref[:, :5], ref[:, -5:] = True, True, True, True
        quad = (np.arange(s)[:, None] >= s // 2) * 2 \
            + (np.arange(s)[None, :] >= s // 2)
        dn = dn + rng.normal(0.0, 1.5, (nr, 4))[:, quad]
        dq[:, ref] |= 128
    hdr = default_primary_header(
        targname="TEST", grism="G141", nsamp=nsamp, samp_seq="SPARS10",
        subarray=s, expstart_mjd=56000.0, exptime_s=float(t[-1]),
        scan=scan, scan_rate_pix_s=1.0 if scan else 0.0)
    write_ima(str(path), dn.astype(np.float32), t, hdr, dq=dq,
              units=units, use_native=False)
    return str(path)


def _assert_flt(got, want):
    """SCI / ERR at rtol 1e-5, atol 1e-3 e-/s; DQ, SAMP, TIME exact.
    Returns the largest SCI and ERR gaps."""
    for name in ("sci", "err"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-5, atol=1e-3, err_msg=name)
    for name in ("dq", "samp", "time"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    assert got.header == want.header
    return [float(np.abs(getattr(got, n) - getattr(want, n)).max())
            for n in ("sci", "err")]


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "staring"])
@pytest.mark.parametrize("border", [False, True],
                         ids=["subarray", "ref_border"])
def test_calibrate_ima_matches_jax(tmp_path, scan, border):
    """BLEVCORR (with the border), NLINCORR, DARKCORR, the DQ repair and
    the CDS net (scan) or the ramp slope (staring), on the chain-on flags:
    SCI and ERR within the bars (measured <= 1.6e-4 and 9.6e-7 e-/s on
    ~400 e-/s),
    DQ, SAMP and TIME identical, the same header."""
    path = _write(tmp_path / "x_ima.fits", scan=scan, border=border)
    noise_j, noise = _flags()
    want = calwf3_j.calibrate_ima(path, TABLES_J, noise_j)
    got = calwf3.calibrate_ima(path, TABLES, noise)
    _assert_flt(got, want)
    assert got.header["BLEVCORR"] == ("COMPLETE" if border else "OMIT")
    assert (got.dq & 8192).any() and (got.samp < NSAMP + 1).any()
    # the switches off: no NLINCORR (header), no dark, gain, bias planes
    off_j, off = _flags({"preset": "none"})
    _assert_flt(calwf3.calibrate_ima(path, TABLES, off),
                calwf3_j.calibrate_ima(path, TABLES_J, off_j))


def test_calibrate_ima_errors_match_jax(tmp_path):
    """The JAX package's three refusals, word for word: a count-rate
    product, too few reads (staring NSAMP 1; any NSAMP 0) and frames of
    another size than the tables'."""
    noise_j, noise = _flags()
    other_j = synthetic_tables("G141", subarray=128, n_lambda=32,
                               samp_seq="SPARS10", nsamp=NSAMP)
    other = tables_from_numpy(numpy_leaves(other_j), "cpu")
    cases = [
        (_write(tmp_path / "rate_ima.fits", units="e_per_s"), "count-rate",
         TABLES, TABLES_J),
        (_write(tmp_path / "st1_ima.fits", scan=False, nsamp=1),
         "up-the-ramp", TABLES, TABLES_J),
        (_write(tmp_path / "sc0_ima.fits", nsamp=0), "CDS net", TABLES,
         TABLES_J),
        (_write(tmp_path / "big_ima.fits"), "calibration planes", other,
         other_j),
    ]
    for path, match, tables, tables_j in cases:
        with pytest.raises(ValueError, match=match) as got:
            calwf3.calibrate_ima(path, tables, noise)
        with pytest.raises(ValueError) as want:
            calwf3_j.calibrate_ima(path, tables_j, noise_j)
        assert str(got.value) == str(want.value)
    # a scan product with NSAMP 1 takes the CDS net
    flt = calwf3.calibrate_ima(_write(tmp_path / "sc1_ima.fits", nsamp=1),
                               TABLES, noise)
    assert np.isfinite(flt.sci).all()


def test_write_flt_reads_back_in_the_jax_package(tmp_path):
    noise_j, noise = _flags()
    flt = calwf3.calibrate_ima(_write(tmp_path / "x_ima.fits", border=True),
                               TABLES, noise)
    out = str(tmp_path / "x_flt.fits")
    calwf3.write_flt(out, flt)
    hdr, sci, err, dq = calwf3_j.read_flt(out)
    np.testing.assert_array_equal(sci, flt.sci)
    np.testing.assert_array_equal(err, flt.err)
    np.testing.assert_array_equal(dq, flt.dq)
    assert hdr["BUNIT"] == "ELECTRONS/S" and hdr["CRCORR"] == "COMPLETE"
    assert hdr["FLATCORR"] == "OMIT"
    hdr2, sci2, _, dq2 = calwf3.read_flt(out)
    np.testing.assert_array_equal(sci2, flt.sci)
    np.testing.assert_array_equal(dq2, flt.dq)
    assert hdr2 == hdr


def _jax_flt_f64(path, tables_j, noise_j):
    """The JAX package's calibrate_ima of ``path`` with its arithmetic in
    float64 after the float32 read (tables promoted, x64 on)."""
    with jax.enable_x64(True):
        t64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64)
            if np.asarray(a).dtype.kind == "f" else a, tables_j)
        return calwf3_j.calibrate_ima(path, t64, noise_j)


def test_run_calwf3_cpu_on_a_visit_directory(tmp_path):
    """``run_calwf3 --cpu`` on a visit the port generated (chain on): one
    flt per ima, each within the bars of the JAX package's calibration of
    the same file with the tables of the same YAML, its arithmetic in
    float64. The JAX package's float32 chain lands 1.77x the SCI bar from
    that at one pixel of 12288 (0.0117 e-/s on 509.6 e-/s): a cosmic ray
    in the interval the scan lights the pixel, where the repair's
    amplitude ratio divides two near-cancelling clean-interval sums and
    XLA's fused multiply-adds in NLINCORR move them by an ulp. The port
    (no fused multiply-adds) measures 0.15x the bar there."""
    yml = tmp_path / "pars.yml"
    yml.write_text(yaml.safe_dump(PARS))
    visit = tmp_path / "visit"
    obs = Observation(load_yaml(str(yml)), device="cpu")
    paths = obs.generate(str(visit), chunk=3, progress=lambda s: None)
    out = tmp_path / "flt"
    assert run_calwf3(["-d", str(visit), "-p", str(yml), "--cpu",
                       "-o", str(out)]) == 0
    names = sorted(os.listdir(out))
    assert names == sorted(os.path.basename(p).replace("_ima", "_flt")
                           for p in paths)
    tables_j = grism_j(config_from_dict_j(PARS)).tables
    noise_j = config_from_dict_j(PARS).noise
    for p in paths:
        want = _jax_flt_f64(p, tables_j, noise_j)
        hdr, sci, err, dq = calwf3.read_flt(
            str(out / os.path.basename(p).replace("_ima", "_flt")))
        np.testing.assert_allclose(sci, want.sci, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(err, want.err, rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(dq, want.dq)
        assert hdr["NLINCORR"] == "COMPLETE" and sci.shape == (S, S)
    with pytest.raises(SystemExit):
        run_calwf3(["-d", str(tmp_path / "empty"), "-p", str(yml), "--cpu"])

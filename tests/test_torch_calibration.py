"""Real calibration products (the YAML ``calibration:`` block): the port's
loader seams, ``with_loaded_*`` and the ``Grism`` query API against the
JAX package's on the same small files, written here (no product file is
in the repository), and a whole calibrated visit, the stochastic effects
off, port ``simulate()`` against JAX ``simulate()``."""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch
import yaml

import wayne_tpu.calibration as cal_j
from wayne_tpu.config import load_yaml as load_yaml_j
from wayne_tpu.models.grism import Grism as Grism_j
from wayne_tpu.observation import Observation as Observation_j
from wayne_tpu_torch import calibration as cal_t
from wayne_tpu_torch.config import load_yaml
from wayne_tpu_torch.convert import numpy_leaves
from wayne_tpu_torch.io.fits import FitsHDU, write_fits
from wayne_tpu_torch.models.grism import Grism
from wayne_tpu_torch.observation import Observation

torch.set_num_threads(1)

S = 64


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    """A full set of STScI-format products: full-frame planes (128^2, cut
    to the 64^2 subarray) with pixel structure, from a numpy seed."""
    d = tmp_path_factory.mktemp("calib")
    rng = np.random.RandomState(4)
    n = 128
    plane = lambda loc, sc: (loc + sc * rng.standard_normal((n, n))
                             ).astype(np.float32)
    p = {}
    p["conf"] = d / "g141.conf"
    p["conf"].write_text(
        "# aXe conf\nBEAMA -10 150\nDYDX_A_0 2.1 1.0e-4 -2.0e-3 ; offset\n"
        "DYDX_A_1 0.0105 -8.0e-6\nDLDP_A_0 8950.0 0.0009 0.02\n"
        "DLDP_A_1 44.7 4.0e-6 -9.0e-4 0 0 0 7\n")
    wl = np.linspace(10500.0, 17500.0, 40)
    p["sens"] = d / "sens.txt"
    np.savetxt(p["sens"], np.stack(
        [wl, 1.4e16 * np.exp(-0.5 * ((wl - 13900.0) / 2500.0) ** 4)], 1))
    p["sens_um"] = d / "sens_um.txt"
    np.savetxt(p["sens_um"], np.stack([wl * 1e-4, np.full(40, 1.2e16)], 1))
    flat = np.stack([plane(1.0, 0.01), plane(0.0, 0.003),
                     plane(0.0, 0.001), plane(0.0, 1e-4)])
    p["flat"] = d / "flat.fits"
    write_fits(str(p["flat"]), [FitsHDU(data=flat)])
    p["flat_hdus"] = d / "flat_hdus.fits"
    write_fits(str(p["flat_hdus"]), [FitsHDU()] + [
        FitsHDU(name="SCI", ver=i + 1, data=flat[i]) for i in range(2)])
    p["sky"] = d / "sky.fits"
    write_fits(str(p["sky"]), [FitsHDU(data=plane(1.5, 0.05))])
    p["sky_he"] = d / "sky_he.fits"
    write_fits(str(p["sky_he"]), [FitsHDU(data=plane(0.8, 0.02))])
    nonlin = np.stack([plane(0.015, 4e-4), plane(0.015, 4e-4),
                       plane(0.02, 5e-4)])
    p["nonlin"] = d / "nonlin.fits"
    write_fits(str(p["nonlin"]), [FitsHDU(data=nonlin)])
    p["nonlin_hdus"] = d / "nonlin_hdus.fits"
    write_fits(str(p["nonlin_hdus"]), [FitsHDU()] + [
        FitsHDU(name="SCI", ver=i + 1, data=nonlin[i]) for i in range(3)])
    p["nonlin_bad"] = d / "nonlin_bad.fits"
    write_fits(str(p["nonlin_bad"]), [FitsHDU(data=nonlin[:2])])
    bits = np.zeros((n, n), np.int16)
    bits[rng.rand(n, n) < 0.01] = 4
    bits[40:52, 60:75] |= 512
    p["qe_bits"] = d / "qe_bits.fits"
    write_fits(str(p["qe_bits"]), [FitsHDU(data=bits)])
    rel = np.clip(plane(1.0, 0.004), 0.0, None)
    rel[rng.rand(n, n) < 0.005] = 0.0
    p["qe_rel"] = d / "qe_rel.fits"
    write_fits(str(p["qe_rel"]), [FitsHDU(data=rel)])
    p["qe_abs"] = d / "qe_abs.fits"
    write_fits(str(p["qe_abs"]), [FitsHDU(data=0.85 * rel)])
    p["qe_zero"] = d / "qe_zero.fits"
    write_fits(str(p["qe_zero"]), [FitsHDU(data=np.zeros((n, n),
                                                          np.float32))])
    p["small"] = d / "small.fits"
    write_fits(str(p["small"]), [FitsHDU(data=plane(1.0, 0.1)[:32, :32])])
    return {k: str(v) for k, v in p.items()}


def _tables():
    kw = dict(subarray=S, n_lambda=32, samp_seq="SPARS10", nsamp=3)
    return cal_j.synthetic_tables("G141", **kw), cal_t.synthetic_tables(
        "G141", **kw)


def test_conf_and_sensitivity_loaders_match_jax(products):
    want, got = cal_j.load_axe_conf(products["conf"]), cal_t.load_axe_conf(
        products["conf"])
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("sens", "sens_um"):
        for g, w in zip(cal_t.load_sensitivity_ascii(products[name]),
                        cal_j.load_sensitivity_ascii(products[name])):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("loader,name", [
    ("load_flat_cube_fits", "flat"), ("load_flat_cube_fits", "flat_hdus"),
    ("load_master_sky_fits", "sky"), ("load_master_sky_fits", "sky_he"),
    ("load_nonlin_cube_fits", "nonlin"),
    ("load_nonlin_cube_fits", "nonlin_hdus")])
def test_fits_loaders_match_jax(products, loader, name):
    got = getattr(cal_t, loader)(products[name], S)
    want = getattr(cal_j, loader)(products[name], S)
    assert got.shape == want.shape and got.shape[-1] == S
    np.testing.assert_array_equal(got, want)


def test_loaders_refuse_what_the_jax_package_refuses(products, tmp_path):
    bad = tmp_path / "bad.conf"
    bad.write_text("DYDX_A_0 1.0\nDLDP_A_0 9000\n")
    for mod in (cal_t, cal_j):
        with pytest.raises(ValueError, match="missing keys"):
            mod.load_axe_conf(str(bad))
        with pytest.raises(ValueError, match="3 coefficient planes"):
            mod.load_nonlin_cube_fits(products["nonlin_bad"], S)
        with pytest.raises(ValueError, match="smaller than subarray"):
            mod.load_master_sky_fits(products["small"], S)
    plane = np.arange(16.0).reshape(4, 4)
    np.testing.assert_array_equal(cal_t._subarray_cutout(plane, 2),
                                  cal_j._subarray_cutout(plane, 2))


def _assert_tables_equal(got, want, sens_rtol=0.0):
    leaves = numpy_leaves(got)
    for k, v in numpy_leaves(want).items():
        if v is None:
            assert leaves[k] is None, k
        elif k == "sensitivity":
            np.testing.assert_allclose(leaves[k], v, rtol=sens_rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(leaves[k], v, err_msg=k)


def test_with_loaded_grism_and_nonlin_match_jax(products):
    """Every leaf the products replace equals the JAX package's exactly;
    the interpolated sensitivity to float32 round-off."""
    tj, tt = _tables()
    kw = dict(conf_path=products["conf"], sens_path=products["sens"],
              flat_path=products["flat"], sky_path=products["sky"],
              sky_he_path=products["sky_he"])
    want = cal_j.with_loaded_nonlin(cal_j.with_loaded_grism(tj, **kw),
                                    products["nonlin"])
    got = cal_t.with_loaded_nonlin(cal_t.with_loaded_grism(tt, **kw),
                                   products["nonlin"])
    _assert_tables_equal(got, want, sens_rtol=1e-7)
    assert got.sensitivity.device == tt.device
    np.testing.assert_allclose(float(got.dldp1[0]), 44.7e-4, rtol=1e-6)
    np.testing.assert_allclose(float(got.sky_frame.mean()), 1.0, rtol=1e-5)
    # the cached host scalars and the saturation ceiling follow the load
    assert cal_t.nonlin_fw_deficit(got) == pytest.approx(
        cal_j.nonlin_fw_deficit(want), rel=1e-6)
    assert cal_t.nonlin_fw_deficit(got) != pytest.approx(
        cal_t.nonlin_fw_deficit(tt), rel=1e-3)


@pytest.mark.parametrize("name", ["qe_bits", "qe_rel", "qe_abs"])
def test_with_loaded_qe_matches_jax(products, name):
    """The DQ-bit plane (dead 0, blob 0.88), a relative plane, and an
    absolute plane, renormalised by its median with the JAX package's
    warning."""
    tj, tt = _tables()
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = cal_j.with_loaded_qe(tj, products[name])
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = cal_t.with_loaded_qe(tt, products[name])
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    assert (len(wt) > 0) == (name == "qe_abs")
    np.testing.assert_array_equal(got.qe_map.numpy(), np.asarray(want.qe_map))
    if name == "qe_bits":
        assert np.isin(got.qe_map.numpy(),
                       np.float32([0.0, 0.88, 1.0])).all()
    with pytest.raises(ValueError, match="non-positive median"):
        cal_t.with_loaded_qe(tt, products["qe_zero"])


def test_grism_query_api_matches_jax(products):
    kw = dict(subarray=S, n_lambda=32, samp_seq="SPARS10", nsamp=3,
              conf_file=products["conf"], sens_file=products["sens"])
    gj, gt = Grism_j(**kw), Grism(**kw)
    assert (gt.wl_min, gt.wl_max) == (gj.wl_min, gj.wl_max)
    tj, tt = gj.get_trace(20.0, 31.5), gt.get_trace(20.0, 31.5)
    for f in dataclasses.fields(tt):
        np.testing.assert_allclose(float(getattr(tt, f.name)),
                                   float(getattr(tj, f.name)), rtol=1e-6,
                                   err_msg=f.name)
    wl = np.linspace(1.1, 1.65, 7)
    x = gj.wl_to_x(wl, 20.0, 31.5)
    np.testing.assert_allclose(gt.wl_to_x(wl, 20.0, 31.5), x, rtol=1e-6)
    np.testing.assert_allclose(gt.x_to_wl(x, 20.0, 31.5),
                               gj.x_to_wl(x, 20.0, 31.5), rtol=1e-6)
    assert gt.wl_to_x(1.3, 20.0, 31.5).shape == ()
    np.testing.assert_allclose(gt.get_sensitivity(wl),
                               gj.get_sensitivity(wl), rtol=1e-6)
    np.testing.assert_allclose(gt.psf_sigma(wl), gj.psf_sigma(wl),
                               rtol=1e-6)


def test_full_real_calibration_visit(products, tmp_path):
    """The counterpart of tests/test_calibration.py's
    test_full_real_calibration_visit: a complete set of products (aXe
    conf, sensitivity, flat cube, master and He sky, non-linearity cube,
    QE DQ-bit plane, exact sequence timing) drives a whole visit through
    the YAML ``calibration:`` block; the stochastic effects off, port
    ``simulate()`` against JAX ``simulate()`` at the visit tests' bar (rtol
    2e-5, floor max(1e-3, 5e-6 of the peak)); the static DQ plane of the
    loaded QE and the loaded timing match too."""
    seq = tmp_path / "seq.json"
    seq.write_text(json.dumps({"SPARS25/64": [0.0, 0.061, 11.75, 23.5]}))
    pars = {"observation": {
        "grism": "G141", "subarray": S, "NSAMP": 3, "SAMPSEQ": "SPARS25",
        "scan": True, "x_ref": 20.0, "y_ref": 30.0, "num_orbits": 1,
        "exposures_per_orbit": 3, "n_lambda": 32, "n_sub": 2,
        "compute_ideal": True},
        "noise": {"poisson": False, "read_noise": False,
                  "cosmic_rays": False, "bias_drift": False},
        "trends": {"he_airglow_level": 0.4},
        "calibration": {
            "axe_conf": products["conf"],
            "sensitivity_file": products["sens"],
            "flat_file": products["flat"], "sky_file": products["sky"],
            "sky_he_file": products["sky_he"],
            "nonlin_file": products["nonlin"], "qe_file": products["qe_bits"],
            "sequence_file": str(seq)}}
    ppath = tmp_path / "pars.yml"
    ppath.write_text(yaml.safe_dump(pars))
    obs_j = Observation_j(load_yaml_j(str(ppath)))
    obs_t = Observation(load_yaml(str(ppath)), device="cpu")
    np.testing.assert_allclose(obs_t.tables.read_times.numpy(),
                               [0.0, 0.061, 11.75, 23.5], rtol=1e-6)
    _assert_tables_equal(obs_t.tables, obs_j.tables, sens_rtol=1e-7)
    np.testing.assert_array_equal(obs_t._detector_planes()[0],
                                  obs_j._detector_planes()[0])
    assert (obs_t._detector_planes()[0] & 512).any()     # the blob
    ref, got = obs_j.simulate(chunk=2), obs_t.simulate(chunk=2)
    for name in ("ideal_e", "reads_dn"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), want,
                                   rtol=2e-5,
                                   atol=max(1e-3, 5e-6 * float(want.max())),
                                   err_msg=name)
    assert float(got.ideal_e.max()) > 1e3                 # signal landed

"""``python -m wayne_tpu_torch.run_reduce --cpu`` against ``python -m
wayne_tpu.run_reduce --cpu`` on the same files: two small visits the port
generates (64^2, NSAMP 3), a transit visit in four HST orbits and a visit
that samples a whole planetary orbit (transit, quadratures, eclipse), each
reduced by both packages with the same flags.

The reports must agree key by key (``run_reduce.compare_reports``): the same
keys, strings, flags, integers and list lengths; depths within max(1e-5,
0.01 sigma), sigmas within 1e-3 relative, the light curves within 5e-6, the
drifts within 2e-4 px, sky weights within 1e-5 relative, and the white
fits' nuisance parameters within 1e-2 relative (each plus the report's
rounding unit). With ``--align`` in transit mode the JAX package's drift
regressor runs in float64 (ROADMAP Queue C4: its float32 solve is farther
from its float64 than the port's is). With ``--mcmc`` the posteriors are
held to the JAX package's by their law (the packages draw different
random numbers), every other key as above.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import wayne_tpu.reduction as red_j
from wayne_tpu.run_reduce import main as reduce_j
from wayne_tpu_torch.run_reduce import compare_reports
from wayne_tpu_torch.run_reduce import main as reduce_t
from wayne_tpu_torch.run_visit import main as visit_t

torch.set_num_threads(1)

PERIOD_D = 0.813475
BASE = {
    "observation": {
        "grism": "G141", "subarray": 64, "NSAMP": 3, "SAMPSEQ": "SPARS10",
        "scan": True, "scan_speed": 1.0, "x_ref": -60.0, "y_ref": 10.0,
        "exposure_overhead_s": 280.0, "n_lambda": 48, "n_sub": 2},
    "target": {"name": "WASP-43", "mag_J": 9.995},
    "planet": {"period": PERIOD_D, "t0": 56000.0, "sma_over_rs": 4.855,
               "inclination": 82.1, "rp_over_rs": 0.1595,
               "ld_coeffs": [0.65, -0.25, 0.45, -0.2]},
}


def _visit(root, name, observation, planet=None) -> tuple[str, str]:
    d = {k: dict(v) for k, v in BASE.items()}
    d["observation"].update(observation, outdir=str(root / name))
    d["planet"].update(planet or {})
    pars = root / f"{name}.yml"
    pars.write_text(yaml.safe_dump(d))
    with contextlib.redirect_stdout(io.StringIO()):
        assert visit_t(["-p", str(pars), "--cpu", "--chunk", "8"]) == 0
    return str(root / name), str(pars)


@pytest.fixture(scope="module")
def visits(tmp_path_factory):
    """{'transit': (dir, yaml), 'orbit': (dir, yaml)}."""
    root = tmp_path_factory.mktemp("reduce")
    transit = _visit(root, "transit", {
        "num_orbits": 4, "exposures_per_orbit": 10, "start_mjd": 55999.86,
        "seed": 3})
    starts = [round(56000.05 + k * PERIOD_D / 12 + i * 160.0 / 86400.0, 6)
              for k in range(12) for i in range(4)]
    orbit = _visit(root, "orbit", {"exp_start_times": starts, "seed": 5},
                   {"eclipse_depth": 2.5e-3, "phase_amplitude": 0.6,
                    "phase_offset_deg": 15.0})
    return {"transit": transit, "orbit": orbit}


@contextlib.contextmanager
def _x64_regressor():
    """The JAX package's clean_drift_regressor evaluated in float64."""
    real = red_j.clean_drift_regressor

    def x64(cen, basis, t, *a, **kw):
        with jax.enable_x64(True):
            out = real(*(jnp.asarray(np.asarray(v), jnp.float64)
                         for v in (cen, basis, t)), *a, **kw)
            return jnp.asarray(np.asarray(out), jnp.float32)

    red_j.clean_drift_regressor = x64
    try:
        yield
    finally:
        red_j.clean_drift_regressor = real


def _both(visit, pars, flags, tmp_path):
    reports = []
    for name, main in (("jax", reduce_j), ("torch", reduce_t)):
        out = str(tmp_path / f"{name}.json")
        x64 = (_x64_regressor() if name == "jax" and "--align" in flags
               and "--mode" not in flags else contextlib.nullcontext())
        with x64, contextlib.redirect_stdout(io.StringIO()):
            assert main(["-d", visit, "-p", pars, "--cpu", "-o", out,
                         *flags]) == 0
        with open(out) as fh:
            reports.append(json.load(fh))
    return reports


CASES = {
    "divide_white": ("transit", []),
    "ramp_fit_geometry": ("transit", ["--detrend", "ramp",
                                      "--fit-geometry"]),
    "ramp_clip_sigma": ("transit", ["--detrend", "ramp", "--clip-sigma",
                                    "4"]),
    "recte": ("transit", ["--detrend", "recte"]),
    "none_optimal_sky_fit": ("transit", ["--detrend", "none", "--extract",
                                         "optimal", "--sky-fit",
                                         "--save-lc"]),
    "align_wl_range": ("transit", ["--align", "--wl-range", "1.15:1.6"]),
    "direct_image_ramp_estimator": ("transit", [
        "--direct-image", "--estimator", "ramp", "--no-amp-offset"]),
    "windows_no_dq": ("transit", [
        "--no-divide-white", "--no-dq", "--no-nlincorr", "--n-chan", "4",
        "--rows", "8:30", "--cols", "0:34", "--bg-rows", "42:64"]),
    "eclipse": ("orbit", ["--mode", "eclipse"]),
    "eclipse_ramp_clip": ("orbit", ["--mode", "eclipse", "--detrend",
                                    "ramp", "--clip-sigma", "4"]),
    "eclipse_none_align": ("orbit", ["--mode", "eclipse", "--detrend",
                                     "none", "--align"]),
    "phase": ("orbit", ["--mode", "phase"]),
    "phase_none": ("orbit", ["--mode", "phase", "--detrend", "none"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_reduce_matches_jax(case, visits, tmp_path):
    which, flags = CASES[case]
    want, got = _both(*visits[which], flags, tmp_path)
    gaps = compare_reports(want, got)
    assert not gaps, gaps
    assert got["detrend"] == want["detrend"]


def test_run_reduce_spectra_and_plot_match_jax(visits, tmp_path):
    """--save-spectra writes the JAX package's HDUs with the same
    spectra, wavelengths and times; --plot draws the quicklook PNG."""
    from wayne_tpu.io.fits import read_fits

    visit, pars = visits["transit"]
    planes = {}
    for name, main in (("jax", reduce_j), ("torch", reduce_t)):
        out = str(tmp_path / f"{name}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["-d", visit, "-p", pars, "--cpu", "-o", out,
                         "--save-spectra", "--plot"]) == 0
        hdus = read_fits(os.path.join(visit, "spectra.fits"))
        planes[name] = {h.get("EXTNAME"): d for h, d in hdus[1:]}
        planes[name]["primary"] = hdus[0][0]
        assert os.path.getsize(str(tmp_path / f"{name}.png")) > 10_000
    a, b = planes["jax"], planes["torch"]
    assert set(a) == set(b) == {"primary", "SPECTRA", "WAVELENGTH", "TIME"}
    assert a["primary"]["WLSRC"] == b["primary"]["WLSRC"] == "yaml"
    np.testing.assert_allclose(b["SPECTRA"], a["SPECTRA"], rtol=1e-5,
                               atol=1e-3 * np.abs(a["SPECTRA"]).max())
    np.testing.assert_array_equal(b["WAVELENGTH"], a["WAVELENGTH"])
    np.testing.assert_array_equal(b["TIME"], a["TIME"])


def _validation_cases(visit, pars, big):
    return [
        # windows valid for the YAML's nominal subarray but beyond the
        # 64^2 frames on disk
        (["-p", big, "--rows", "100:200", "--cols", "100:200",
          "--bg-rows", "210:250"], "64"),
        (["-p", pars, "--n-chan", "0"], "n-chan"),
        (["-p", pars, "--rows", "8:30"], "given together"),
        (["-p", pars, "--rows", "30:8", "--cols", "0:34",
          "--bg-rows", "42:64"], "increasing"),
        (["-p", pars, "--clip-sigma", "4"], "requires --detrend ramp"),
        (["-p", pars, "--detrend", "ramp", "--clip-sigma", "0.5"],
         "would clip"),
        (["-p", pars, "--fit-geometry"], "requires --mode transit"),
        (["-p", pars, "--wl-range", "1.6"], "LO:HI"),
        (["-p", pars, "--wl-range", "2.5:2.9"], "fewer than"),
    ]


def test_run_reduce_argument_validation_matches_jax(visits, tmp_path):
    """The argument errors of tests/test_cli.py::
    test_reduce_cli_argument_validation and the other refusals: each
    package exits with the same SystemExit message."""
    visit, pars = visits["transit"]
    with open(pars) as fh:
        d = yaml.safe_load(fh)
    d["observation"]["subarray"] = 256
    big = str(tmp_path / "big.yml")
    with open(big, "w") as fh:
        yaml.safe_dump(d, fh)
    for args, match in _validation_cases(visit, pars, big):
        said = []
        for main in (reduce_j, reduce_t):
            with pytest.raises(SystemExit, match=match) as err, \
                    contextlib.redirect_stdout(io.StringIO()):
                main(["-d", visit, "--cpu", "-o",
                      str(tmp_path / "x.json"), *args])
            said.append(str(err.value))
        assert said[0] == said[1], said


def test_run_reduce_mode_refusals_match_jax(visits, tmp_path):
    """Refusals that depend on the visit: an eclipse or phase fit without
    eclipse coverage, RECTE outside transit mode, a ramp in phase mode."""
    transit, orbit = visits["transit"], visits["orbit"]
    for (visit, pars), flags, match in (
            (transit, ["--mode", "eclipse"], "no secondary-eclipse"),
            (transit, ["--mode", "phase"], "no secondary-eclipse"),
            (orbit, ["--mode", "eclipse", "--detrend", "recte"],
             "transit only"),
            (orbit, ["--mode", "phase", "--detrend", "ramp"],
             "not wired for --mode phase")):
        said = []
        for main in (reduce_j, reduce_t):
            with pytest.raises(SystemExit, match=match) as err, \
                    contextlib.redirect_stdout(io.StringIO()):
                main(["-d", visit, "-p", pars, "--cpu", "-o",
                      str(tmp_path / "x.json"), *flags])
            said.append(str(err.value))
        assert said[0] == said[1], said


MCMC_CASES = {
    "transit": ("transit", []),
    "fit_geometry": ("transit", ["--detrend", "ramp", "--fit-geometry"]),
    "eclipse": ("orbit", ["--mode", "eclipse"]),
}


def _same_law(got, want, median, plus, minus, where, bars=(0.25, 0.25)):
    """A posterior summary against the JAX package's: the median within
    ``bars[0]`` of the JAX half-width ((plus + minus) / 2), the half-width
    within ``bars[1]`` relative (the two packages draw different random
    numbers)."""
    w_j = 0.5 * (want[plus] + want[minus])
    w_t = 0.5 * (got[plus] + got[minus])
    assert abs(got[median] - want[median]) <= bars[0] * w_j, (where, got,
                                                              want)
    assert abs(w_t / w_j - 1.0) <= bars[1], (where, got, want)


@pytest.mark.parametrize("case", list(MCMC_CASES))
def test_run_reduce_mcmc_matches_jax(case, visits, tmp_path):
    """``--mcmc 1000`` on four channels: every key the JAX package writes,
    the posteriors by their law (``_same_law``; measured: the white and
    channel depths at most 0.16 of the half-width apart, half-widths 9.9%),
    every other number as ``compare_reports`` holds it; R-hat and ESS
    present and finite. The free ephemeris's percentiles come from a
    10-dimensional chain that 1000 steps do not converge (split R-hat ~2
    in both packages), so they are held at 0.5 of the half-width and 35%
    (measured 0.24 and 14%)."""
    which, flags = MCMC_CASES[case]
    want, got = _both(*visits[which], flags + ["--n-chan", "4", "--mcmc",
                                               "1000"], tmp_path)
    wp_j, wp_t = want.pop("white_posterior"), got.pop("white_posterior")
    assert set(wp_t) == set(wp_j)
    dkey = "fp_over_fs" if case == "eclipse" else "rp_over_rs"
    assert wp_t["n_steps"] == 1000 and wp_t["n_burn"] == wp_j["n_burn"]
    _same_law(wp_t, wp_j, f"{dkey}_median", "depth_plus", "depth_minus",
              "white")
    assert 0.1 < wp_t["acceptance"] < 0.95 and wp_t["ess_min"] > 0.0
    assert np.isfinite(wp_t["rhat_max"])
    if case == "fit_geometry":
        g_t = wp_t["geometry_percentiles_16_50_84"]
        g_j = wp_j["geometry_percentiles_16_50_84"]
        for k in ("t0_offset_s", "sma_over_rs", "inclination_deg"):
            lo, mid, hi = g_j[k]
            _same_law(dict(m=g_t[k][1], p=g_t[k][2] - g_t[k][1],
                           n=g_t[k][1] - g_t[k][0]),
                      dict(m=mid, p=hi - mid, n=mid - lo), "m", "p", "n", k,
                      bars=(0.5, 0.35))
    p = "fp" if case == "eclipse" else "rp"
    keys = [f"{p}_mcmc_{k}" for k in ("median", "plus", "minus", "rhat",
                                      "ess")]
    for c_t, c_j in zip(got["channels"], want["channels"]):
        post_t = {k: c_t.pop(k) for k in keys}
        post_j = {k: c_j.pop(k) for k in keys}
        _same_law(post_t, post_j, keys[0], keys[1], keys[2], "channel")
        assert post_t[keys[4]] > 0.0 and np.isfinite(post_t[keys[3]])
    gaps = compare_reports(want, got)
    assert not gaps, gaps


def test_run_reduce_mcmc_phase_refusal_matches_jax(visits, tmp_path):
    """``--mcmc`` in phase mode: both packages refuse with one message."""
    said = []
    for main in (reduce_j, reduce_t):
        with pytest.raises(SystemExit, match="not wired for --mode phase") \
                as err, contextlib.redirect_stdout(io.StringIO()):
            main(["-d", visits["orbit"][0], "-p", visits["orbit"][1],
                  "--cpu", "-o", str(tmp_path / "x.json"), "--mode",
                  "phase", "--mcmc", "200"])
        said.append(str(err.value))
    assert said[0] == said[1], said


def test_compare_reports_flags_what_differs():
    """compare_reports finds a depth beyond its bar, a missing key, a flag
    and a NaN against a number, and passes rounding-level differences."""
    a = {"mode": "transit", "channels": [
        {"rp_over_rs": 0.16, "rp_sigma": 0.002, "constrained": True}],
        "white_lc": [1.0, 0.99], "white_ramp_fit": {"hook_tau_s": 300.0}}
    b = json.loads(json.dumps(a))
    b["channels"][0]["rp_over_rs"] += 1.9e-5
    b["white_lc"][1] += 1e-6
    b["white_ramp_fit"]["hook_tau_s"] += 2.5
    assert compare_reports(a, b) == []
    b["channels"][0]["rp_over_rs"] += 1e-5
    b["channels"][0]["constrained"] = False
    b["white_lc"][0] = float("nan")
    del b["mode"]
    gaps = compare_reports(a, b)
    assert len(gaps) == 1 and "keys" in gaps[0]
    b["mode"] = "transit"
    gaps = compare_reports(a, b)
    assert len(gaps) == 3, gaps

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
from its float64 than the port's is).
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


def test_run_reduce_mcmc_raises_naming_item_9(visits, tmp_path):
    visit, pars = visits["transit"]
    with pytest.raises(NotImplementedError, match="item 9"):
        reduce_t(["-d", visit, "-p", pars, "--cpu", "--mcmc", "200"])


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

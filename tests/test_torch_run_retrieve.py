"""``python -m wayne_tpu_torch.run_retrieve --cpu`` against ``python -m
wayne_tpu.run_retrieve --cpu`` on the same ima files: a 64^2 scan transit
visit (NSAMP 3, 15 exposures, 48 wavelength bins) and a two-visit program
with carried persistence and a 120 s ephemeris drift (17 exposures each),
both written by the port's own CLIs. The reports must agree key by key
(``_compare``); ``--program --mcmc``'s posterior by its law. The refusals
are the JAX package's, message for message, except where the port repairs
a fault of the reference's CLI: ``--mcmc`` without ``--program`` (ignored
there, refused here) and unequal visits under ``--mcmc`` (refused before
the joint fit here, after it there, with the same message).
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from wayne_tpu.run_retrieve import main as retrieve_j
from wayne_tpu_torch.run_program import main as program_t
from wayne_tpu_torch.run_retrieve import main as retrieve_t
from wayne_tpu_torch.run_visit import main as visit_t

torch.set_num_threads(1)

PLANET = {"period": 0.813475, "t0": 56000.0, "sma_over_rs": 4.855,
          "inclination": 82.1, "rp_over_rs": 0.1595,
          "ld_coeffs": [0.65, -0.25, 0.45, -0.2]}
OBS = {"grism": "G141", "subarray": 64, "NSAMP": 3, "SAMPSEQ": "SPARS10",
       "scan": True, "scan_speed": 0.6, "x_ref": -90.0, "y_ref": 12.0,
       "n_lambda": 48, "n_sub": 2, "mag_J": 10.0}


def _write(path, d) -> str:
    path.write_text(yaml.safe_dump(d))
    return str(path)


@pytest.fixture(scope="module")
def visit(tmp_path_factory):
    """(directory, YAML) of a transit visit written by the port."""
    root = tmp_path_factory.mktemp("retrieve")
    pars = _write(root / "visit.yml", {
        **OBS, **PLANET, "num_orbits": 3, "exposures_per_orbit": 5,
        "start_mjd": 55999.93, "seed": 4, "outdir": str(root / "visit")})
    with contextlib.redirect_stdout(io.StringIO()):
        assert visit_t(["-p", pars, "--cpu", "--chunk", "5"]) == 0
    return str(root / "visit"), pars


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    """(directory, YAML) of a two-visit program written by the port."""
    root = tmp_path_factory.mktemp("program")
    times = [56000.0 + m / 1440.0 for m in range(-72, 73, 9)]
    pars = _write(root / "prog.yml", {
        **OBS, **PLANET, "exp_start_times": times, "start_mjd": times[0],
        "seed": 21, "noise": {"read_noise": True, "sky": True, "dark": True},
        "persistence": {"amplitude_e_s": 20.0, "x0_e": 2000.0,
                        "dx_e": 1000.0, "direct_image": False},
        "program": {"num_visits": 2, "visit_spacing_days": 0.0,
                    "carry_persistence": True,
                    "t0_drift_s_per_visit": 120.0}})
    with contextlib.redirect_stdout(io.StringIO()):
        assert program_t(["-p", pars, "-o", str(root / "prog"), "--cpu",
                          "--chunk", "9"]) == 0
    return str(root / "prog"), pars


def _run_both(args, tmp_path, name="retrieved.json"):
    reports = []
    for tag, main in (("jax", retrieve_j), ("torch", retrieve_t)):
        out = str(tmp_path / f"{tag}_{name}")
        with contextlib.redirect_stdout(io.StringIO()):
            assert main([*args, "--cpu", "-o", out]) == 0
        with open(out) as fh:
            reports.append(json.load(fh))
    return reports


# a report number's bar against the JAX package's, by key; any other
# number must be equal
_BARS = {
    "chi2": lambda a: 1e-2 * abs(a) + 1e-3,
    "chi2_per_dof": lambda a: 1e-2 * abs(a) + 1e-4,
    "t0_offsets_s": lambda a: 0.05,
    "drift_s_per_visit_fitted": lambda a: 0.1,
    "slope_per_day": lambda a: 1e-2 * abs(a) + 1e-6,
    "hook_amp": lambda a: 1e-2 * abs(a) + 1e-6,
}


def _compare(a, b, path="") -> list[str]:
    """Where two run_retrieve reports disagree: the same keys, strings,
    flags, integers and list lengths; a depth (rp_over_rs, fp_over_fs)
    within max(1e-5, 0.01 of its sigma); every sigma within 5e-3 relative
    (the reported sigmas scale with each channel's residual rms); chi^2
    within 1e-2 relative; a t0 offset within 0.05 s, the fitted drift
    within 0.1 s; the trend nuisances within 1e-2 relative; every other
    number exact (wavelength edges, counts)."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [f"{path}: keys {sorted(a)} vs {b!r:.60}"]
        out = []
        for k in a:
            sig = a.get("rp_sigma", a.get("fp_sigma"))
            if k in ("rp_over_rs", "fp_over_fs"):
                bar = max(1e-5, 0.01 * sig) + 1e-7
            elif "sigma" in k:
                out += _compare_list(a[k], b[k], f"{path}/{k}",
                                     lambda x: 5e-3 * abs(x) + 1e-6)
                continue
            elif k in _BARS:
                out += _compare_list(a[k], b[k], f"{path}/{k}", _BARS[k])
                continue
            else:
                out += _compare(a[k], b[k], f"{path}/{k}")
                continue
            if not abs(a[k] - b[k]) <= bar:
                out.append(f"{path}/{k}: {a[k]} vs {b[k]} (bar {bar:.3g})")
        return out
    if isinstance(a, list):
        if not isinstance(b, list) or len(a) != len(b):
            return [f"{path}: length {len(a)} vs {b!r:.40}"]
        return [g for x, y in zip(a, b) for g in _compare(x, y, path + "[]")]
    if a != b or type(a) is not type(b):
        return [f"{path}: {a!r} vs {b!r}"]
    return []


def _compare_list(a, b, path, bar) -> list[str]:
    if isinstance(a, list):
        if not isinstance(b, list) or len(a) != len(b):
            return [f"{path}: length {len(a)} vs {b!r:.40}"]
        return [g for x, y in zip(a, b) for g in _compare_list(x, y, path,
                                                                bar)]
    if not abs(a - b) <= bar(a):
        return [f"{path}: {a} vs {b} (bar {bar(a):.3g})"]
    return []


@pytest.mark.parametrize("flags", [
    [], ["--estimator", "ramp", "--rows", "4:60", "--fit-ramp"]],
    ids=["cds", "ramp_rows_fit_ramp"])
def test_run_retrieve_matches_jax(flags, visit, tmp_path):
    """Four channels, three LM steps, chunks of five exposures: the two
    reports key by key (``_compare``); the depths near the injected 0.1595
    (measured: depths 8e-7 apart at most, sigmas 1.4e-3, chi^2 4e-4)."""
    d, pars = visit
    want, got = _run_both(["-d", d, "-p", pars, "--n-chan", "4", "--n-lm",
                           "3", "--chunk", "5", *flags], tmp_path)
    gaps = _compare(want, got)
    assert not gaps, gaps
    rp = np.array([c["rp_over_rs"] for c in got["channels"]])
    assert np.all(np.abs(rp - 0.1595) < 0.02), rp


def test_run_retrieve_program_mcmc_matches_jax(program, tmp_path):
    """``--program --mcmc 1500`` on two channels: the joint fit key by key,
    the drift near the injected 120 s, and the program posterior by its
    law. The CLI's chain (26 walkers, 9 dimensions) mixes slowly (ESS 60-80
    in both packages), so each median and half-width is held within 4
    Monte-Carlo sigmas of the two reports' difference, from their
    ``ess_min``: a median's error is 1.2533 w / sqrt(ESS) (w the
    half-width), a half-width's relative error 1 / sqrt(2 ESS) (measured:
    medians 0.26 of the bar at most, half-widths 0.14)."""
    d, pars = program
    want, got = _run_both(["-d", d, "-p", pars, "--program", "--n-chan",
                           "2", "--n-lm", "3", "--chunk", "9", "--mcmc",
                           "1500"], tmp_path, "retrieved_joint.json")
    pp_j, pp_t = want.pop("program_posterior"), got.pop("program_posterior")
    gaps = _compare(want, got)
    assert not gaps, gaps
    assert set(pp_t) == set(pp_j)
    assert pp_t["n_steps"] == 1500 and pp_t["n_burn"] == pp_j["n_burn"]
    assert 0.05 < pp_t["acceptance"] < 0.95 and pp_t["ess_min"] > 10.0
    inv_ess = 1.0 / pp_t["ess_min"] + 1.0 / pp_j["ess_min"]
    med_bar = 4.0 * 1.2533 * np.sqrt(inv_ess)
    width_bar = 4.0 * np.sqrt(0.5 * inv_ess)
    for key in ("t0_offsets_percentiles_16_50_84_s",
                "rp_percentiles_16_50_84"):
        for (lo_t, m_t, hi_t), (lo_j, m_j, hi_j) in zip(pp_t[key],
                                                        pp_j[key]):
            w_j, w_t = 0.5 * (hi_j - lo_j), 0.5 * (hi_t - lo_t)
            assert abs(m_t - m_j) <= med_bar * w_j, (key, pp_t, pp_j)
            assert abs(w_t / w_j - 1.0) <= width_bar, (key, pp_t, pp_j)
    t0 = np.array(got["t0_offsets_s"])
    assert abs(t0[1] - t0[0] - 120.0) < 30.0, t0


def test_run_retrieve_refusals(visit, program, tmp_path):
    """The JAX package's refusals, message for message: a YAML whose plan
    does not match the files, a directory without ima files, --mcmc in
    eclipse mode on the program path, a visit directory given as a
    program. The port's own: --mcmc without --program, and unequal visits
    under --mcmc before the joint fit (the JAX package's message, which it
    gives after the fit)."""
    d, pars = visit
    with open(pars) as fh:
        bad = {**yaml.safe_load(fh), "start_mjd": 56000.4}
    bad_pars = _write(tmp_path / "bad.yml", bad)
    empty = tmp_path / "empty"
    empty.mkdir()
    pd, ppars = program
    cases = [
        (["-d", d, "-p", bad_pars], "EXPSTART"),
        (["-d", str(empty), "-p", pars], "no \\*_ima.fits"),
        (["-d", pd, "-p", ppars, "--program", "--mode", "eclipse",
          "--mcmc", "100"], "wired for transit mode"),
        (["-d", d, "-p", pars, "--program"], "program_summary.json"),
    ]
    for args, match in cases:
        said = []
        for main in (retrieve_j, retrieve_t):
            with pytest.raises(SystemExit, match=match) as err, \
                    contextlib.redirect_stdout(io.StringIO()):
                main([*args, "--cpu", "-o", str(tmp_path / "x.json")])
            said.append(str(err.value))
        assert said[0] == said[1], said
    with pytest.raises(SystemExit, match="needs --program"):
        retrieve_t(["-d", d, "-p", pars, "--cpu", "--mcmc", "100"])
    # visit 2 loses one exposure: the port refuses before the joint fit
    short = tmp_path / "short"
    shutil.copytree(pd, short)
    last = sorted(f for f in os.listdir(short / "visit_01")
                  if f.endswith("_ima.fits"))[-1]
    os.remove(short / "visit_01" / last)
    import wayne_tpu_torch.retrieval as ret_t
    real, calls = ret_t.retrieve_transmission_joint, []
    ret_t.retrieve_transmission_joint = lambda *a, **k: calls.append(a)
    try:
        with pytest.raises(SystemExit, match="equal-length visits") as err, \
                contextlib.redirect_stdout(io.StringIO()):
            retrieve_t(["-d", str(short), "-p", ppars, "--program", "--cpu",
                        "--mcmc", "100", "-o", str(tmp_path / "y.json")])
    finally:
        ret_t.retrieve_transmission_joint = real
    assert not calls
    assert str(err.value) == ("program posterior needs equal-length visits "
                              "(got [16, 17])")

"""The port's exposure-time calculator (wayne_tpu_torch.etc) against the JAX
package's on the same configurations, its CLI's exit codes, and the
quicklook diagnostics (wayne_tpu_torch.diagnostics, ``run_visit
--quicklook``) on the CPU.

Bars: every number of the ETC report within rtol 1e-5 (the peak charge of
each read, the source electrons, the SNRs), the background (a difference of
two float32 charges) within 4 ulps of the peak charge, the integers, the
saturating read and the warnings equal.
"""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch
import yaml

from wayne_tpu.config import config_from_dict as config_j
from wayne_tpu.etc import main as etc_main_j
from wayne_tpu.etc import predict as predict_j
from wayne_tpu_torch.config import config_from_dict
from wayne_tpu_torch.etc import main as etc_main
from wayne_tpu_torch.etc import predict

torch.set_num_threads(1)

BASE = {"grism": "G141", "subarray": 128, "NSAMP": 4,
        "SAMPSEQ": "SPARS10", "scan": True, "x_ref": 30.0,
        "y_ref": 40.0, "n_lambda": 64, "n_sub": 4, "seed": 0}


def _assert_report(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "background_e_per_px":
            # the last read less the ideal frame: two float32 numbers of
            # up to the peak charge, so 4 ulps of the peak bound the gap
            ulp = float(np.spacing(np.float32(max(want.peak_e_per_read))))
            assert abs(a - b) <= 4.0 * ulp, (a, b, ulp)
        elif isinstance(b, float) or (isinstance(b, list) and b
                                    and isinstance(b[0], float)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("kw", [{}, {"scan": False},
                                {"flat": False, "SAMPSEQ": "RAPID"}],
                         ids=["scan", "staring", "no_flat_rapid"])
def test_predict_matches_jax(kw):
    """The scan configuration with headroom, the same brightness staring
    (saturates), and a flat-free RAPID sequence."""
    pars = {**BASE, **kw}
    want = predict_j(config_j(pars))
    got = predict(config_from_dict(pars), device="cpu")
    _assert_report(got, want)
    assert (got.first_saturating_read is None) == kw.get("scan", True)


def test_predict_runs_the_exposure_noise_free_with_the_ideal_frame(
        monkeypatch):
    """predict() hands simulate_exposure the configuration's static with
    every noise flag off but sky, dark and (as configured) flat, and
    compute_ideal on: the report's source total is the ideal frame's."""
    import wayne_tpu_torch.ops.exposure as ex

    seen = {}
    real = ex.simulate_exposure

    def spy(scene, tables, cfg):
        seen["cfg"] = cfg
        seen["res"] = real(scene, tables, cfg)
        return seen["res"]

    monkeypatch.setattr(ex, "simulate_exposure", spy)
    rep = predict(config_from_dict(BASE), sat_margin=0.5, device="cpu")
    noise = seen["cfg"].noise
    assert seen["cfg"].compute_ideal
    assert (noise.sky, noise.dark, noise.flat) == (True, True, True)
    assert not any((noise.poisson, noise.read_noise, noise.cosmic_rays,
                    noise.non_linearity, noise.bias))
    np.testing.assert_allclose(rep.source_e_per_exposure,
                               float(seen["res"].ideal_e.double().sum()),
                               rtol=1e-6)


def test_etc_cli_exit_codes_match_jax(tmp_path):
    """0 with headroom, 2 when a read saturates; the same summary lines."""
    for kw, rc in (({}, 0), ({"scan": False}, 2)):
        p = tmp_path / f"pars_{rc}.yml"
        p.write_text(yaml.safe_dump({**BASE, **kw}))
        said = []
        for main, extra in ((etc_main_j, ["--cpu"]), (etc_main, ["--cpu"])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert main(["-p", str(p), *extra]) == rc
            said.append(out.getvalue().splitlines())
        assert len(said[0]) == len(said[1])
        assert [ln.split()[0] for ln in said[0]] == [
            ln.split()[0] for ln in said[1]]


def test_run_visit_quicklook_writes_pngs(tmp_path):
    """run_visit --quicklook --cpu reads the written files back and draws
    the first exposure and the visit's spectra and white light curve."""
    from wayne_tpu_torch.run_visit import main as visit_main

    pars = {**BASE, "subarray": 64, "NSAMP": 2, "x_ref": -60.0,
            "y_ref": 10.0, "num_orbits": 1, "exposures_per_orbit": 4,
            "n_lambda": 32, "n_sub": 2, "outdir": str(tmp_path / "out")}
    p = tmp_path / "pars.yml"
    p.write_text(yaml.safe_dump(pars))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert visit_main(["-p", str(p), "--cpu", "--chunk", "4",
                           "--quicklook"]) == 0
    assert "quicklooks:" in out.getvalue()
    for name in ("exposure0.png", "visit_lightcurve.png"):
        path = tmp_path / "out" / name
        assert path.stat().st_size > 10_000
        with open(path, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_quicklook_curves_match_the_files_reduced(tmp_path):
    """The quicklook's curves are reduce_visit's of the files read back
    (read_back), over the whole frame in 8 channels."""
    from wayne_tpu_torch.diagnostics import quicklook_curves
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.reduction import reduce_visit
    from wayne_tpu_torch.run_visit import read_back

    cfg = config_from_dict({**BASE, "subarray": 64, "NSAMP": 2,
                            "x_ref": -60.0, "y_ref": 10.0, "num_orbits": 1,
                            "exposures_per_orbit": 4, "n_lambda": 32,
                            "n_sub": 2})
    obs = Observation(cfg, device="cpu")
    obs.generate(str(tmp_path), chunk=4, progress=lambda s: None)
    reads = read_back(obs, str(tmp_path))
    assert reads.shape == (4, 3, 64, 64)
    red, mid = quicklook_curves(obs, reads)
    want = reduce_visit(torch.from_numpy(reads), obs.tables.gain,
                        torch.as_tensor(mid, dtype=torch.float32),
                        obs.planet.orbit_params(), y_window=(0, 64),
                        x_window=(0, 64), bg_rows=(0, 4), n_chan=8)
    torch.testing.assert_close(red.white_lc, want.white_lc, rtol=0, atol=0)
    assert red.channel_lc.shape == (4, 8)


def test_quicklook_reduction_png(tmp_path):
    """quicklook_reduction draws a run_reduce report (transit and
    emission keys)."""
    from wayne_tpu_torch.diagnostics import quicklook_reduction

    for mode, key, sigma in (("transit", "rp_over_rs", "rp_sigma"),
                             ("eclipse", "fp_over_fs", "fp_sigma")):
        report = {"mode": mode, "mid_times_s": [0.0, 100.0, 200.0],
                  "white_lc": [1.0, 0.99, 1.0], "channels": [
                      {"wl_lo_um": 1.1, "wl_hi_um": 1.2, key: 0.15,
                       sigma: 0.001}]}
        path = quicklook_reduction(report, str(tmp_path / f"{mode}.png"))
        assert os.path.getsize(path) > 5_000

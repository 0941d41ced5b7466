"""The reference-compat surface of the port against the JAX package's:
``compat.run`` and ``ExposureGenerator`` (tests/test_compat.py),
``WFC3IRDetector`` and ``StageTimers`` (tests/test_models.py) and
``device_trace``; the Exposure product is in test_torch_native_fits.py."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch
import yaml

from wayne_tpu.compat import ExposureGenerator as ExposureGenerator_j
from wayne_tpu.config import NoiseFlags as NoiseFlags_j
from wayne_tpu.io.ima import read_ima as read_ima_j
from wayne_tpu.models.detector import WFC3IRDetector as WFC3IRDetector_j
from wayne_tpu_torch.compat import ExposureGenerator, run
from wayne_tpu_torch.config import NoiseFlags
from wayne_tpu_torch.io.ima import read_ima
from wayne_tpu_torch.models.detector import WFC3IRDetector
from wayne_tpu_torch.models.grism import make_grism
from wayne_tpu_torch.utils.profiling import (
    StageTimers, device_trace, span, tracing,
)

torch.set_num_threads(1)

GEOMETRY = dict(subarray=64, n_lambda=32, nsamp=3, samp_seq="SPARS10",
                n_sub=4)


@pytest.mark.parametrize("scan", [False, True])
def test_exposure_generator_frames_match_jax(scan):
    """Staring and scanning frames, the noise off, port against the JAX
    package's ExposureGenerator at the exposure tests' bar: rtol 2e-5,
    floor 5e-6 of the peak (e-). The scan is short (0.5 px/s): a longer
    one spreads the peak while the erf wings' rounding stays."""
    gj = ExposureGenerator_j("G141", noise=NoiseFlags_j.none(), **GEOMETRY)
    gt = ExposureGenerator("G141", noise=NoiseFlags.none(), device="cpu",
                           **GEOMETRY)
    if scan:
        ref = gj.scanning_frame(20.0, 25.0, scan_speed=0.5)
        got = gt.scanning_frame(20.0, 25.0, scan_speed=0.5)
    else:
        ref = gj.staring_frame(20.0, 25.0)
        got = gt.staring_frame(20.0, 25.0)
    assert got.reads_dn.shape == (4, 64, 64) and got.ideal_e.shape == (64, 64)
    peak = float(np.asarray(ref.ideal_e).max())
    assert peak > 100.0                              # the spectrum landed
    np.testing.assert_allclose(got.ideal_e.numpy(), np.asarray(ref.ideal_e),
                               rtol=2e-5, atol=5e-6 * peak)
    # the reads in electrons, at the same floor (float32 erf wings)
    np.testing.assert_allclose(got.reads_dn.numpy() * 2.5,
                               np.asarray(ref.reads_dn) * 2.5, rtol=2e-5,
                               atol=max(1e-3, 5e-6 * peak))


def test_grism_instance_geometry_and_seedless_rng():
    """A pre-built Grism's geometry wins over the constructor defaults;
    seeded frames repeat bit for bit, seedless calls advance the generator
    (each differs from the last and from the explicit seed)."""
    g = make_grism("G141", subarray=64, n_lambda=32, samp_seq="RAPID",
                   nsamp=2)
    noise = dataclasses.replace(NoiseFlags.none(), poisson=True,
                                read_noise=True)
    gen = ExposureGenerator(g, n_sub=2, noise=noise, seed=5)
    a = gen.staring_frame(15.0, 20.0)
    assert a.reads_dn.shape == (3, 64, 64)               # instance geometry
    b = gen.staring_frame(15.0, 20.0)
    assert not torch.equal(a.reads_dn, b.reads_dn)
    c = gen.staring_frame(15.0, 20.0, seed=5)
    d = gen.staring_frame(15.0, 20.0, seed=5)
    assert torch.equal(c.reads_dn, d.reads_dn)
    assert not torch.equal(a.reads_dn, c.reads_dn)
    assert gen.scanning_frame(15.0, 20.0, seed=5).reads_dn.shape == (3, 64, 64)


def test_run_parameter_file(tmp_path):
    """``compat.run`` generates the visit: the same exposures and headers
    as the JAX package's Observation for the same YAML."""
    from wayne_tpu.compat import run as run_j

    pars = {"observation": dict(grism="G141", subarray=64, NSAMP=2,
                                SAMPSEQ="SPARS10", scan=True, num_orbits=1,
                                exposures_per_orbit=2, n_lambda=16, n_sub=2,
                                x_ref=20.0, y_ref=20.0),
            "target": dict(name="T", mag_J=10.5)}
    parfile = tmp_path / "pars.yml"
    parfile.write_text(yaml.safe_dump(pars))
    paths = run(str(parfile), outdir=str(tmp_path / "out"), chunk=2,
                device="cpu")
    ref = run_j(str(parfile), outdir=str(tmp_path / "ref"), chunk=2)
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in ref] == ["T_0000_ima.fits",
                                              "T_0001_ima.fits"]
    for p, q in zip(paths, ref):
        (hp, rp, tp), (hq, rq, tq) = read_ima(p), read_ima_j(q)
        assert rp.shape == rq.shape == (3, 64, 64)
        np.testing.assert_array_equal(tp, tq)
        assert {k: hp[k] for k in ("NSAMP", "EXPSTART", "TARGNAME")} == {
            k: hq[k] for k in ("NSAMP", "EXPSTART", "TARGNAME")}


def test_detector_matches_jax():
    for sub in (64, 256, 1024):
        dj, dt = WFC3IRDetector_j(sub), WFC3IRDetector(sub)
        for seq, nsamp in (("SPARS10", 15), ("RAPID", 3), ("STEP50", 8)):
            np.testing.assert_array_equal(dt.get_read_times(nsamp, seq),
                                          dj.get_read_times(nsamp, seq))
            assert dt.exptime(nsamp, seq) == dj.exptime(nsamp, seq)
            assert dt.scan_length_px(1.3, nsamp, seq) == dj.scan_length_px(
                1.3, nsamp, seq)
        assert dt.min_frame_time() == dj.min_frame_time()
        assert dt.subarray_corner() == dj.subarray_corner()
        assert dt.arcsec_to_pix(1.0) == dj.arcsec_to_pix(1.0)
        assert dt.pix_to_arcsec(3.0) == dj.pix_to_arcsec(3.0)
    assert (WFC3IRDetector.full_frame, WFC3IRDetector.pixel_area_cm2) == (
        WFC3IRDetector_j.full_frame, WFC3IRDetector_j.pixel_area_cm2)
    for mod in (WFC3IRDetector, WFC3IRDetector_j):
        with pytest.raises(ValueError, match="invalid subarray"):
            mod(100)


def test_stage_timers_and_device_trace(tmp_path):
    with tracing() as handle:
        with span("a"):
            time.sleep(0.01)
        with span("a"):
            with span("b"):
                time.sleep(0.01)
    t = StageTimers(handle.spans)
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0.02
    assert s["b"]["count"] == 1 and s["b"]["self_s"] >= 0.01
    assert s["a"]["self_s"] == pytest.approx(
        s["a"]["total_s"] - s["b"]["total_s"], abs=1e-9)
    assert "a" in t.report()
    with tracing(), device_trace(str(tmp_path / "trace")):
        with span("c"):
            torch.ones(64).cumsum(0)
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert any(e.get("name") == "wt:c" for e in events)

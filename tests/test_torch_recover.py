"""Recovered depth labels in the port's dataset path
(wayne_tpu_torch.parallel.dataset.generate_dataset(recover=...) and
run_dataset --recover) on the CPU: the stored recovered_rp against the JAX
package's spectra_to_depths of the port's own stored spectra (random bits
are never compared), the recovered depths against the injected sweep, the
resume checks and the CLI.

Bars: rp atol 1e-5; rp_sigma (total, rel, common) rtol 1e-3; the
constrained flags exact.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu.calibration import synthetic_tables
from wayne_tpu.config import ExposureStatic, NoiseFlags
from wayne_tpu.reduction import constrained_mask as constrained_mask_j
from wayne_tpu.reduction import spectra_to_depths as spectra_to_depths_j
from wayne_tpu.scene import example_scene
from wayne_tpu_torch import config as config_t
from wayne_tpu_torch.convert import (
    numpy_leaves, scenes_from_numpy, tables_from_numpy,
)
from wayne_tpu_torch.ops.kepler import OrbitParams
from wayne_tpu_torch.parallel.dataset import (
    _fingerprint, generate_dataset, load_dataset,
)
from wayne_tpu_torch.parallel.torch_data import WayneSpectraDataset
from wayne_tpu_torch.run_dataset import main as run_dataset

torch.set_num_threads(1)

S, NL, NSAMP, N_EXP, N_MC = 64, 32, 3, 16, 4
X_WIN = (0, 61)                 # the trace's columns at x_ref = -120
CFG = ExposureStatic(
    subarray=S, n_lambda=NL, n_sub=2, nsamp=NSAMP, samp_seq="SPARS10",
    scan=True, band_px=48, transit_quad=16,
    noise=dataclasses.replace(NoiseFlags.none(), poisson=True,
                              read_noise=True))
TABLES = synthetic_tables("G141", subarray=S, n_lambda=NL,
                          samp_seq="SPARS10", nsamp=NSAMP)
RP_INJ = np.linspace(0.13, 0.18, N_MC).astype(np.float32)


def _static_t():
    kw = dataclasses.asdict(CFG)
    kw["noise"] = config_t.NoiseFlags(**kw["noise"])
    return config_t.ExposureStatic(**kw)


def _visit():
    """(JAX base scene, the port's (n_exp,) visit, exposure mid-times): a
    scan whose trace fills columns 0-60, 16 exposures over 4 h around the
    2 h transit."""
    base = dataclasses.replace(example_scene(NL, scan_speed=1.0),
                               x_ref=jnp.float32(-120.0),
                               y_ref=jnp.float32(8.0))
    starts = np.linspace(0.0, 4.0 * 3600.0, N_EXP).astype(np.float32)
    visit = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N_EXP,) + x.shape), base)
    visit = dataclasses.replace(visit, exp_start_s=jnp.asarray(starts))
    mid = (starts + float(TABLES.read_times[-1]) / 2.0).astype(np.float32)
    return base, scenes_from_numpy(numpy_leaves(visit), "cpu"), mid


def _recover(base, mid, n_chan=3):
    orbit = OrbitParams(**{f.name: torch.as_tensor(np.asarray(
        getattr(base.orbit, f.name))) for f in dataclasses.fields(
            OrbitParams)})
    return {"exp_mid_s": mid, "orbit": orbit,
            "ld": torch.as_tensor(np.asarray(base.ld)), "rp0": 0.15,
            "x_window": X_WIN, "n_chan": n_chan}


def _generate(d, recover, **kw):
    base, visit, mid = _visit()
    over = {"rp_over_rs": np.broadcast_to(RP_INJ[:, None], (N_MC, NL))}
    return generate_dataset(
        visit, tables_from_numpy(numpy_leaves(TABLES), "cpu"), _static_t(),
        str(d), n_mc=N_MC, chunk_mc=2, overrides=over,
        labels={"rp": RP_INJ}, recover=recover, device="cpu", **kw)


@pytest.fixture(scope="module")
def recovered(tmp_path_factory):
    d = tmp_path_factory.mktemp("recovered")
    base, _, mid = _visit()
    manifest = _generate(d, _recover(base, mid))
    return d, manifest, load_dataset(str(d)), base, mid


def test_recovered_labels_match_jax_on_the_stored_spectra(recovered):
    """Every chunk's recovered labels = the JAX package's
    spectra_to_depths (sigma components, subtract_bg, divide-white) of
    the port's own stored spectra: rp at atol 1e-5 (measured 5.7e-7), the
    three sigmas at rtol 1e-3 (measured <= 1.1e-4), the constrained flags
    exactly; the JAX keys and manifest."""
    d, manifest, data, base, mid = recovered
    assert manifest["recovered"] is True
    assert manifest["recover"]["n_chan"] == 3
    assert manifest["recover"]["x_window"] == list(X_WIN)
    with np.load(d / "chunk_0001.npz") as z:
        assert set(z.files) == {
            "spectra_e", "label_rp", "recovered_rp", "recovered_rp_sigma",
            "recovered_rp_sigma_rel", "recovered_rp_sigma_common",
            "recovered_constrained"}
    want = spectra_to_depths_j(
        jnp.asarray(data["spectra_e"]), jnp.asarray(mid), base.orbit,
        base.ld, 0.15, x_window=X_WIN, n_chan=3, subtract_bg=True,
        sigma_components=True)
    want = [np.asarray(w) for w in want]
    np.testing.assert_allclose(data["recovered_rp"], want[0], rtol=0,
                               atol=1e-5)
    for key, w in zip(("recovered_rp_sigma", "recovered_rp_sigma_rel",
                       "recovered_rp_sigma_common"), want[1:]):
        np.testing.assert_allclose(data[key], w, rtol=1e-3)
    np.testing.assert_array_equal(
        data["recovered_constrained"],
        np.asarray(constrained_mask_j(want[0], want[1])))
    assert data["recovered_rp_sigma_common"].shape == (N_MC,)
    # the adapter exposes the recovered labels per item
    _, lab = WayneSpectraDataset(str(d))[1]
    np.testing.assert_allclose(lab["recovered_rp"], data["recovered_rp"][1])


def test_recovered_depths_track_the_injected_sweep(recovered):
    """Each realisation's fitted depths lie within max(6 sigma, 0.01) of
    its injected radius, and the sweep's order survives recovery."""
    _, _, data, _, _ = recovered
    assert data["recovered_rp"].shape == (N_MC, 3)
    assert np.all(data["recovered_rp_sigma"] > 0)
    err = np.abs(data["recovered_rp"] - data["label_rp"][:, None])
    tol = np.maximum(6.0 * data["recovered_rp_sigma"], 0.01)
    assert np.all(err < tol), (data["recovered_rp"], RP_INJ)
    assert np.all(np.diff(data["recovered_rp"].mean(axis=1)) > 0)


def test_recover_resume_checks(tmp_path):
    """Turning recover on over chunks written without it is refused, as is
    n_chan 0; the inputs' fingerprint moves with the mid-times, the orbit
    and the limb darkening, and with nothing else."""
    base, _, mid = _visit()
    rec = _recover(base, mid)
    _generate(tmp_path, None)
    with pytest.raises(ValueError, match="resume mismatch"):
        _generate(tmp_path, rec)
    with pytest.raises(ValueError, match="n_chan"):
        _generate(tmp_path / "zero", dict(rec, n_chan=0))
    key = (rec["exp_mid_s"], rec["orbit"], rec["ld"])
    same = (rec["exp_mid_s"].copy(), dataclasses.replace(rec["orbit"]),
            rec["ld"].clone())
    assert _fingerprint(key) == _fingerprint(same)
    moved = [(mid + 1.0, rec["orbit"], rec["ld"]),
             (mid, dataclasses.replace(rec["orbit"],
                                       t0_s=rec["orbit"].t0_s + 1.0),
              rec["ld"]),
             (mid, rec["orbit"], rec["ld"] * 1.01)]
    assert len({_fingerprint(k) for k in moved} | {_fingerprint(key)}) == 4


def test_recover_resumes_and_reports(tmp_path):
    """A recovered dataset resumes (every chunk skipped) with the same
    recover settings and refuses another channel count."""
    base, _, mid = _visit()
    rec = _recover(base, mid, n_chan=2)
    m = _generate(tmp_path, rec)
    log = []
    assert _generate(tmp_path, rec, progress=log.append) == m
    assert len(log) == 2 and all("skipping" in s for s in log)
    with pytest.raises(ValueError, match="recover"):
        _generate(tmp_path, dict(rec, n_chan=3))
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["recover"]["inputs_sha"] == m["recover"]["inputs_sha"]


TINY_YAML = """\
observation:
  grism: G141
  subarray: 64
  NSAMP: 2
  SAMPSEQ: SPARS10
  scan: true
  x_ref: -120.0
  y_ref: 10.0
  num_orbits: 1
  exposures_per_orbit: 3
  n_lambda: 16
  n_sub: 2
"""


def test_run_dataset_cpu_recover(tmp_path, capsys):
    """``run_dataset --cpu --recover 3`` writes the recovered keys over the
    trace's columns; an eclipse visit is refused with the JAX message."""
    yml = tmp_path / "pars.yml"
    yml.write_text(TINY_YAML)
    out = tmp_path / "ds"
    assert run_dataset(["-p", str(yml), "-o", str(out), "--n-mc", "2",
                        "--chunk-mc", "2", "--cpu", "--recover", "3"]) == 0
    assert "recovered labels: 3 channels over columns [0, " in \
        capsys.readouterr().out
    data = load_dataset(str(out))
    assert data["recovered_rp"].shape == (2, 3)
    assert data["recovered_constrained"].dtype == bool
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["recovered"] and manifest["recover"]["n_chan"] == 3
    yml.write_text(TINY_YAML + "planet:\n  eclipse_depth: 0.004\n")
    with pytest.raises(SystemExit):
        run_dataset(["-p", str(yml), "-o", str(tmp_path / "ecl"), "--n-mc",
                     "2", "--chunk-mc", "2", "--cpu", "--recover", "3"])
    assert "--recover fits transit depths; eclipse/phase-curve datasets " \
        "are not supported" in capsys.readouterr().err

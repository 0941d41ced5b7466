"""The port's multi-visit Program, ``run_program`` and the visit-level
physics of ``run_dataset`` on the CPU, against the JAX package where the
two compute the same numbers (noise off): the carried fluence maps and
the products of a visit that persistence from the previous one reached.
Tolerances are the noise-off bar of tests/test_torch_observation.py:
rtol 2e-5 with an absolute floor of max(1e-3, 5e-6 of the peak)."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from wayne_tpu.config import config_from_dict as config_from_dict_j
from wayne_tpu.io.ima import read_ima as read_ima_j
from wayne_tpu.observation import Observation as Observation_j
from wayne_tpu.program import Program as Program_j
from wayne_tpu_torch.config import config_from_dict
from wayne_tpu_torch.io.ima import read_ima
from wayne_tpu_torch.observation import Observation
from wayne_tpu_torch.parallel.dataset import load_dataset
from wayne_tpu_torch.program import Program, visit_config, visit_start_mjds
from wayne_tpu_torch.run_dataset import main as run_dataset
from wayne_tpu_torch.run_program import main as run_program

torch.set_num_threads(1)


def _params(**extra):
    """A two-visit program whose persistence is strong enough to show:
    a low sigmoid knee and a large amplitude."""
    p = {"grism": "G141", "subarray": 64, "NSAMP": 2, "SAMPSEQ": "RAPID",
         "scan": True, "scan_speed": 0.3, "x_ref": 12.0, "y_ref": 20.0,
         "num_orbits": 1, "exposures_per_orbit": 3, "n_lambda": 32,
         "n_sub": 2, "start_mjd": 55999.95, "t0": 56000.0,
         "period": 0.813475, "sma_over_rs": 4.855, "inclination": 82.1,
         "rp_over_rs": 0.1595, "seed": 3, "noise": {"preset": "none"},
         "program": {"num_visits": 2, "visit_spacing_days": 0.0,
                     "t0_drift_s_per_visit": 45.0},
         "persistence": {"amplitude_e_s": 50.0, "x0_e": 600.0,
                         "dx_e": 300.0, "direct_image": True}}
    p.update(extra)
    return p


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=max(1e-3, 5e-6 * float(np.max(want))),
                               err_msg=name)


def test_schedule_matches_jax():
    from wayne_tpu.program import visit_config as visit_config_j
    from wayne_tpu.program import visit_start_mjds as visit_start_mjds_j

    params = _params(program={"num_visits": 3, "t0_drift_s_per_visit": 45.0})
    cj, ct = config_from_dict_j(params), config_from_dict(params)
    assert visit_start_mjds(ct) == visit_start_mjds_j(cj)
    for i in range(3):
        vj, vt = visit_config_j(cj, i), visit_config(ct, i)
        assert (vt.start_mjd, vt.seed, vt.planet.t0_mjd) == \
            (vj.start_mjd, vj.seed, vj.planet.t0_mjd)


def test_two_visit_program_on_cpu_matches_jax(tmp_path, capsys):
    """``run_program --cpu``: the carried fluence map of each visit equals
    the JAX Program's, and visit 2 — whose persistence the carry feeds —
    writes the JAX package's reads."""
    yml = tmp_path / "prog.yml"
    yml.write_text(yaml.safe_dump(_params()))
    out_t, out_j = tmp_path / "torch", tmp_path / "jax"
    assert run_program(["-p", str(yml), "-o", str(out_t), "--cpu",
                        "--chunk", "2"]) == 0
    assert "wrote 6 exposures over 2 visits" in capsys.readouterr().out
    Program_j(config_from_dict_j(_params())).generate(
        str(out_j), chunk=2, progress=lambda s: None)

    summary = json.loads((out_t / "program_summary.json").read_text())
    assert [v["dir"] for v in summary["visits"]] == ["visit_00", "visit_01"]
    for vdir in ("visit_00", "visit_01"):
        got = np.load(out_t / vdir / Program.CARRY_FILE)
        want = np.load(out_j / vdir / Program_j.CARRY_FILE)
        assert got.shape == (64, 64) and got.dtype == np.float32
        _close(got, want, vdir)
        mt = json.loads((out_t / vdir / Program.CARRY_META).read_text())
        mj = json.loads((out_j / vdir / Program_j.CARRY_META).read_text())
        assert mt["end_mjd"] == mj["end_mjd"]
        assert summary["visits"][int(vdir[-1])]["carry"] == mt
    for name in sorted(os.listdir(out_j / "visit_01")):
        if name.endswith("_ima.fits"):
            _, rj, _ = read_ima_j(str(out_j / "visit_01" / name))
            _, rt, _ = read_ima(str(out_t / "visit_01" / name))
            _close(rt, rj, name)


def test_carry_feeds_the_next_visits_persistence(tmp_path):
    """Visit 2 of a carrying program holds more charge than the same
    visit with the carry off."""
    reads = {}
    for carry in (True, False):
        p = _params()
        p["program"] = dict(p["program"], carry_persistence=carry)
        out = tmp_path / str(carry)
        Program(config_from_dict(p), device="cpu").generate(
            str(out), chunk=3, progress=lambda s: None)
        _, reads[carry], _ = read_ima(str(out / "visit_01" /
                                          "star_0000_ima.fits"))
    assert float(reads[True][-1].sum()) > float(reads[False][-1].sum()) + 1.0


def test_carry_reuse_rejects_stale_config(tmp_path):
    """A resumed visit reuses its carry only when the stamped config
    fingerprint matches (as tests/test_program.py holds the JAX
    Program)."""
    params = _params()
    out = tmp_path / "prog"
    prog = Program(config_from_dict(params), device="cpu")
    prog.generate(str(out), chunk=3, progress=lambda s: None)
    meta_p = out / "visit_00" / Program.CARRY_META
    npy_p = out / "visit_00" / Program.CARRY_FILE
    sha0 = json.loads(meta_p.read_text())["config_sha"]
    m0 = npy_p.stat().st_mtime_ns

    prog.generate(str(out), chunk=3, progress=lambda s: None)
    assert npy_p.stat().st_mtime_ns == m0
    assert json.loads(meta_p.read_text())["config_sha"] == sha0

    params2 = dict(params, persistence=dict(params["persistence"],
                                            amplitude_e_s=80.0))
    Program(config_from_dict(params2), device="cpu").generate(
        str(out), chunk=3, progress=lambda s: None)
    assert npy_p.stat().st_mtime_ns != m0
    assert json.loads(meta_p.read_text())["config_sha"] != sha0


def test_run_program_debug_raises(tmp_path):
    """``run_program --debug`` (once raising, naming item 5b) runs each
    visit's guards and writes its visit_summary.json."""
    yml = tmp_path / "prog.yml"
    yml.write_text(yaml.safe_dump(_params()))
    out = tmp_path / "o"
    assert run_program(["-p", str(yml), "-o", str(out), "--cpu",
                        "--debug"]) == 0
    for v in sorted(out.glob("visit_*")):
        summary = json.loads((v / "visit_summary.json").read_text())
        n = summary["n_exposures"]
        assert n == len(list(v.glob("*_ima.fits"))) > 0
        assert [e["chunk"] for e in summary["exposures"]] == list(
            range(0, n, 8))
        assert all(np.isfinite(e["reads_max_dn"])
                   for e in summary["exposures"])


TINY_YAML = """\
observation:
  subarray: 64
  NSAMP: 2
  x_ref: 10.0
  y_ref: 10.0
  num_orbits: 1
  exposures_per_orbit: 3
  n_lambda: 16
  n_sub: 2
"""


def test_run_dataset_fp_sigma_draws_as_the_jax_cli(tmp_path):
    """``--fp-sigma`` sweeps Fp/Fs per realisation from RandomState(seed
    + 1), as the JAX CLI does: the label is the band mean of the clipped
    shifted spectrum."""
    yml = tmp_path / "pars.yml"
    yml.write_text(TINY_YAML + "planet:\n  eclipse_depth: 5.0e-4\n")
    out = tmp_path / "ds"
    assert run_dataset(["-p", str(yml), "-o", str(out), "--n-mc", "4",
                        "--chunk-mc", "2", "--fp-sigma", "2e-4",
                        "--seed", "5", "--cpu"]) == 0
    data = load_dataset(str(out))
    obs_j = Observation_j(config_from_dict_j(yaml.safe_load(yml.read_text())))
    fp_grid = obs_j.planet.fp_on_grid(np.asarray(obs_j.tables.wl_centers))
    delta = (2e-4 * np.random.RandomState(6).standard_normal(4)
             ).astype(np.float32)
    fp_mc = np.clip(fp_grid[None, :] + delta[:, None], 0.0, None
                    ).astype(np.float32)
    np.testing.assert_array_equal(data["label_fp"], fp_mc.mean(axis=1))
    assert data["spectra_e"].shape == (4, 3, 64)
    assert np.isfinite(data["spectra_e"]).all()


def test_run_dataset_with_persistence_and_recte(tmp_path):
    """A YAML with persistence and RECTE builds a dataset; the charge
    maps are computed once and shared by the realisations, so the
    noise-off spectra of every realisation agree."""
    yml = tmp_path / "pars.yml"
    yml.write_text(TINY_YAML + "noise:\n  preset: none\n"
                   "persistence: {amplitude_e_s: 50.0, x0_e: 600.0, "
                   "dx_e: 300.0}\nrecte: true\n")
    out = tmp_path / "ds"
    assert run_dataset(["-p", str(yml), "-o", str(out), "--n-mc", "2",
                        "--chunk-mc", "2", "--cpu"]) == 0
    sp = load_dataset(str(out))["spectra_e"]
    assert sp.shape == (2, 3, 64) and np.isfinite(sp).all()
    np.testing.assert_array_equal(sp[0], sp[1])
    plain = tmp_path / "plain.yml"
    plain.write_text(TINY_YAML + "noise:\n  preset: none\n")
    assert run_dataset(["-p", str(plain), "-o", str(tmp_path / "ds0"),
                        "--n-mc", "2", "--chunk-mc", "2", "--cpu"]) == 0
    sp0 = load_dataset(str(tmp_path / "ds0"))["spectra_e"]
    assert not np.array_equal(sp, sp0)


@pytest.mark.parametrize("fmt", ["npy", "fits"])
def test_prior_fluence_file_matches_jax(tmp_path, fmt):
    """A prior observation's fluence map (.npy or the first image HDU of a
    FITS file) glows into the visit as the JAX package's does; a map of
    the wrong size raises."""
    from wayne_tpu_torch.io.fits import FitsHDU, write_fits

    prior = np.random.RandomState(4).uniform(0.0, 2000.0, (64, 64)
                                             ).astype(np.float32)
    path = str(tmp_path / f"prior.{fmt}")
    if fmt == "npy":
        np.save(path, prior)
    else:
        write_fits(path, [FitsHDU(), FitsHDU(name="SCI", data=prior)])
    params = dict(_params(), persistence=dict(
        _params()["persistence"], direct_image=False,
        prior_fluence_file=path, prior_end_s=-300.0))
    params.pop("program")
    obs_t = Observation(config_from_dict(params), device="cpu")
    obs_t._ensure_persistence(3)
    obs_j = Observation_j(config_from_dict_j(params))
    obs_j._ensure_persistence(3)
    got = obs_t.scenes.persist_rate.numpy()
    _close(got, np.asarray(obs_j.scenes.persist_rate), fmt)
    assert float(got[0].max()) > 0.0         # the prior glows into exposure 0
    bad = str(tmp_path / "bad.npy")
    np.save(bad, prior[:32])
    params["persistence"]["prior_fluence_file"] = bad
    with pytest.raises(ValueError, match="expected"):
        Observation(config_from_dict(params), device="cpu"
                    )._ensure_persistence(3)

"""``Observation.generate(debug=True)`` of the port against the JAX
package's: the NaN and range guards (``utils.guards``) on each chunk and
the ``visit_summary.json`` they write; ``run_visit --debug``."""

import json

import numpy as np
import pytest
import torch

import wayne_tpu_torch.observation as observation
from wayne_tpu.config import config_from_dict as config_from_dict_j
from wayne_tpu.observation import Observation as Observation_j
from wayne_tpu.utils.guards import check_exposure_result as check_j
from wayne_tpu_torch.config import config_from_dict
from wayne_tpu_torch.observation import HostChunk, Observation
from wayne_tpu_torch.run_visit import main as run_visit
from wayne_tpu_torch.utils.guards import SimulationError, check_exposure_result

torch.set_num_threads(1)

# a tiny visit, the stochastic effects off (deterministic in both packages)
TINY = {"subarray": 64, "NSAMP": 2, "n_lambda": 16, "x_ref": 20.0,
        "y_ref": 20.0, "num_orbits": 1, "exposures_per_orbit": 5,
        "noise": {"poisson": False, "read_noise": False,
                  "cosmic_rays": False, "bias_drift": False}}


def _chunk(**over) -> HostChunk:
    rng = np.random.RandomState(2)
    kw = dict(reads_dn=rng.uniform(900, 3000, (2, 3, 8, 8)).astype(
        np.float32), cr_pos=np.zeros((2, 2, 2, 4), np.int32),
        cr_count=np.zeros((2, 2), np.int32),
        saturated_frac=np.array([0.0, 0.01], np.float32),
        ideal_e=rng.uniform(0, 500, (2, 8, 8)).astype(np.float32))
    kw.update(over)
    return HostChunk(**kw)


def test_guards_match_jax():
    """The same statistics as the JAX package's guards, and the same
    refusals: a NaN read, a NaN or negative ideal charge, a flooded
    frame."""
    ok = _chunk()
    assert check_exposure_result(ok, context="c") == check_j(ok, context="c")
    bad_reads = ok.reads_dn.copy()
    bad_reads[1, 2, 3, 4] = np.nan
    neg = ok.ideal_e.copy()
    neg[0, 0, 0] = -1e4
    nan_ideal = ok.ideal_e.copy()
    nan_ideal[0, 1, 1] = np.nan
    for bad, match in ((dict(reads_dn=bad_reads), "non-finite values in "
                        "reads"),
                       (dict(ideal_e=nan_ideal), "ideal_e"),
                       (dict(ideal_e=neg), "negative ideal charge"),
                       (dict(saturated_frac=np.array([0.0, 0.2])),
                        "saturated fraction")):
        for check in (check_exposure_result, check_j):
            with pytest.raises(Exception, match=match) as err:
                check(_chunk(**bad), context="chunk@8")
            assert type(err.value).__name__ == "SimulationError"
            assert "chunk@8" in str(err.value)


def test_generate_debug_summary_matches_jax(tmp_path):
    obs_j = Observation_j(config_from_dict_j(TINY))
    obs_t = Observation(config_from_dict(TINY), device="cpu")
    paths_j = obs_j.generate(str(tmp_path / "j"), chunk=2, debug=True,
                             progress=lambda s: None)
    paths_t = obs_t.generate(str(tmp_path / "t"), chunk=2, debug=True,
                             progress=lambda s: None)
    assert len(paths_t) == len(paths_j) == 5
    want = json.loads((tmp_path / "j" / "visit_summary.json").read_text())
    got = json.loads((tmp_path / "t" / "visit_summary.json").read_text())
    assert got.keys() == want.keys()
    for k in want:
        if k not in ("exposures", "wallclock_s"):
            assert got[k] == want[k], k
    assert [e["chunk"] for e in got["exposures"]] == [0, 2, 4]
    for e_t, e_j in zip(got["exposures"], want["exposures"]):
        assert e_t.keys() == e_j.keys()
        for k in e_j:
            assert e_t[k] == pytest.approx(e_j[k], rel=2e-5, abs=1e-2), k
    assert got["exposures"][0]["ideal_total_e"] > 1e4    # ideal_e was made
    # without debug: no summary, and ideal_e is neither made nor copied
    fetched = []
    real = observation.HostChunk

    def record(*args):
        fetched.append(args)
        return real(*args)

    observation.HostChunk = record
    try:
        Observation(config_from_dict(TINY), device="cpu").generate(
            str(tmp_path / "plain"), chunk=2, progress=lambda s: None)
    finally:
        observation.HostChunk = real
    assert not (tmp_path / "plain" / "visit_summary.json").exists()
    assert fetched and all(a[4] is None for a in fetched)


def test_generate_debug_raises_on_a_nan_read(tmp_path, monkeypatch):
    real = observation.simulate_visit

    def poisoned(*args, **kw):
        res = real(*args, **kw)
        res.reads_dn[0, 1, 5, 5] = float("nan")
        return res

    monkeypatch.setattr(observation, "simulate_visit", poisoned)
    obs = Observation(config_from_dict(dict(TINY, quantize_adc=False)),
                      device="cpu")
    with pytest.raises(SimulationError, match="chunk@0: 1 non-finite"):
        obs.generate(str(tmp_path), chunk=2, debug=True,
                     progress=lambda s: None)


def test_run_visit_debug_cli(tmp_path, capsys):
    yml = tmp_path / "pars.yml"
    yml.write_text(
        "observation:\n  subarray: 64\n  NSAMP: 2\n  n_lambda: 16\n"
        "  x_ref: 20.0\n  y_ref: 20.0\n  num_orbits: 1\n"
        "  exposures_per_orbit: 3\n")
    out = tmp_path / "out"
    assert run_visit(["-p", str(yml), "-o", str(out), "--cpu", "--chunk",
                      "2", "--debug"]) == 0
    assert "wrote 3 exposures" in capsys.readouterr().out
    summary = json.loads((out / "visit_summary.json").read_text())
    assert summary["n_exposures"] == 3 and summary["nsamp"] == 2
    assert [e["chunk"] for e in summary["exposures"]] == [0, 2]

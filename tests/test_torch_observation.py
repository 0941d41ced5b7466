"""Observation end to end on the CPU: the port's generate() against the JAX
package's, on a tiny visit with the noise off, and the port's batched
Scene against the JAX package's."""

import os

import numpy as np
import pytest
import torch

from wayne_tpu.config import config_from_dict as config_from_dict_j
from wayne_tpu.io.ima import read_ima as read_ima_j
from wayne_tpu.observation import Observation as Observation_j
from wayne_tpu_torch.config import config_from_dict
from wayne_tpu_torch.convert import numpy_leaves
from wayne_tpu_torch.io.ima import read_ima
from wayne_tpu_torch.observation import Observation

torch.set_num_threads(1)

TINY = {"grism": "G141", "subarray": 128, "NSAMP": 4, "SAMPSEQ": "SPARS10",
        "scan": True, "x_ref": 30.0, "y_ref": 40.0, "num_orbits": 1,
        "exposures_per_orbit": 5, "n_lambda": 64, "n_sub": 4,
        "planet_name": "WASP-43 b"}


DETERMINISTIC = {"preset": "all", "poisson": False, "read_noise": False,
                 "cosmic_rays": False, "bias_drift": False}


@pytest.mark.parametrize("noise", [{"preset": "none"}, DETERMINISTIC],
                         ids=["noise_off", "deterministic_effects"])
def test_generate_matches_jax(tmp_path, noise):
    params = dict(TINY, noise=noise)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    paths_j = Observation_j(config_from_dict_j(params)).generate(
        out_j, chunk=4, progress=lambda s: None)
    obs = Observation(config_from_dict(params), device="cpu")
    paths_t = obs.generate(out_t, chunk=4, progress=lambda s: None)

    names = sorted(os.listdir(out_j))
    assert names == sorted(os.listdir(out_t))
    assert "star_direct.fits" in names and len(names) == 6
    assert [os.path.basename(p) for p in paths_t] == \
        [os.path.basename(p) for p in paths_j]
    for name in names:
        hj, rj, tj, dqj = read_ima_j(os.path.join(out_j, name), with_dq=True)
        ht, rt, tt, dqt = read_ima(os.path.join(out_t, name), with_dq=True)
        # no key holds a path or the wall-clock time: all must agree
        assert hj == ht, name
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(dqt, dqj)     # hot pixels, saturation
        # noise off: rtol 2e-5 as tests/test_pallas.py,
        # with the absolute floor of test_torch_exposure's ideal_e — the
        # faint PSF wings are float32 erf differences the two frameworks
        # round differently (measured <= 1.8e-6 of the peak)
        np.testing.assert_allclose(rt, rj, rtol=2e-5,
                                   atol=max(1e-3, 5e-6 * float(rj.max())),
                                   err_msg=name)
    assert float(np.abs(rt[-1] - rt[0]).max()) > 1.0    # signal landed

    # resume: a second generate writes nothing
    assert obs.generate(out_t, chunk=4, progress=lambda s: None) == []


def test_build_scenes_matches_jax():
    """The default noise chain draws pointing jitter and SSV phases from
    the visit seed: the port's NumPy copy reproduces every leaf except
    the random keys (the port keys its own Philox streams)."""
    params = dict(TINY, seed=7, trends={"breathing_amp": 0.01,
                                        "sky_scatter": 0.02})
    sj = numpy_leaves(Observation_j(config_from_dict_j(params)).scenes)
    st = numpy_leaves(Observation(config_from_dict(params),
                                  device="cpu").scenes)
    sj.pop("key")
    seeds = st.pop("seed")
    assert seeds.shape == (5, 2) and len({tuple(s) for s in seeds}) == 5
    for k, v in sj.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                np.testing.assert_array_equal(st[k][kk], vv, err_msg=k + kk)
        elif v is None:
            assert st.get(k) is None, k
        else:
            np.testing.assert_array_equal(st[k], v, err_msg=k)


def test_unported_visit_features_raise(tmp_path):
    """The visit-level physics runs, and so does a YAML ``calibration:``
    block (once raising, naming ROADMAP item 7e): its sensitivity table
    replaces the synthetic curve."""
    Observation(config_from_dict(dict(TINY, persistence=True, recte=True)),
                device="cpu")
    sens = tmp_path / "sens.txt"
    np.savetxt(sens, np.stack([np.linspace(10000, 18000, 16),
                               np.full(16, 1.1e16)], axis=1))
    obs = Observation(config_from_dict(dict(
        TINY, calibration={"sensitivity_file": str(sens)})), device="cpu")
    np.testing.assert_allclose(obs.tables.sensitivity.numpy(), 1.1e16,
                               rtol=1e-6)


def test_run_visit_cli_on_cpu(tmp_path, capsys):
    """``python -m wayne_tpu_torch.run_visit --cpu`` drives the whole
    path (default noise chain, ADC quantization) on the CPU."""
    from wayne_tpu_torch.run_visit import main

    yml = tmp_path / "pars.yml"
    yml.write_text(
        "observation:\n  subarray: 64\n  NSAMP: 2\n  n_lambda: 16\n"
        "  x_ref: 20.0\n  y_ref: 20.0\n  num_orbits: 1\n"
        "  exposures_per_orbit: 3\n  quantize_adc: true\n")
    out = tmp_path / "out"
    assert main(["-p", str(yml), "-o", str(out), "--cpu", "--chunk", "2"]) == 0
    assert "wrote 3 exposures" in capsys.readouterr().out
    hdr, reads, _ = read_ima(str(out / "star_0002_ima.fits"))
    assert hdr["NSAMP"] == 3 and reads.shape == (3, 64, 64)
    assert np.array_equal(reads, np.round(reads))        # whole DN
    assert (out / "star_direct.fits").exists()


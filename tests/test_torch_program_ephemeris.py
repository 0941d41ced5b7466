"""The port's ``tools.program_ephemeris`` on the CPU against the JAX
package's ``tools/program_ephemeris.py`` on the same files: the JAX
package's drift program (``tests/test_program.py``: 128^2, 3 visits x 5
orbits x 30 exposures, the true ephemeris walked 120 s a visit), written
once by the port's ``run_program``.

Bars (measured on this program beside each): per-visit ``t0_offset_s``,
the fitted drift and the intercept atol 0.5 s (0.25 s: visit 0's white
fit constrains the depth to 0.03, so its free geometry sits in a shallow
valley); combined Rp/Rs within 0.05 sigma (0.018 sigma: the per-visit
fitted geometry carries into the channel depths); its sigma rtol 1e-3
(5e-5); the repeatability chi2 rtol 2e-2 + 2e-3 (7e-3); the flags and the
injected offsets exactly. The port's result is held to the JAX test's
drift criteria. Its repeatability criterion (chi2/dof < 6) is not: with
the port's bits, channel 1 of this program gives 6.48 and the JAX tool on
the same files 6.53 (ROADMAP C14). The file takes ~90 s on one core (the
program's simulation and six reductions with the free-geometry ramp fit).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from wayne_tpu_torch.run_program import main as run_program
from wayne_tpu_torch.tools.program_ephemeris import (
    main as ephemeris_main, measure_program_ephemeris,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 56000.0
PARAMS = {"grism": "G141", "subarray": 128, "NSAMP": 4, "SAMPSEQ": "SPARS10",
          "scan": True, "scan_speed": 2.0, "x_ref": 30.0, "y_ref": 40.0,
          "num_orbits": 5, "exposures_per_orbit": 30,
          "exposure_overhead_s": 60.0, "mag_J": 9.5, "n_lambda": 48,
          "n_sub": 2, "start_mjd": T0 - 9700.0 / 86400.0, "t0": T0,
          "period": 0.813475, "sma_over_rs": 4.855, "inclination": 82.1,
          "rp_over_rs": 0.1595, "seed": 11,
          "noise": {"read_noise": True, "sky": True, "dark": True},
          "program": {"num_visits": 3, "visit_spacing_days": 0.0,
                      "carry_persistence": False,
                      "t0_drift_s_per_visit": 120.0}}


def _mirror(src, dst):
    """A directory of links to ``src``'s program (the summary and every
    visit's files), so a second reduction writes its own outputs."""
    os.makedirs(dst)
    os.symlink(os.path.join(src, "program_summary.json"),
               os.path.join(dst, "program_summary.json"))
    for v in sorted(os.listdir(src)):
        if v.startswith("visit_"):
            os.makedirs(os.path.join(dst, v))
            for f in os.listdir(os.path.join(src, v)):
                os.symlink(os.path.join(src, v, f), os.path.join(dst, v, f))


@pytest.fixture(scope="module")
def ephemerides(tmp_path_factory):
    """(the port's result, the JAX tool's result, the program dir, the
    YAML): the program written once by the port, reduced by each tool in
    its own directory."""
    d = tmp_path_factory.mktemp("ephemeris")
    yml = d / "prog.yml"
    yml.write_text(yaml.safe_dump(PARAMS))
    assert run_program(["-p", str(yml), "-o", str(d / "prog"), "--cpu",
                        "--chunk", "8"]) == 0
    _mirror(str(d / "prog"), str(d / "prog_jax"))
    port = measure_program_ephemeris(str(d / "prog"), str(yml), n_chan=4,
                                     cpu=True)
    sys.path.insert(0, REPO)
    from tools.program_ephemeris import (
        measure_program_ephemeris as measure_jax)
    ref = measure_jax(str(d / "prog_jax"), str(yml), n_chan=4, cpu=True)
    return port, ref, d / "prog", yml


def test_ephemeris_matches_the_jax_tool_on_the_same_files(ephemerides):
    """Same keys; the per-visit t0 offsets, the drift, the combined
    spectrum and its repeatability at the bars above."""
    port, ref, _, _ = ephemerides
    assert set(port) == set(ref)
    assert port["per_visit_injected_offset_s"] == \
        ref["per_visit_injected_offset_s"]
    assert port["drift_s_per_visit_injected"] == \
        ref["drift_s_per_visit_injected"]
    for key in ("per_visit_t0_offset_s", "drift_s_per_visit_fitted",
                "t0_intercept_s"):
        got, want = np.asarray(port[key]), np.asarray(ref[key])
        np.testing.assert_allclose(got, want, rtol=0, atol=0.5, err_msg=key)
    assert len(port["combined_spectrum"]) == len(ref["combined_spectrum"])
    for p, r in zip(port["combined_spectrum"], ref["combined_spectrum"]):
        assert set(p) == set(r)
        assert (p["wl_lo_um"], p["wl_hi_um"], p["constrained"]) == \
            (r["wl_lo_um"], r["wl_hi_um"], r["constrained"])
        assert abs(p["rp_over_rs"] - r["rp_over_rs"]) <= (
            0.05 * r["rp_sigma"]), (p, r)
        assert abs(p["rp_sigma"] - r["rp_sigma"]) <= (
            1e-3 * r["rp_sigma"] + 2e-7), (p, r)
        assert abs(p["repeatability_chi2_per_dof"]
                   - r["repeatability_chi2_per_dof"]) <= (
            2e-2 * r["repeatability_chi2_per_dof"] + 2e-3), (p, r)


def test_ephemeris_recovers_the_drift(ephemerides):
    """The JAX test's criteria (``tests/test_program.py``) on the port's
    result: the fitted offsets track the injected 0/120/240 s walk, the
    drift within 45 s/visit of 120, the combined depths within max(5
    sigma, 0.005) of 0.1595."""
    port, _, prog, _ = ephemerides
    fitted = np.array(port["per_visit_t0_offset_s"])
    injected = np.array(port["per_visit_injected_offset_s"])
    np.testing.assert_allclose(injected, [0.0, 120.0, 240.0], atol=0.5)
    assert np.all(np.abs(fitted - injected) < 60.0), (fitted, injected)
    assert abs(port["drift_s_per_visit_fitted"] - 120.0) < 45.0, port
    comb = port["combined_spectrum"]
    rp_c = np.array([c["rp_over_rs"] for c in comb])
    sig_c = np.array([c["rp_sigma"] for c in comb])
    assert np.all(np.abs(rp_c - 0.1595) < np.maximum(5 * sig_c, 0.005)), (
        rp_c, sig_c)
    with open(prog / "ephemeris.json") as fh:
        assert json.load(fh) == port


def test_cli_raises_without_a_card(ephemerides):
    """Without ``--cpu`` the reductions run on the card: here they raise."""
    _, _, prog, yml = ephemerides
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ephemeris_main(["-d", str(prog), "-p", str(yml)])

"""The visit-level slice as a whole on the CPU: ``Observation.simulate()``
of the full-systematics, eclipse and phase-curve example visits, shrunk
(S = 128, NSAMP = 3, one orbit, 6 exposures), the port against the JAX
package with the stochastic effects off.

Held at the noise-off bar of tests/test_torch_observation.py: rtol 2e-5
with an absolute floor of max(1e-3, 5e-6 of the peak) on ideal_e and
reads_dn (float32 erf wings the two frameworks round differently).
Unstable (RTS) pixels and the random-walk SSV draw from each package's own
random stream, so the full-systematics visit runs here without them
(tests/test_torch_exposure_physics.py holds RTS to its law). It also runs
without focus breathing: with the PSF widths scaled, four pixels in the
companion's far wings round to +-0.07 e- of noise in each package (a gap
of 6.9e-6 of the peak, measured, above the bar);
tests/test_torch_exposure_physics.py holds a scaled PSF with a companion
at 64 px.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from wayne_tpu.config import config_from_dict as config_from_dict_j
from wayne_tpu.observation import Observation as Observation_j
from wayne_tpu_torch.config import config_from_dict
from wayne_tpu_torch.convert import numpy_leaves
from wayne_tpu_torch.observation import Observation

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
SMALL = {"subarray": 128, "NSAMP": 3, "num_orbits": 1,
         "exposures_per_orbit": 6, "n_lambda": 64, "x_ref": 30.0,
         "y_ref": 30.0, "compute_ideal": True}
STOCHASTIC_OFF = {"poisson": False, "read_noise": False,
                  "cosmic_rays": False, "bias_drift": False}


def _params(name: str, **observation) -> dict:
    with open(os.path.join(EXAMPLES, name)) as fh:
        params = yaml.safe_load(fh)
    params["observation"].update(SMALL, **observation)
    params.setdefault("noise", {}).update(STOCHASTIC_OFF)
    return params


def _full_systematics() -> dict:
    params = _params("wasp43b_full_systematics.yml", unstable_pixel_frac=0.0)
    params["trends"].update(ssv_rw_amplitude=0.0, breathing_amp=0.0)
    return params


# secondary eclipse of the YAML's ephemeris (t0 56000.0, P 0.813475 d) at
# MJD 56000.4067: the eclipse visit's six short exposures fall in ingress,
# the phase curve's before it (planet light visible)
CASES = {
    "full_systematics": _full_systematics,
    "eclipse": lambda: _params("wasp43b_g141_eclipse.yml",
                               start_mjd=56000.38),
    "phase_curve": lambda: _params("wasp43b_g141_phase_curve.yml",
                                   start_mjd=56000.30),
}


def _both(params):
    obs_j = Observation_j(config_from_dict_j(params))
    obs_t = Observation(config_from_dict(params), device="cpu")
    return obs_j, obs_t


def _assert_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=max(1e-3, 5e-6 * float(want.max())),
                               err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_matches_jax(case):
    obs_j, obs_t = _both(CASES[case]())
    ref = obs_j.simulate(chunk=4)
    got = obs_t.simulate(chunk=4)
    assert got.reads_dn.shape == (6, 4, 128, 128)
    for name in ("ideal_e", "reads_dn"):
        _assert_close(getattr(got, name).numpy(),
                      np.asarray(getattr(ref, name)), name)
    assert float(got.ideal_e.max()) > 1e3                 # signal landed
    if case == "full_systematics":
        # the charge-memory maps the simulation ran on
        _assert_close(obs_t.scenes.persist_rate.numpy(),
                      np.asarray(obs_j.scenes.persist_rate), "persist_rate")
        _assert_close(obs_t.scenes.trap_mult.numpy(),
                      np.asarray(obs_j.scenes.trap_mult), "trap_mult")
        assert float(obs_t.scenes.trap_mult.min()) < 1.0
        assert float(obs_t.scenes.persist_rate.max()) > 0.0


def test_eclipse_visit_sees_the_planet_hide():
    """The eclipse visit over the same visit without planet light: the
    planet's 5e-4 of light falls exposure by exposure through ingress."""
    params = CASES["eclipse"]()
    dark = dict(params, planet=dict(params["planet"], eclipse_depth=0.0))
    white = [Observation(config_from_dict(p), device="cpu").simulate(
        chunk=4).ideal_e.sum(dim=(1, 2)).double() for p in (params, dark)]
    ratio = (white[0] / white[1] - 1.0).numpy()
    assert ratio[0] > 4e-4 and ratio[-1] < 3.5e-4, ratio
    assert (np.diff(ratio) < 0).all(), ratio


def test_visit_scene_leaves_match_jax():
    """Spots and companions (with the reverse-scan flux offset applied to
    the companion as to the target) are the JAX package's leaves."""
    obs_j, obs_t = _both(_full_systematics())
    sj, st = numpy_leaves(obs_j.scenes), numpy_leaves(obs_t.scenes)
    for group in ("spots", "companions"):
        assert sj[group].keys() == st[group].keys()
        for k, v in sj[group].items():
            np.testing.assert_array_equal(st[group][k], v, err_msg=group + k)
    flux = st["companions"]["flux"]
    assert flux.shape == (6, 1, 64) and not np.array_equal(flux[0], flux[1])


TINY = {"subarray": 64, "NSAMP": 2, "n_lambda": 16, "x_ref": 20.0,
        "y_ref": 20.0, "num_orbits": 1, "exposures_per_orbit": 2}
SPOT = {"lon_deg": 0.0, "lat_deg": 10.0, "radius": 0.1, "temp_k": 3800.0}
COMP = {"dx_px": 5.0, "dy_px": 3.0, "mag_j": 12.0}


@pytest.mark.parametrize("params,match", [
    ({"target": {"spots": [dict(SPOT, lat_deg=100.0)]}}, "lat_deg"),
    ({"target": {"spots": [dict(SPOT, radius=1.5)]}}, "radius"),
    ({"target": {"spots": [{"lon_deg": 0.0, "lat_deg": 0.0,
                            "radius": 0.1}]}}, "temp_k or contrast"),
    ({"target": {"spots": [dict(SPOT, colour=1)]}}, "unknown spot keys"),
    ({"target": {"spots": [dict(SPOT, contrast=2.0)]}}, "contrast"),
    ({"companions": [{"dy_px": 3.0, "mag_j": 12.0}]}, "missing key"),
    ({"companions": [dict(COMP, flux_scale=0.1)]}, "exactly one"),
    ({"companions": [{"dx_px": 5.0, "dy_px": 3.0, "flux_scale": -0.1}]},
     "positive"),
    ({"companions": [dict(COMP, spin=2)]}, "unknown companion keys"),
], ids=["lat", "radius", "no_contrast", "spot_key", "spot_contrast",
        "no_dx", "two_brightnesses", "negative_scale", "companion_key"])
def test_bad_spot_and_companion_entries_raise(params, match):
    """The YAML checks of the JAX package's _build_spots and
    _build_companions, with their messages."""
    with pytest.raises(ValueError, match=match):
        Observation(config_from_dict(dict(TINY, **params)), device="cpu")
    with pytest.raises(ValueError, match=match):
        Observation_j(config_from_dict_j(dict(TINY, **params)))

"""The port's public surface against the JAX package's, on the CPU: every
name each JAX subpackage ``__init__`` exports imports from the port's
counterpart; the four functions added to close the surface (``ierf``,
``pixel_fractions_moving_path``, ``ssv_factor``, ``native_available``) on
the same numpy inputs; the JAX signatures of ``visit_persistence_rates``
and ``visit_trap_maps`` in both forms (the fluence stack given, and
computed by the call); ``synthetic_tables(dtype=...)``.

Float32 bars are stated in each test with the difference measured here."""

import dataclasses
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu import calibration as cal_j
from wayne_tpu import trends as trends_j
from wayne_tpu.config import PersistenceConfig as PersistenceConfig_j
from wayne_tpu.config import RecteConfig as RecteConfig_j
from wayne_tpu.config import config_from_dict as config_from_dict_j
from wayne_tpu.io import native as native_j
from wayne_tpu.observation import Observation as Observation_j
from wayne_tpu.ops import persistence as pers_j
from wayne_tpu.ops import psf as psf_j
from wayne_tpu.ops import recte as recte_j
from wayne_tpu_torch import calibration as cal_t
from wayne_tpu_torch import trends as trends_t
from wayne_tpu_torch.config import (
    ExposureStatic, NoiseFlags, PersistenceConfig, RecteConfig,
)
from wayne_tpu_torch.convert import (
    numpy_leaves, scenes_from_numpy, tables_from_numpy,
)
from wayne_tpu_torch.io import native as native_t
from wayne_tpu_torch.ops import persistence as pers_t
from wayne_tpu_torch.ops import psf as psf_t
from wayne_tpu_torch.ops import recte as recte_t

torch.set_num_threads(1)

SUBPACKAGES = ("io", "models", "ops", "parallel", "utils")


def _exported(module) -> list[str]:
    """The names a package's ``__init__`` binds, its submodules aside."""
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_") and not inspect.ismodule(v))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    """``from wayne_tpu_torch.<sub> import <name>`` works for every name
    ``wayne_tpu.<sub>`` exports: the port's own function or class, or the
    same constant."""
    want = _exported(importlib.import_module(f"wayne_tpu.{sub}"))
    port = importlib.import_module(f"wayne_tpu_torch.{sub}")
    assert len(want) >= 4
    missing = [n for n in want if not hasattr(port, n)]
    assert missing == []
    jax_sub = importlib.import_module(f"wayne_tpu.{sub}")
    for n in want:
        obj = getattr(port, n)
        if callable(obj):
            assert obj.__module__.startswith("wayne_tpu_torch."), n
        else:
            assert obj == getattr(jax_sub, n), n


def test_ierf_matches_jax():
    """F(x) = x erf(x) + exp(-x^2)/sqrt(pi) on 4001 points over [-8, 8]:
    rtol 2e-6, atol 1e-6 (measured 2.4e-7 relative)."""
    x = np.random.RandomState(0).uniform(-8.0, 8.0, 4001).astype(np.float32)
    got = psf_t.ierf(torch.as_tensor(x)).numpy()
    want = np.asarray(psf_j.ierf(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def _path_average_f64(edges, centers, sigma) -> np.ndarray:
    """The exact per-segment fractions in float64: the antiderivative
    difference on every segment (no cancellation at these spacings)."""
    e, c, s = (torch.as_tensor(a, dtype=torch.float64)
               for a in (edges, centers, sigma))
    u = (e[None] - c[..., None]) / (s[..., None] * np.sqrt(2.0))
    F = u * torch.special.erf(u) + torch.exp(-u * u) / np.sqrt(np.pi)
    m = (F[:-1] - F[1:]) / (u[:-1] - u[1:])
    return (0.5 * (m[..., 1:] - m[..., :-1])).numpy()


@pytest.mark.parametrize("speed", [0.02, 0.3, 3.0])
def test_pixel_fractions_moving_path_matches_jax(speed):
    """K = 5 segments of a 65-edge column under 32 wavelength bins, at node
    spacings that take the trapezoid branch (0.02 px), both sides of the
    branch point (0.3) and the exact branch (3 px). Against JAX: atol 1e-5
    on fractions of a unit Gaussian (measured 1.5e-7, 5.4e-6, 6.0e-7; at
    0.3 px both packages carry the float32 cancellation of the exact branch
    near |du| = 0.15, ~1e-5 by the JAX docstring). Against the float64
    path average the port is no farther than JAX (both 1.25e-5 at 0.3)."""
    rng = np.random.RandomState(1)
    edges = np.arange(65, dtype=np.float32) - 0.5
    sigma = rng.uniform(0.7, 1.6, 32).astype(np.float32)
    c0 = rng.uniform(20.0, 40.0, 32).astype(np.float32)
    centers = (c0[None] + speed * np.arange(6, dtype=np.float32)[:, None]
               ).astype(np.float32)
    got = psf_t.pixel_fractions_moving_path(
        torch.as_tensor(edges), torch.as_tensor(centers),
        torch.as_tensor(sigma)).numpy()
    want = np.asarray(psf_j.pixel_fractions_moving_path(
        jnp.asarray(edges), jnp.asarray(centers), jnp.asarray(sigma)))
    assert got.shape == want.shape == (5, 32, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    exact = _path_average_f64(edges, centers, sigma)
    assert np.abs(got - exact).max() <= 1.01 * np.abs(want - exact).max() \
        + 1e-7


def test_ssv_factor_matches_jax():
    """The SSV multiplier at 2001 times within a 103 s exposure, default
    and non-default parameters: rtol 1e-6 (measured 1.2e-7)."""
    t = np.linspace(0.0, 103.0, 2001).astype(np.float32)
    for kw in ({}, dict(ssv_amp=0.04, ssv_period_s=1.3, ssv_phase=0.7)):
        got = trends_t.ssv_factor(torch.as_tensor(t),
                                  trends_t.TrendParams.create(**kw)).numpy()
        want = np.asarray(trends_j.ssv_factor(
            jnp.asarray(t), trends_j.TrendParams.create(**kw)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # batched parameters (B,) against times (B, T), as the port batches
    p = trends_t.TrendParams.create(ssv_amp=[0.01, 0.03])
    got = trends_t.ssv_factor(torch.as_tensor(np.stack([t, t])), p).numpy()
    for b, amp in enumerate((0.01, 0.03)):
        want = np.asarray(trends_j.ssv_factor(
            jnp.asarray(t), trends_j.TrendParams.create(ssv_amp=amp)))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=0)


def test_native_available_matches_jax(monkeypatch):
    """Both packages' native writers build here (g++): True in both; a
    library that cannot be built or loaded is False, not an exception."""
    assert native_t.native_available() is True
    assert native_t.native_available() == native_j.native_available()

    def broken():
        raise native_t.NativeWriterError("g++ not found")

    monkeypatch.setattr(native_t, "get_lib", broken)
    assert native_t.native_available() is False


# the 64^2 visit of tests/test_torch_visit_physics.py, every deterministic
# effect on
VISIT = {"grism": "G141", "subarray": 64, "NSAMP": 3, "SAMPSEQ": "SPARS10",
         "scan": True, "x_ref": 10.0, "y_ref": 12.0, "num_orbits": 1,
         "exposures_per_orbit": 5, "n_lambda": 32, "n_sub": 2, "seed": 3,
         "noise": {"preset": "all", "poisson": False, "read_noise": False,
                   "cosmic_rays": False, "bias_drift": False}}


@pytest.fixture(scope="module")
def visit():
    """The JAX package's visit, the port's copy of its inputs, and the
    JAX visit's fluence stack (one noise-free pass, chunks of 4)."""
    obs = Observation_j(config_from_dict_j(VISIT))
    kw = dataclasses.asdict(obs.static)
    kw["noise"] = NoiseFlags(**kw["noise"])
    from wayne_tpu.ops.visit import visit_fluence_stack

    stack = np.asarray(visit_fluence_stack(obs.scenes, obs.tables,
                                           obs.static, 4))
    return (obs, scenes_from_numpy(numpy_leaves(obs.scenes), "cpu"),
            tables_from_numpy(numpy_leaves(obs.tables), "cpu"),
            ExposureStatic(**kw), stack)


@pytest.mark.parametrize("form", ["stack_given", "stack_computed"])
def test_visit_charge_memory_maps_take_the_jax_signatures(visit, form):
    """``visit_persistence_rates(scenes, tables, cfg, pcfg, chunk, ...,
    fluence_stack=)`` and ``visit_trap_maps(scenes, tables, cfg, rcfg,
    chunk, fluence_stack=)``, called as JAX's, against JAX's: with the
    visit's stack given (the same array to both) and with None (each
    package makes its own, at the noise-off bar of
    tests/test_torch_visit_physics.py). The stimulus scale here is the
    sigmoid's knee (prior-fluence stimuli near full well): persistence
    rtol 1e-5, atol 2e-6 e-/s; the trap multiplier at the same bar; the
    release rtol 1e-5, atol 1e-3 e- over the exposure."""
    obs, scenes_t, tables_t, static_t, stack = visit
    stim = np.random.RandomState(4).uniform(0.0, 1.2e5, (64, 64)
                                            ).astype(np.float32)
    given = form == "stack_given"
    pj = PersistenceConfig_j(enabled=True)
    want = pers_j.visit_persistence_rates(
        obs.scenes, obs.tables, obs.static, pj, 4,
        extra_fluence=jnp.asarray(stim), extra_end_s=-300.0,
        fluence_stack=jnp.asarray(stack) if given else None)
    got = pers_t.visit_persistence_rates(
        scenes_t, tables_t, static_t, PersistenceConfig(enabled=True), 4,
        extra_fluence=torch.as_tensor(stim), extra_end_s=-300.0,
        fluence_stack=torch.as_tensor(stack) if given else None)
    assert got.shape == (5, 64, 64) and float(got.max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)
    rj = RecteConfig_j(enabled=True, f0_s=0.1)
    tm_j, rel_j = recte_j.visit_trap_maps(
        obs.scenes, obs.tables, obs.static, rj, 4,
        fluence_stack=jnp.asarray(stack) if given else None)
    tm_t, rel_t = recte_t.visit_trap_maps(
        scenes_t, tables_t, static_t, RecteConfig(enabled=True, f0_s=0.1),
        4, fluence_stack=torch.as_tensor(stack) if given else None)
    assert float(tm_t.min()) < 1.0
    np.testing.assert_allclose(tm_t.numpy(), np.asarray(tm_j), rtol=1e-5,
                               atol=2e-6)
    exptime = float(tables_t.read_times[-1])
    np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j), rtol=1e-5,
                               atol=1e-3 / exptime)


@pytest.mark.parametrize("dtype", ["default", "float32", "float64"])
def test_synthetic_tables_dtype_matches_jax(dtype):
    """``synthetic_tables(..., dtype=...)`` as JAX's: every leaf equal, of
    the asked dtype (float64 under JAX's x64 mode); NumPy dtypes are
    accepted as JAX accepts them."""
    kw = dict(subarray=64, n_lambda=16, nsamp=3, samp_seq="SPARS10",
              rts_frac=0.01)
    if dtype == "default":
        want, got = cal_j.synthetic_tables("G141", **kw), \
            cal_t.synthetic_tables("G141", **kw)
        expect = torch.float32
    elif dtype == "float32":
        want = cal_j.synthetic_tables("G141", dtype=jnp.float32, **kw)
        got = cal_t.synthetic_tables("G141", dtype=np.float32, **kw)
        expect = torch.float32
    else:
        with jax.enable_x64(True):
            want = cal_j.synthetic_tables("G141", dtype=jnp.float64, **kw)
            want = {k: None if v is None else np.asarray(v)
                    for k, v in numpy_leaves(want).items()}
        got = cal_t.synthetic_tables("G141", dtype=torch.float64, **kw)
        expect = torch.float64
    want = want if isinstance(want, dict) else numpy_leaves(want)
    got_leaves = numpy_leaves(got)
    assert got_leaves.keys() == want.keys()
    for k, v in got_leaves.items():
        if v is None:
            assert want[k] is None, k
            continue
        assert getattr(got, k).dtype == expect, k
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    with pytest.raises(TypeError):     # the keywords stay keyword-only
        cal_t.synthetic_tables("G141", 64, 16, "SPARS10", 3, 1234)

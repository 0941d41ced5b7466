"""The Levenberg-Marquardt core of the port's white fits
(``reduction._lm_minimize``): one step (``_lm_step``) run eagerly, or, on a
card, replayed from a CUDA graph captured once per call.

On the CPU every step runs eagerly and leaves an ``lm.step`` span; looping
``_lm_step`` by hand gives ``_lm_minimize``'s bits; the graph path is taken
only for a tensor on a card, outside ``vmap``, not requiring grad, on a
stream that is not capturing. On the card (marker ``cuda``) every fit that
runs the LM gives the hand loop's bits, back-to-back calls included, and
neither the capture nor a replay syncs with the host.

This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_lm_graph.py --noconftest -m cuda -q
"""

import math

import numpy as np
import pytest
import torch

from wayne_tpu_torch import reduction as red
from wayne_tpu_torch.ops.kepler import OrbitParams, projected_separation
from wayne_tpu_torch.ops.transit import transit_depth_curve
from wayne_tpu_torch.utils.profiling import tracing

torch.set_num_threads(1)

ORBIT_S = 95.47 * 60.0                  # HST orbital period
ORBIT = dict(period_s=0.813475 * 86400.0, t0_s=9700.0, sma_rs=4.855,
             inc_rad=math.radians(82.1))
LD = torch.tensor([0.65, -0.25, 0.45, -0.2])
RP = 0.1595


def _visit(seed):
    """A four-orbit visit's white curve: transit x the hook trend (doubled
    in orbit 1) x a slope, plus 1e-4 noise; (t, orbit, white)."""
    k, i = np.meshgrid(np.arange(4), np.arange(11), indexing="ij")
    t_orb = (60.0 + 250.0 * i).ravel()
    t = (k.ravel() * ORBIT_S + t_orb).astype(np.float32)
    trend = ((1.0 - 0.01 / 86400.0 * (t - t[0]))
             * (1.0 - 0.003 * np.where(k.ravel() == 0, 2.0, 1.0)
                * np.exp(-t_orb / 300.0)))
    orbit = OrbitParams.create(**ORBIT)
    tt = torch.from_numpy(t)
    z, front = projected_separation(tt, orbit)
    f = transit_depth_curve(z, torch.tensor(RP), LD, 32)
    sig = (1.0 - (1.0 - f) * front).numpy()
    noise = 1e-4 * np.random.default_rng(seed).standard_normal(t.size)
    white = torch.from_numpy((sig * trend * (1.0 + noise)).astype(np.float32))
    return tt, orbit, white


def _hand_loop(resid, theta0, n_steps, lam0=1e-3):
    """``_lm_minimize`` with every step run eagerly: ``_lm_step`` looped
    by hand from the same start."""
    eye = torch.eye(theta0.shape[0], dtype=torch.float32,
                    device=theta0.device)
    theta, chi2 = theta0, torch.sum(resid(theta0) ** 2)
    lam = torch.tensor(lam0, dtype=torch.float32, device=theta0.device)
    for _ in range(n_steps):
        theta, chi2, lam = red._lm_step(resid, theta, chi2, lam, eye)
    return theta, chi2


def _ramp_resid(seed=1, device="cpu"):
    """The white ramp fit's residual function on a visit, and its start."""
    t, orbit, white = _visit(seed)
    t_orb, first = red.orbit_phase(t)
    t_day = (t - t.mean()) / 86400.0
    z, front = projected_separation(t, orbit)
    to = lambda x: x.to(device)
    args = [to(x) for x in (t_day, t_orb, first.to(torch.float32), z,
                            front)] + [to(LD), 32]
    lc = to(white)

    def resid(theta):
        return red.ramp_transit_model(theta, *args)[0] - lc

    theta0 = torch.tensor([1.0, 0.15, 0.0, 2e-3, 4e-3, math.log(250.0)],
                          device=device)
    return resid, theta0


def _exp_resid(seed=2, device="cpu"):
    """A decaying exponential plus a line: a residual with no transit."""
    g = torch.Generator().manual_seed(seed)
    x = torch.linspace(0.0, 4.0, 50)
    y = 2.0 * torch.exp(-0.7 * x) + 0.1 * x + 0.01 * torch.randn(
        50, generator=g)
    x, y = x.to(device), y.to(device)

    def resid(theta):
        return theta[0] * torch.exp(-theta[1] * x) + theta[2] * x - y

    return resid, torch.tensor([1.0, 0.3, 0.0], device=device)


RESIDS = {"ramp": _ramp_resid, "exp": _exp_resid}


def _names(handle):
    return [s.name for s in handle.spans]


@pytest.mark.parametrize("resid", sorted(RESIDS))
@pytest.mark.parametrize("n_steps", [1, 2, 60])
def test_the_hand_loop_of_lm_step_is_lm_minimize_bit_for_bit(resid,
                                                              n_steps):
    fn, theta0 = RESIDS[resid]()
    theta, chi2 = red._lm_minimize(fn, theta0, n_steps)
    theta_h, chi2_h = _hand_loop(fn, theta0, n_steps)
    assert torch.equal(theta, theta_h) and torch.equal(chi2, chi2_h)
    # the fit moved: a step that changed nothing would match trivially
    assert chi2 < torch.sum(fn(theta0) ** 2)


@pytest.mark.parametrize("kw, steps", [
    (dict(), 60),
    (dict(clip_sigma=3.0, clip_rounds=2), 3 * 60),
    # the 13 geometry seeds run in one vmap: one span a step for all
    (dict(fit_geometry=True), 60 + 25 + 60),
])
def test_on_the_cpu_every_step_runs_eagerly(kw, steps):
    t, orbit, white = _visit(3)
    with tracing() as handle:
        red.fit_white_ramp(white, t, orbit, LD, 0.15, **kw)
    names = _names(handle)
    assert names.count("lm.step") == steps
    assert "lm.replay" not in names and "lm.capture" not in names


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card, for the rule alone."""

    @property
    def is_cuda(self):
        return True


def _on_card(x, requires_grad=False):
    return torch.Tensor._make_subclass(_OnCard, x, requires_grad)


@pytest.mark.parametrize("case, replays", [
    ("on_card", True), ("cpu", False), ("requires_grad", False),
    ("vmap", False), ("capturing", False),
])
def test_the_graph_path_is_taken_only_where_it_may_be(monkeypatch, case,
                                                      replays):
    capturing = case == "capturing"
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    theta = torch.zeros(6)
    if case == "cpu":
        assert red._replayable(theta) is replays
    elif case == "vmap":
        seen = []

        def look(th):
            seen.append(red._replayable(_on_card(th)))
            return th * 2.0

        torch.func.vmap(look)(torch.zeros(3, 6))
        assert seen == [replays]
    else:
        assert red._replayable(
            _on_card(theta, case == "requires_grad")) is replays


@pytest.mark.parametrize("n_steps", [1, 2, 5])
def test_lm_minimize_replays_every_step_after_the_first(monkeypatch,
                                                        n_steps):
    """Where the rule holds, one eager step and ``n_steps - 1`` replays
    from its state; a lone step takes no graph."""
    fn, theta0 = _exp_resid()
    calls = []

    def replay(resid, state, eye, n_replays):
        calls.append(n_replays)
        theta, chi2, lam = state
        for _ in range(n_replays):
            theta, chi2, lam = red._lm_step(resid, theta, chi2, lam, eye)
        return theta, chi2, lam

    monkeypatch.setattr(red, "_replayable", lambda th: True)
    monkeypatch.setattr(red, "_lm_replay", replay)
    with tracing() as handle:
        theta, chi2 = red._lm_minimize(fn, theta0, n_steps)
    assert calls == ([n_steps - 1] if n_steps >= 2 else [])
    assert _names(handle) == ["lm.step"] * (1 if n_steps >= 2 else n_steps)
    theta_h, chi2_h = _hand_loop(fn, theta0, n_steps)
    assert torch.equal(theta, theta_h) and torch.equal(chi2, chi2_h)


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_lm_graph.py --noconftest -m cuda)")
    return torch.device("cuda")


def _tensors(out):
    """Every tensor of a fit's result, in a fixed order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _tensors(o)]
    if hasattr(out, "__dataclass_fields__"):
        return [x for f in out.__dataclass_fields__
                for x in _tensors(getattr(out, f))]
    return []


def _equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) > 0
    return all(x.shape == y.shape and bool(
        torch.eq(x, y).logical_or(x.isnan() & y.isnan()).all())
        for x, y in zip(ta, tb))


def _fit(mode, dev, seed=3):
    t, orbit, white = _visit(seed)
    args = (white.to(dev), t.to(dev), OrbitParams.create(**ORBIT, device=dev),
            LD.to(dev), 0.15)
    if mode == "recte":
        return red.fit_white_recte(*args, rate_e_s=300.0, exptime_s=100.0,
                                   n_iter=80)
    kw = {"default": {}, "clip": dict(clip_sigma=3.0, clip_rounds=2),
          "geometry": dict(fit_geometry=True), "eclipse": dict(eclipse=True),
          }[mode]
    return red.fit_white_ramp(*args, **kw)


# (captures, replays) per fit: each _lm_minimize call on a card captures
# once and replays all its steps but the first; the geometry seeds'
# vmapped call does neither
GRAPHS = {"default": (1, 59), "clip": (3, 3 * 59), "geometry": (2, 2 * 59),
          "eclipse": (1, 59), "recte": (1, 79)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(GRAPHS))
def test_graph_fits_match_the_hand_loop_bit_for_bit(card, monkeypatch, mode):
    with tracing() as handle:
        graph = _fit(mode, card)
        torch.cuda.synchronize()
    names = _names(handle)
    assert (names.count("lm.capture"), names.count("lm.replay")) == GRAPHS[
        mode]
    for s in handle.spans:
        if s.name in ("lm.capture", "lm.replay"):
            assert s.host_syncs == 0, s.name
    monkeypatch.setattr(red, "_lm_minimize", _hand_loop)
    eager = _fit(mode, card)
    assert _equal(graph, eager), mode


@pytest.mark.cuda
def test_back_to_back_fits_each_match_their_eager_result(card, monkeypatch):
    """Five fits of five curves with no sync between them: each capture
    reuses the pool of the one before while its replays may be queued."""
    graph = [_fit("default", card, seed) for seed in range(10, 15)]
    monkeypatch.setattr(red, "_lm_minimize", _hand_loop)
    eager = [_fit("default", card, seed) for seed in range(10, 15)]
    for g, e in zip(graph, eager):
        assert _equal(g, e)
    assert not _equal(graph[0], graph[1])


@pytest.mark.cuda
def test_the_rule_on_the_card(card):
    theta = torch.zeros(6, device=card)
    assert red._replayable(theta)
    assert not red._replayable(theta.clone().requires_grad_())
    seen = []

    def look(th):
        seen.append(red._replayable(th))
        return th * 2.0

    torch.func.vmap(look)(torch.zeros(3, 6, device=card))
    assert seen == [False]
    side, graph = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        theta.add_(1.0)
        seen.append(red._replayable(theta))
        graph.capture_end()
    assert seen == [False, False]

"""The RECTE white ramp's kernel path (``ops.recte.white_ramp`` at a scalar
rate: ``_WhiteRamp`` over ``csrc/recte_ramp.cu``, its plain version
``white_ramp_plain`` on the CPU) against the trap loop ``_trap_scan`` it
replaces in the white fit.

On the CPU: the plain version's ramp is the loop's bit for bit, and its
tangent is ``torch.func.jacfwd`` of the loop's bit for bit, in float32 and
float64; the Function gives the same derivatives under ``jacfwd``,
``jvp``, ``vmap`` and ``torch.autograd.grad``, one value pass and one
tangent pass an evaluation under ``jacfwd``; a derivative with respect to
the start times raises; a rate per exposure still takes the loop. On the
card (marker ``cuda``): the kernel is the plain version bit for bit, in
value and tangent, at the fitted visit's 86 exposures and over several
rows; ``white_ramp`` and its Jacobian are the loop's bit for bit; inside a
CUDA graph's capture and its replays it syncs with nothing and gives the
same bits; ``white_ramp.launches`` counts its launches; and
``fit_white_recte`` is the loop's fit bit for bit and lies within the
float64 reference's limits of ``tests/test_torch_recte_reference.py``.
This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_recte_kernel.py --noconftest -m cuda -q
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from wayne_tpu_torch import reduction as red
from wayne_tpu_torch.ops import recte
from wayne_tpu_torch.ops.kepler import OrbitParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import fits as ref  # noqa: E402
from benchmark.reference import recte as rec  # noqa: E402

torch.set_num_threads(1)

P = recte.RecteParams()
MIDTIMES = os.path.join(ROOT, "benchmark", "configs",
                        "wasp43b-g141-fullsys.midtimes.json")


def _starts(rng, n, exptime):
    """Exposure starts: short gaps within an orbit, a few long ones, and
    now and then two exposures closer than the exposure time."""
    gaps = np.where(rng.random(n) < 0.1, rng.uniform(1e3, 3e3, n),
                    rng.uniform(-5.0, 60.0, n))
    return torch.from_numpy((np.cumsum(gaps + exptime)
                             + rng.uniform(0.0, 5e4)).astype(np.float32))


def _draw(seed):
    """(starts (N,), exptime, rate in 30-400 e-/s, fills in 0.02-0.6)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 120))
    exptime = float(rng.uniform(10.0, 300.0))
    rate = float(np.exp(rng.uniform(math.log(30.0), math.log(400.0))))
    f0_s, f0_f = (float(f) for f in rng.uniform(0.02, 0.6, 2))
    return _starts(rng, n, exptime), exptime, rate, f0_s, f0_f


def _loop(rate, f0_s, f0_f, starts, exptime, dtype=torch.float32):
    """The ramp by the loop, as ``white_ramp`` computed it before the
    kernel: the scalar rate expanded over the exposures."""
    t = starts.to(dtype)
    f = torch.as_tensor(rate).to(dtype).expand(t.shape)[:, None]
    gaps = recte._exposure_gaps(t, exptime, dtype)[:, None]
    one = lambda v: torch.as_tensor(v).to(dtype).reshape(1)
    _, _, deficit = recte._trap_scan(P, exptime, one(f0_s) * P.n_trap_s,
                                     one(f0_f) * P.n_trap_f, f, gaps)
    return (1.0 - deficit / torch.clamp_min(f * exptime, 1e-20))[:, 0]


def _inputs(theta, rate0):
    """(rate, f0_s, f0_f) from the fit's parametrisation theta = (log rate
    scale, logit f0_s, logit f0_f), the rate as the fit makes it (a tensor
    times the exponential: a Python float there would give forward mode a
    float64 tangent)."""
    rate0 = torch.as_tensor(rate0, dtype=theta.dtype, device=theta.device)
    return (rate0 * torch.exp(theta[0]), torch.sigmoid(theta[1]),
            torch.sigmoid(theta[2]))


def _recording(monkeypatch, calls):
    """Record (rows' shape, whether tangents came) of every value or
    tangent pass."""
    value = recte._white_ramp_value

    def recorded(starts, rate, f0_s, f0_f, exptime_s, params, tangents=None):
        calls.append((tuple(starts.shape), tangents is not None))
        return value(starts, rate, f0_s, f0_f, exptime_s, params, tangents)

    monkeypatch.setattr(recte, "_white_ramp_value", recorded)


def _theta(rate, f0_s, f0_f, rate0, dtype):
    return torch.tensor([math.log(rate / rate0), math.log(f0_s / (1 - f0_s)),
                         math.log(f0_f / (1 - f0_f))], dtype=dtype)


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("seed", range(10))
def test_plain_ramp_is_the_loop_bit_for_bit(seed):
    starts, exptime, rate, f0_s, f0_f = _draw(seed)
    rows = [(rate, f0_s, f0_f), (rate * 0.5, f0_f, f0_s), (2.0 * rate, 0.3,
                                                           0.05)]
    col = lambda i: torch.tensor([r[i] for r in rows], dtype=torch.float32)
    got = recte.white_ramp_plain(starts.expand(len(rows), -1), col(0), col(1),
                                 col(2), exptime, P)
    for i, r in enumerate(rows):
        want = _loop(*(torch.tensor(v, dtype=torch.float32) for v in r),
                     starts, exptime)
        assert torch.equal(got[i], want), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", range(6))
def test_plain_tangent_is_jacfwd_of_the_loop_bit_for_bit(seed, dtype):
    starts, exptime, rate, f0_s, f0_f = _draw(100 + seed)
    rate0 = 112.484
    theta = _theta(rate, f0_s, f0_f, rate0, dtype)
    want = torch.func.jacfwd(
        lambda th: _loop(*_inputs(th, rate0), starts, exptime, dtype))(theta)
    primal = [v.reshape(1) for v in _inputs(theta, rate0)]
    for j in range(3):
        unit = torch.zeros(3, dtype=dtype)
        unit[j] = 1.0
        _, tangent = torch.func.jvp(lambda th: _inputs(th, rate0), (theta,),
                                    (unit,))
        ramp, d_ramp = recte.white_ramp_plain(
            starts[None].to(dtype), *primal, exptime, P,
            tuple(t.reshape(1) for t in tangent))
        assert torch.equal(d_ramp[0], want[:, j]), j
    assert torch.equal(ramp[0], _loop(*primal, starts, exptime, dtype))


def _ramp_of(starts, exptime):
    def f(rate, f0_s, f0_f):
        return recte.white_ramp(rate, starts, exptime, P, f0_s=f0_s,
                                f0_f=f0_f)
    return f


@pytest.mark.parametrize("seed", range(3))
def test_the_function_s_derivatives_agree(seed):
    starts, exptime, rate, f0_s, f0_f = _draw(200 + seed)
    x = [torch.tensor(v) for v in (rate, f0_s, f0_f)]
    f = _ramp_of(starts, exptime)
    J = torch.stack(torch.func.jacfwd(f, argnums=(0, 1, 2))(*x), dim=1)
    J_loop = torch.stack(torch.func.jacfwd(
        lambda *a: _loop(*a, starts, exptime), argnums=(0, 1, 2))(*x), dim=1)
    assert torch.equal(J, J_loop)
    assert torch.equal(f(*x), _loop(*x, starts, exptime))
    for j in range(3):
        unit = [torch.tensor(float(i == j)) for i in range(3)]
        _, d = torch.func.jvp(f, tuple(x), tuple(unit))
        assert torch.equal(d, J[:, j]), j
    # reverse mode: the unit directions' tangents summed against g
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        starts.shape[0]).astype(np.float32))
    xs = [v.clone().requires_grad_() for v in x]
    grads = torch.autograd.grad((f(*xs) * g).sum(), xs)
    for j in range(3):
        torch.testing.assert_close(grads[j], (J[:, j] * g).sum(), rtol=1e-6,
                                   atol=0.0)
    rev = torch.func.jacrev(f, argnums=(0, 1, 2))(*x)
    for j in range(3):
        torch.testing.assert_close(rev[j], J[:, j], rtol=1e-6, atol=1e-12)


def test_vmap_folds_the_batch_into_one_pass(monkeypatch):
    starts, exptime, rate, f0_s, f0_f = _draw(300)
    rates = torch.tensor([rate, 0.5 * rate, 2.0 * rate])
    f = _ramp_of(starts, exptime)
    want = [f(r, torch.tensor(f0_s), torch.tensor(f0_f)) for r in rates]
    calls = []
    _recording(monkeypatch, calls)
    got = torch.func.vmap(f, in_dims=(0, None, None))(
        rates, torch.tensor(f0_s), torch.tensor(f0_f))
    assert calls == [((3, starts.shape[0]), False)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    J = torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1, 2)),
                        in_dims=(0, None, None))(rates, torch.tensor(f0_s),
                                                 torch.tensor(f0_f))
    for i, r in enumerate(rates):
        Ji = torch.func.jacfwd(f, argnums=(0, 1, 2))(
            r, torch.tensor(f0_s), torch.tensor(f0_f))
        for j in range(3):
            assert torch.equal(J[j][i], Ji[j])


def test_jacfwd_of_the_fit_model_is_one_value_and_one_tangent_pass(
        monkeypatch):
    """Under the fit's jacfwd the primal is not batched: one pass for the
    value and one for the six directions' tangents, never a vmap rule."""
    starts, exptime, rate, f0_s, f0_f = _draw(400)
    calls = []
    _recording(monkeypatch, calls)

    def model(theta):
        rate_ = torch.tensor(rate) * torch.exp(theta[5])
        return recte.white_ramp(rate_, starts, exptime, P,
                                f0_s=torch.sigmoid(theta[3]),
                                f0_f=torch.sigmoid(theta[4])) * theta[0]

    theta = torch.tensor([1.0, 0.15, 0.0, -1.5, -1.5, 0.0])
    J = torch.func.jacfwd(model)(theta)
    n = starts.shape[0]
    assert calls == [((1, n), False), ((6, n), True)]
    assert J.shape == (n, 6) and J.dtype == torch.float32
    assert torch.equal(J[:, 1], torch.zeros(n))


def test_a_derivative_in_the_start_times_raises():
    starts, exptime, rate, f0_s, f0_f = _draw(500)
    with pytest.raises(ValueError, match="start times"):
        torch.func.jacfwd(lambda t: recte.white_ramp(
            torch.tensor(rate), t, exptime, P, f0_s=f0_s))(starts)
    with pytest.raises(ValueError, match="start times"):
        recte.white_ramp(torch.tensor(rate), starts.clone().requires_grad_(),
                         exptime, P)


def test_a_rate_per_exposure_takes_the_loop(monkeypatch):
    starts, exptime, rate, f0_s, f0_f = _draw(600)
    rates = torch.linspace(rate, 2.0 * rate, starts.shape[0])

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path took a rate per exposure")

    monkeypatch.setattr(recte, "_white_ramp_value", refuse)
    got = recte.white_ramp(rates, starts, exptime, P, f0_s=f0_s, f0_f=f0_f)
    t = starts.to(torch.float32)
    gaps = recte._exposure_gaps(t, exptime)[:, None]
    _, _, deficit = recte._trap_scan(
        P, exptime, torch.tensor([f0_s]) * P.n_trap_s,
        torch.tensor([f0_f]) * P.n_trap_f, rates[:, None], gaps)
    want = (1.0 - deficit / torch.clamp_min(rates[:, None] * exptime,
                                            1e-20))[:, 0]
    assert torch.equal(got, want)
    # and its Jacobian in the rates is the loop's lower triangle
    J = torch.func.jacfwd(lambda r: recte.white_ramp(
        r, starts, exptime, P, f0_s=f0_s, f0_f=f0_f))(rates)
    assert torch.equal(J, torch.tril(J)) and bool((J.diagonal() != 0).all())


def test_the_cpu_launches_nothing():
    starts, exptime, rate, f0_s, f0_f = _draw(700)
    before = recte.white_ramp.launches
    torch.func.jacfwd(_ramp_of(starts, exptime))(
        torch.tensor(rate), torch.tensor(f0_s), torch.tensor(f0_f))
    assert recte.white_ramp.launches == before
    assert recte._lib is None          # nothing built or loaded


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_recte_kernel.py --noconftest -m cuda)")
    return torch.device("cuda")


def _visit_starts():
    with open(MIDTIMES) as fh:
        frozen = json.load(fh)
    t = torch.tensor(frozen["exp_mid_s"], dtype=torch.float32)
    exptime = float(frozen["exptime_s"])
    return t - 0.5 * exptime, exptime


def _rows(rng, n, dev):
    rate = np.exp(rng.uniform(math.log(30.0), math.log(400.0), n))
    cols = [rate, rng.uniform(0.02, 0.6, n), rng.uniform(0.02, 0.6, n),
            rng.standard_normal(n) * rate, rng.standard_normal(n),
            rng.standard_normal(n)]
    return [torch.tensor(c, dtype=torch.float32, device=dev) for c in cols]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 6, 37])
def test_the_kernel_is_the_plain_version_bit_for_bit(card, B):
    starts, exptime = _visit_starts()
    rng = np.random.default_rng(B)
    # the visit's clock in row 0, shifted and stretched in the others
    scale = torch.tensor(rng.uniform(0.8, 1.2, B), dtype=torch.float32)
    s = (starts[None] * scale[:, None]).contiguous().to(card)
    rate, f0_s, f0_f, *tangents = _rows(rng, B, card)
    before = recte.white_ramp.launches
    ramp = recte._white_ramp_value(s, rate, f0_s, f0_f, exptime, P)
    ramp_t, d_ramp = recte._white_ramp_value(s, rate, f0_s, f0_f, exptime, P,
                                             tuple(tangents))
    assert recte.white_ramp.launches == before + 2
    want = recte.white_ramp_plain(s, rate, f0_s, f0_f, exptime, P)
    want_t, want_d = recte.white_ramp_plain(s, rate, f0_s, f0_f, exptime, P,
                                            tuple(tangents))
    assert torch.equal(ramp, want) and torch.equal(ramp_t, want)
    assert torch.equal(want_t, want)
    assert torch.equal(d_ramp, want_d)


@pytest.mark.cuda
def test_the_kernel_path_is_the_loop_bit_for_bit_on_the_card(card):
    starts, exptime = _visit_starts()
    starts = starts.to(card)
    rate0 = 112.484
    for seed in range(4):
        rng = np.random.default_rng(seed)
        theta = torch.tensor(rng.uniform([-0.3, -2.5, -2.5], [0.3, 0.5, 0.5]),
                             dtype=torch.float32, device=card)

        def kernel(th):
            rate, f0_s, f0_f = _inputs(th, rate0)
            return recte.white_ramp(rate, starts, exptime, P, f0_s=f0_s,
                                    f0_f=f0_f)

        def loop(th):
            return _loop(*_inputs(th, rate0), starts, exptime)

        assert torch.equal(kernel(theta), loop(theta)), seed
        assert torch.equal(torch.func.jacfwd(kernel)(theta),
                           torch.func.jacfwd(loop)(theta)), seed


@pytest.mark.cuda
def test_one_launch_an_eager_call_and_two_under_jacfwd(card):
    starts, exptime = _visit_starts()
    starts = starts.to(card)
    x = [torch.tensor(v, device=card) for v in (112.484, 0.2, 0.1)]
    f = _ramp_of(starts, exptime)
    before = recte.white_ramp.launches
    f(*x)
    assert recte.white_ramp.launches == before + 1
    torch.func.jacfwd(f, argnums=(0, 1, 2))(*x)
    assert recte.white_ramp.launches == before + 3


@pytest.mark.cuda
def test_the_kernel_in_a_cuda_graph_syncs_with_nothing(card):
    """The fit's model and its Jacobian captured into a graph on a side
    stream, as ``reduction._lm_replay`` captures a step, then replayed:
    no host sync in either, and the eager bits."""
    starts, exptime = _visit_starts()
    starts = starts.to(card)
    rate0 = torch.tensor(112.484, device=card)

    def model(th):
        return recte.white_ramp(rate0 * torch.exp(th[0]), starts, exptime, P,
                                f0_s=torch.sigmoid(th[1]),
                                f0_f=torch.sigmoid(th[2]))

    theta = torch.tensor([0.1, -1.5, -1.0], device=card)
    eager = [model(theta), torch.func.jacfwd(model)(theta)]
    static = theta.clone()
    out = [torch.empty_like(e) for e in eager]
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out[0].copy_(model(static))
                out[1].copy_(torch.func.jacfwd(model)(static))
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        for _ in range(3):
            graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
    static.copy_(torch.tensor([-0.2, 0.0, -2.0], device=card))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], model(static))
    assert torch.equal(out[1], torch.func.jacfwd(model)(static))


@pytest.mark.cuda
def test_fit_white_recte_on_the_card(card, monkeypatch):
    """The white RECTE fit on the card: the loop's fit bit for bit, and
    within ``tests/test_torch_recte_reference.py``'s limits of the float64
    reference's fit of the same float32 arrays (its visit: fills 0.3 and
    0.1, rate x1.1, a slope, 2e-4 noise; 12 steps)."""
    with open(MIDTIMES) as fh:
        frozen = json.load(fh)
    t_mid = np.asarray(frozen["exp_mid_s"], np.float32)
    exptime = float(frozen["exptime_s"])
    f32 = lambda v: float(np.float32(v))
    orbit = ref.Orbit(period_s=f32(0.813475 * 86400.0),
                      t0_s=f32((56000.0 - frozen["visit_start_mjd"])
                               * 86400.0),
                      sma_rs=f32(4.855), inc_rad=f32(math.radians(82.1)),
                      ecc=0.0, omega_rad=f32(math.radians(90.0)))
    ld, rp, rate = [0.65, -0.25, 0.45, -0.2], 0.1595, 300.0
    t = torch.from_numpy(t_mid.astype(np.float64))
    z, front = ref.separation(t, orbit)
    ramp = rec.white_ramp(rate * 1.1, t - 0.5 * exptime, exptime, rec.Traps(),
                          0.3, 0.1)
    sys_ = (1 - 0.002 * (t - t.mean()) / 86400.0) * ramp
    f = ref.transit_flux(z, torch.tensor(rp + 4e-4, dtype=torch.float64),
                         torch.tensor(ld, dtype=torch.float64), 64)
    white = (sys_ * (1 - (1 - f) * front) + 2e-4 * torch.from_numpy(
        np.random.default_rng(17).standard_normal(len(t)))).numpy().astype(
            np.float32)
    o = OrbitParams.create(orbit.period_s, orbit.t0_s, orbit.sma_rs,
                           orbit.inc_rad, orbit.ecc, orbit.omega_rad,
                           device=card)
    args = (torch.as_tensor(white, device=card),
            torch.as_tensor(t_mid, device=card), o,
            torch.tensor(ld, dtype=torch.float32, device=card), rp)
    kw = dict(rate_e_s=rate, exptime_s=exptime, n_iter=12)
    got = red.fit_white_recte(*args, **kw)
    six = lambda w: torch.stack([w.c, w.rp, w.slope_per_day, w.f0_s, w.f0_f,
                                 w.rate_scale]).double().cpu()
    want = rec.fit_recte_visit(white, white[:, None], t_mid, exptime, orbit,
                               ld, rp, rate, 12)
    gap = (six(got) - want.white).abs() / want.white_sigma
    assert float(gap.max()) < 0.1, gap
    # the loop: the scalar rate expanded over the exposures
    loop_ramp = recte.white_ramp
    monkeypatch.setattr(red, "white_ramp", lambda r, s, *a, **k: loop_ramp(
        torch.as_tensor(r).expand(s.shape), s, *a, **k))
    loop = red.fit_white_recte(*args, **kw)
    for name in got.__dataclass_fields__:
        assert torch.equal(getattr(got, name), getattr(loop, name)), name

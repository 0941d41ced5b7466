"""RECTE charge trapping (port of the JAX package's ``ops/recte``; Zhou,
Apai, Lew & Schneider 2017, AJ 153, 243).

Each pixel carries a slow and a fast trap population,

    dE_p/dt = eta_p * f * (1 - E_p / n_p) - E_p / tau_p ,   p in {s, f},

driven by the pixel's illumination rate f. Trap state depends only on the
noise-free illumination history, so every exposure's response is computed
once per visit, before the chunked simulation, by a loop over the visit's
exposures (the JAX package's ``lax.scan``), and handed to the readout as
two Scene leaves: the thinning plane ``trap_mult`` = 1 - capture / fluence
on the expected rates, and a release rate that joins ``persist_rate``.

The white-light fit (``reduction.fit_white_recte``) differentiates the
same recurrence at one illuminated rate a light curve, :func:`white_ramp`.
There it is one CUDA kernel (``csrc/recte_ramp.cu``) that returns the
ramp, and given tangents of the rate and the two initial fills, the ramp's
tangent, each equal to the loop's and to its forward-mode derivative bit
for bit; an autograd Function (:class:`_WhiteRamp`) launches it for the
value and, in its ``jvp``, for the tangents. :func:`white_ramp_plain`,
the loop over rows and ``torch.func.jvp`` of it, is its plain version,
taken for CPU tensors. The kernel's library is its own,
built from ``csrc/recte_ramp.cu`` at the first call on a card; its
launches are counted in ``white_ramp.launches``.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from wayne_tpu_torch.ops import readout as ro
from wayne_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class RecteParams:
    """Trap populations. Defaults: Zhou et al. (2017) best-fit values."""

    n_trap_s: float = 1525.38    # slow-trap count per pixel
    eta_s: float = 0.013318     # slow capture efficiency
    tau_s: float = 1.63e4       # slow release timescale (s)
    n_trap_f: float = 162.38     # fast-trap count per pixel
    eta_f: float = 0.008407     # fast capture efficiency
    tau_f: float = 281.463      # fast release timescale (s)


def _constant_rate(f: torch.Tensor, dt: float, n_tot: float, eta: float,
                   tau: float):
    """``(b, a / b, exp(-b dt))`` of constant illumination ``f``, with
    a = eta f, b = a/n + 1/tau: the rate, the level E approaches, and what
    is left of its distance from that level after ``dt`` s."""
    a = eta * f
    b = a / n_tot + 1.0 / tau
    return b, a / b, torch.exp(-b * dt)


def _evolve_constant_rate(e0: torch.Tensor, f: torch.Tensor, dt: float,
                          n_tot: float, eta: float, tau: float
                          ) -> torch.Tensor:
    """Trap population after ``dt`` s of constant illumination ``f``:
    E(dt) = a/b + (E0 - a/b) exp(-b dt), a = eta f, b = a/n + 1/tau."""
    _, e_inf, x = _constant_rate(f, dt, n_tot, eta, tau)
    return e_inf + (e0 - e_inf) * x


def _exposure_gaps(exp_start_s: torch.Tensor, exptime_s: float,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., N) free-decay gap before each exposure of (..., N) start
    times, in ``dtype``; the first is 0."""
    t = torch.as_tensor(exp_start_s, dtype=dtype)
    gaps = torch.cat([torch.zeros_like(t[..., :1]),
                      t[..., 1:] - t[..., :-1] - exptime_s], dim=-1)
    return torch.clamp_min(gaps, 0.0)


def _trap_scan(p: RecteParams, exptime_s: float, e_s, e_f, rates, gaps):
    """The two populations through the visit: free decay over each gap,
    then the constant-rate closed form over the exposure. Returns the
    final (e_s, e_f) and the (N, ...) signed per-exposure deficit."""
    deficit = []
    for f, gap in zip(rates, gaps):
        e_s = e_s * torch.exp(-gap / p.tau_s)
        e_f = e_f * torch.exp(-gap / p.tau_f)
        e_s_new = _evolve_constant_rate(e_s, f, exptime_s,
                                        p.n_trap_s, p.eta_s, p.tau_s)
        e_f_new = _evolve_constant_rate(e_f, f, exptime_s,
                                        p.n_trap_f, p.eta_f, p.tau_f)
        deficit.append((e_s_new - e_s) + (e_f_new - e_f))
        e_s, e_f = e_s_new, e_f_new
    return e_s, e_f, torch.stack(deficit)


def trap_deltas(rate_stack: torch.Tensor, exp_start_s: torch.Tensor,
                exptime_s: float, params: RecteParams = RecteParams(),
                f0_s: float = 0.0, f0_f: float = 0.0):
    """Net trapped-charge change per exposure, the observed deficit.

    ``rate_stack`` (N, S, S) noise-free illumination rates (e-/s);
    ``f0_s`` / ``f0_f`` initial fill fractions at the first exposure's
    start. Returns ``(deficit_e (N, S, S), e_s_end, e_f_end)``: positive
    deficit = net capture, negative = net release.
    """
    p = params
    rates = rate_stack.to(torch.float32)
    gaps = _exposure_gaps(exp_start_s, exptime_s).to(rates.device)
    shape = rates.shape[1:]
    e_s0 = torch.full(shape, f0_s * p.n_trap_s, dtype=torch.float32,
                      device=rates.device)
    e_f0 = torch.full(shape, f0_f * p.n_trap_f, dtype=torch.float32,
                      device=rates.device)
    e_s, e_f, deficit = _trap_scan(p, exptime_s, e_s0, e_f0, rates, gaps)
    return deficit, e_s, e_f


def thin_and_release(deficit_e: torch.Tensor, fluence_e: torch.Tensor,
                     exptime_s: float):
    """``(trap_mult, release_rate)``: the thinning plane in [0, 1] on the
    expected source + background, and the non-negative e-/s release rate
    that joins the persistence rate."""
    cap = torch.clamp_min(deficit_e, 0.0)
    rel = torch.clamp_min(-deficit_e, 0.0)
    trap_mult = torch.clamp(1.0 - cap / torch.clamp_min(fluence_e, 1e-20),
                            0.0, 1.0)
    return trap_mult, rel / exptime_s


def white_ramp_plain(starts: torch.Tensor, rate: torch.Tensor,
                     f0_s: torch.Tensor, f0_f: torch.Tensor,
                     exptime_s: float, params: RecteParams = RecteParams(),
                     tangents=None):
    """The plain version of :func:`white_ramp`'s kernel
    (``csrc/recte_ramp.cu``), for B rows, each a light curve at one
    illuminated rate: ``starts`` (B, N) exposure start times; ``rate``,
    ``f0_s``, ``f0_f`` (B,), all of one dtype. Returns the ramp (B, N) by
    the loop :func:`_trap_scan`, the rows on its trailing axis. Given
    ``tangents``, a tangent (B,) of each of the rate and the two fills,
    returns ``(ramp, its tangent (B, N))``: ``torch.func.jvp`` of the
    loop."""
    p = params
    gaps = _exposure_gaps(starts, exptime_s, starts.dtype).T    # (N, B)

    def ramp(rate, f0_s, f0_f):
        f = rate.expand(gaps.shape)
        _, _, deficit = _trap_scan(p, exptime_s, f0_s * p.n_trap_s,
                                   f0_f * p.n_trap_f, f, gaps)
        return (1.0 - deficit / torch.clamp_min(f * exptime_s, 1e-20)).T

    if tangents is None:
        return ramp(rate, f0_s, f0_f)
    return torch.func.jvp(ramp, (rate, f0_s, f0_f), tuple(tangents))


# ---------------------------------------------------------------------------
# The CUDA kernel: its own library, built at first use, bound with ctypes
# ---------------------------------------------------------------------------

SOURCES = ("recte_ramp.cu",)
MAX_EXPOSURES = 2048    # csrc/recte_ramp.cu: 24 B of shared memory each
_lib = None
_lib_lock = threading.Lock()


def library_path(flags: list[str] = ro.NVCC_FLAGS) -> str:
    """Where the kernel's library for the current source is (or will be)."""
    return ro.library_path(flags, stem="recte", sources=SOURCES, headers=())


def build(verbose: bool = False, flags: list[str] = ro.NVCC_FLAGS) -> str:
    """Compile ``csrc/recte_ramp.cu`` into build/ unless it is built so
    already (``ops.readout.build``: the readout kernels' flags, a library
    of its own); returns its path."""
    return ro.build(verbose, flags, stem="recte", sources=SOURCES,
                    headers=())


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.wayne_recte_white_ramp
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                           + [ctypes.c_float] * 11 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _kernel_consts(p: RecteParams, exptime_s: float) -> list[float]:
    """The kernel's host scalars, rounded to float32 as PyTorch rounds the
    plain version's Python floats on a card: the exposure time, then per
    population n, eta, 1/n and 1/tau as the float32 reciprocals that a
    division by a Python float multiplies by there, and 1.0 / tau as the
    Python float it is."""
    f = np.float32
    out = [f(exptime_s)]
    for n, eta, tau in ((p.n_trap_s, p.eta_s, p.tau_s),
                        (p.n_trap_f, p.eta_f, p.tau_f)):
        out += [f(n), f(eta), f(1) / f(n), f(1.0 / tau), f(1) / f(tau)]
    return [float(v) for v in out]


def _white_ramp_value(starts, rate, f0_s, f0_f, exptime_s: float,
                      params: RecteParams, tangents=None):
    """:func:`white_ramp_plain` for CPU tensors, the kernel for CUDA
    tensors (primal tensors only: this runs inside the Functions' forward
    and backward)."""
    if starts.device.type == "cpu":
        return white_ramp_plain(starts, rate, f0_s, f0_f, exptime_s, params,
                                tangents)
    if starts.device.type != "cuda":
        raise ValueError(f"no RECTE kernel for device {starts.device}")
    dev = starts.device
    B, N = starts.shape
    if N > MAX_EXPOSURES:
        raise ValueError(f"the RECTE kernel takes at most {MAX_EXPOSURES} "
                         f"exposures a light curve, got {N}")
    f32 = torch.float32
    ro._check("starts", starts, (B, N), f32, dev)
    rows = (rate, f0_s, f0_f) + tuple(tangents or ())
    for name, t in zip(("rate", "f0_s", "f0_f", "rate's tangent",
                        "f0_s's tangent", "f0_f's tangent"), rows):
        ro._check(name, t, (B,), f32, dev)
    ramp = torch.empty((B, N), dtype=f32, device=dev)
    d_ramp = None if tangents is None else torch.empty_like(ramp)
    ptr = lambda t: None if t is None else t.data_ptr()
    t_ptrs = (None,) * 3 if tangents is None else tuple(map(ptr, tangents))
    ro._launch(_library().wayne_recte_white_ramp, dev, ptr(starts),
               ptr(rate), ptr(f0_s), ptr(f0_f), *t_ptrs, ptr(ramp),
               ptr(d_ramp), B, N, *_kernel_consts(params, exptime_s))
    ro._count(white_ramp)
    return ramp if tangents is None else (ramp, d_ramp)


def _fold(n: int, tensors, in_dims) -> list[torch.Tensor]:
    """Each tensor with its mapped axis (of ``n``) folded into its first,
    an unmapped one repeated ``n`` times: the rows of one launch."""
    def fold(t, d):
        t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
        return t.reshape(-1, *t.shape[2:]).contiguous()
    return [fold(t, d) for t, d in zip(tensors, in_dims)]


_NO_START_DERIVATIVE = ("white_ramp has no derivative with respect to the "
                        "exposure start times")


class _WhiteRampTangent(torch.autograd.Function):
    """The ramp's tangent (B, N) from ``(starts, rate, f0_s, f0_f, t_rate,
    t_f0_s, t_f0_f, exptime_s, params)``: the kernel's second mode, launched
    by :class:`_WhiteRamp`'s ``jvp``. Its ``vmap`` folds a mapped axis
    into the rows, so that the tangents of every direction of a
    ``torch.func.jacfwd`` go in one launch."""

    @staticmethod
    def forward(starts, rate, f0_s, f0_f, t_rate, t_f0_s, t_f0_f, exptime_s,
                params):
        return _white_ramp_value(starts, rate, f0_s, f0_f, exptime_s, params,
                                 (t_rate, t_f0_s, t_f0_f))[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        if any(ctx.needs_input_grad):
            raise ValueError("white_ramp has no second derivative")

    @staticmethod
    def vmap(info, in_dims, starts, rate, f0_s, f0_f, t_rate, t_f0_s, t_f0_f,
             exptime_s, params):
        n = info.batch_size
        d_ramp = _WhiteRampTangent.apply(
            *_fold(n, (starts, rate, f0_s, f0_f, t_rate, t_f0_s, t_f0_f),
                   in_dims[:7]), exptime_s, params)
        return d_ramp.reshape(n, -1, d_ramp.shape[-1]), 0


class _WhiteRamp(torch.autograd.Function):
    """The RECTE ramp (B, N) of B rows from ``(starts (B, N), rate, f0_s,
    f0_f (B,), exptime_s, params)``, differentiable with respect to the
    rate and the two fills. The value comes from :func:`_white_ramp_value`
    (one launch on a card) on primal tensors only. ``jvp`` launches the
    kernel once more with the tangents (:class:`_WhiteRampTangent`), which
    carries them through the recurrence as forward-mode autodiff carried
    them through the loop: ``torch.func.jacfwd`` of the fit's model takes
    one launch for its value and one for all six directions, and gives the
    loop's Jacobian bit for bit. ``backward`` takes the tangents of the
    three inputs' unit directions and sums them against the incoming
    gradient; ``vmap`` folds a mapped axis into the rows. A derivative with
    respect to the start times raises: they are data."""

    @staticmethod
    def forward(starts, rate, f0_s, f0_f, exptime_s, params):
        return _white_ramp_value(starts, rate, f0_s, f0_f, exptime_s, params)

    @staticmethod
    def setup_context(ctx, inputs, output):
        if ctx.needs_input_grad[0]:
            raise ValueError(_NO_START_DERIVATIVE)
        ctx.exptime_s, ctx.params = inputs[4], inputs[5]
        # an input without a tangent gets None in jvp
        ctx.set_materialize_grads(False)
        ctx.save_for_forward(*inputs[:4])
        ctx.save_for_backward(*inputs[:4])

    @staticmethod
    def jvp(ctx, t_starts, t_rate, t_f0_s, t_f0_f, _exptime, _params):
        if t_starts is not None:
            raise ValueError(_NO_START_DERIVATIVE)
        primals = ctx.saved_tensors
        # in the primal's dtype: a 0-dim tensor times a Python float gives
        # forward mode a float64 tangent, and the fits differentiate the
        # ramp in float32, as the JAX package does
        tangents = [torch.zeros_like(p) if t is None
                    else t.to(p.dtype).contiguous()
                    for p, t in zip(primals[1:], (t_rate, t_f0_s, t_f0_f))]
        return _WhiteRampTangent.apply(*primals, *tangents, ctx.exptime_s,
                                       ctx.params)

    @staticmethod
    def backward(ctx, g_ramp):
        if g_ramp is None:
            return None, None, None, None, None, None
        starts, *inputs = ctx.saved_tensors
        B = starts.shape[0]
        # rows (direction, b): the tangent of each input's unit direction
        unit = torch.eye(3, dtype=starts.dtype,
                         device=starts.device).repeat_interleave(B, dim=1)
        _, d_ramp = _white_ramp_value(
            starts.repeat(3, 1), *(t.repeat(3) for t in inputs),
            ctx.exptime_s, ctx.params, tuple(unit))
        g = (d_ramp.reshape(3, B, -1) * g_ramp).sum(-1)
        return None, g[0], g[1], g[2], None, None

    @staticmethod
    def vmap(info, in_dims, starts, rate, f0_s, f0_f, exptime_s, params):
        n = info.batch_size
        ramp = _WhiteRamp.apply(
            *_fold(n, (starts, rate, f0_s, f0_f), in_dims[:4]), exptime_s,
            params)
        return ramp.reshape(n, -1, ramp.shape[-1]), 0


def white_ramp(rate_e_s, exp_start_s: torch.Tensor, exptime_s: float,
               params: RecteParams = RecteParams(), f0_s=0.0,
               f0_f=0.0) -> torch.Tensor:
    """(N,) relative RECTE ramp 1 - deficit / (rate * exptime) of a light
    curve at a representative illuminated-pixel rate (scalar or (N,)).

    A scalar rate, as the white fit passes it, takes :class:`_WhiteRamp`:
    the kernel on a card (one launch, and one more for the tangents of a
    forward-mode derivative; counted in ``white_ramp.launches``),
    :func:`white_ramp_plain` on the CPU, differentiable with respect to the
    rate and the fills, with the loop's derivatives bit for bit. An (N,)
    rate takes the loop :func:`_trap_scan`. Either is the span
    ``recte.ramp`` (``utils.profiling``); under a transform or a CUDA
    graph's capture it records the host's pass."""
    p = params
    t = torch.as_tensor(exp_start_s, dtype=torch.float32)
    rate = torch.as_tensor(rate_e_s, dtype=torch.float32, device=t.device)
    if rate.dim() == 0:
        one = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                        device=t.device).reshape(1)
        with span("recte.ramp"):
            ramp = _WhiteRamp.apply(t.reshape(1, -1).contiguous(),
                                    rate.reshape(1), one(f0_s), one(f0_f),
                                    float(exptime_s), p)
        return ramp[0]
    # one trailing axis of length 1: forward-mode autodiff gives a 0-dim
    # float32 tensor times a Python float a float64 tangent, and the fits
    # differentiate this scan in float32, as the JAX package does
    f = rate.expand(t.shape)[:, None]
    gaps = _exposure_gaps(t, exptime_s)[:, None]
    e_s0 = torch.as_tensor(f0_s, dtype=torch.float32,
                           device=t.device).reshape(1) * p.n_trap_s
    e_f0 = torch.as_tensor(f0_f, dtype=torch.float32,
                           device=t.device).reshape(1) * p.n_trap_f
    with span("recte.ramp"):
        _, _, deficit = _trap_scan(p, exptime_s, e_s0, e_f0, f, gaps)
    return (1.0 - deficit / torch.clamp_min(f * exptime_s, 1e-20))[:, 0]


white_ramp.launches = 0


def visit_trap_maps(scenes, tables, cfg, rcfg, chunk: int = 8,
                    fluence_stack: torch.Tensor | None = None):
    """The whole visit's ``(trap_mult, release_rate)`` Scene leaves from
    its noise-free fluence stack (N, S, S): ``fluence_stack`` when given
    (shared with the persistence model), else one noise-free pass of the
    visit here (:func:`ops.visit.visit_fluence_stack`, ``chunk``
    exposures a launch)."""
    if fluence_stack is None:
        from wayne_tpu_torch.ops.visit import visit_fluence_stack

        fluence_stack = visit_fluence_stack(scenes, tables, cfg, chunk)
    exptime = float(tables.read_times[-1])
    params = RecteParams(
        n_trap_s=rcfg.n_trap_s, eta_s=rcfg.eta_s, tau_s=rcfg.tau_s,
        n_trap_f=rcfg.n_trap_f, eta_f=rcfg.eta_f, tau_f=rcfg.tau_f)
    deficit, _, _ = trap_deltas(
        fluence_stack / exptime, scenes.exp_start_s, exptime,
        params=params, f0_s=rcfg.f0_s, f0_f=rcfg.f0_f)
    return thin_and_release(deficit, fluence_stack, exptime)

"""Reduction pipeline in PyTorch (port of the JAX package's ``reduction``):
raw reads -> extracted light curves -> fitted depths, on the device.

Plain tensor functions with the JAX package's names and semantics. Where
the JAX package maps one exposure (or one realisation) with ``jax.vmap``,
the functions here take a leading batch axis instead:

  * extraction: :func:`linearize_reads` (calwf3 NLINCORR),
    :func:`ramp_slope_frame`, the cosmic-ray masks and repairs
    (:func:`cr_bad_diff_masks`, :func:`good_diff_masks_from_dq`,
    :func:`repair_read_stack`, :func:`repair_read_stack_sparse`),
    :func:`extract_spectra_cr` (reads (B, NR, S, S), hit lists
    (B, NSAMP, 2, MAX_CR)), :func:`ref_pixel_correct`, :func:`net_frame`,
    :func:`extract_exposure`, :func:`spatial_profile`,
    :func:`optimal_extract`;
  * baselines and drifts: :func:`out_of_transit_mask`,
    :func:`scan_direction_factor`, :func:`amp_offset_correct`, the drift
    helpers (:func:`spectral_shifts` ... :func:`shift_detrend`);
  * :func:`reduce_visit` (reads (n_exp, NR, S, S));
  * depths: :func:`fit_depths` (Newton steps on the transit model's chi^2
    with autograd; every channel and realisation in one tensor program),
    :func:`common_mode_correct`, :func:`divide_white_fit_depths`,
    :func:`spectra_to_depths` (spectra (mc, n_exp, S)) and
    :func:`constrained_mask`;
  * the background and white-light systematics fits:
    :func:`fit_sky_model` (every exposure in one solve),
    :func:`fit_eclipse_depths`, :func:`fit_phase_curve`, and the
    Levenberg-Marquardt fits :func:`fit_white_ramp` (with
    :func:`orbit_phase` and :func:`ramp_detrend`) and
    :func:`fit_white_recte`.

Nothing waits for the host: budgets come from static shapes, linear
solves use ``solve_ex`` (no error check), and the per-hit sums of the
ensemble path are pairwise masks, not scatters. So on a card the
Levenberg-Marquardt fits replay every step after the first from a CUDA
graph (:func:`_lm_minimize`). Medians average the two middle values of
an even count, as ``jnp.median`` does (:func:`_median`),
not the lower one as ``torch.median``. A clip that a fit differentiates
is written ``minimum(maximum(x, lo), hi)`` (:func:`_clip`): its derivative
at a bound is 1/2, as ``jnp.clip``'s, where ``torch.clamp``'s is 1.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from wayne_tpu_torch.calibration import quadrant_map
from wayne_tpu_torch.ops.kepler import (
    OrbitParams, orbital_phase_angle, projected_separation,
)
from wayne_tpu_torch.ops.recte import white_ramp
from wayne_tpu_torch.ops.transit import eclipse_visibility, transit_depth_curve
from wayne_tpu_torch.utils.profiling import span

# DQ bits the repair consumes (io.ima conventions): cosmic ray (8192),
# saturation (256), and the static classes (hot 16, dead 4, IR blob 512,
# unstable 32), whose every interval is bad. Reference pixels (128) are
# not repaired; ref_pixel_correct reads them as the per-read bias monitor.
DQ_COSMIC_RAY, DQ_SATURATED, DQ_HOT_PIXEL = 8192, 256, 16
DQ_REF_PIXEL = 128
DQ_DEAD, DQ_BLOB, DQ_UNSTABLE = 4, 512, 32
DQ_STATIC_BAD = DQ_HOT_PIXEL | DQ_DEAD | DQ_BLOB | DQ_UNSTABLE
DQ_BAD_BITS = DQ_COSMIC_RAY | DQ_SATURATED | DQ_STATIC_BAD


def _median(x: torch.Tensor, dim: int, nan: bool = False) -> torch.Tensor:
    """Median over ``dim`` as ``jnp.median`` (``nan=False``: any NaN gives
    NaN) or ``jnp.nanmedian`` (``nan=True``: NaNs skipped, all-NaN gives
    NaN) compute it: the two middle values of an even count averaged,
    ``(lo + hi) * 0.5``. ``torch.median`` returns the lower one."""
    s, _ = torch.sort(x, dim=dim)               # NaNs sort to the end
    if nan:
        n = (~torch.isnan(s)).sum(dim=dim, keepdim=True)
    else:
        n = torch.full_like(s.narrow(dim, 0, 1), s.shape[dim],
                            dtype=torch.long)
    lo = torch.clamp_min(torch.div(n - 1, 2, rounding_mode="floor"), 0)
    hi = torch.clamp_min(torch.div(n, 2, rounding_mode="floor"), 0)
    hi = torch.where(n > 0, hi, lo)
    out = (torch.gather(s, dim, lo) + torch.gather(s, dim, hi)) * 0.5
    if not nan:
        out = torch.where(torch.isnan(x).any(dim=dim, keepdim=True),
                          math.nan, out)
    return out.squeeze(dim)


_SCAN_BLOCK = 16


def prefix_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Float32 prefix sum along ``dim`` in XLA's order: sequential within
    blocks of 16, the block totals scanned the same way and added on.
    ``jnp.cumsum`` rounds so on the CPU (its long reduce_window becomes
    this blocked scan), while ``torch.cumsum`` accumulates in double on
    the CPU and in another float order on the card. The same elementwise
    adds on either device, so the card rounds as the CPU does."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = [x[..., 0]]
        for k in range(1, n):
            out.append(out[-1] + x[..., k])
        return torch.stack(out, dim=-1).movedim(-1, dim)
    m = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, m * _SCAN_BLOCK - n))
    inner = prefix_sum(xp.reshape(*x.shape[:-1], m, _SCAN_BLOCK))
    outer = prefix_sum(inner[..., -1])                        # (..., m)
    excl = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]],
                     dim=-1)
    out = (inner + excl[..., None]).reshape(*x.shape[:-1], m * _SCAN_BLOCK)
    return out[..., :n].movedim(-1, dim)


def _channel_edges(x_window: tuple[int, int], n_chan: int) -> np.ndarray:
    """Integer channel edges over [x_lo, x_hi): a float64 NumPy linspace
    truncated to int, the JAX package's recipe, so that every package and
    the CLI place each interior edge on the same column. Zero-width
    channels would give 0/0 light curves, so they are refused."""
    lo, hi = int(x_window[0]), int(x_window[1])
    if n_chan > hi - lo:
        raise ValueError(
            f"n_chan={n_chan} exceeds the {hi - lo}-column window "
            f"{x_window}: zero-width channels would produce NaN curves")
    return np.linspace(lo, hi, n_chan + 1).astype(np.int64)


@dataclass
class ReducedVisit:
    """Outputs of :func:`reduce_visit`."""

    spectra_e: torch.Tensor      # (n_exp, S) net electrons per column
    white_lc: torch.Tensor       # (n_exp,) normalised white light curve
    channel_lc: torch.Tensor     # (n_exp, n_chan) normalised channel curves
    channel_cols: torch.Tensor   # (n_chan, 2) int32 [lo, hi) column ranges
    x_shifts: torch.Tensor       # (n_exp,) fitted dispersion-direction
    #                              drifts in px (zeros unless align=True)


def good_diff_masks_from_dq(dq: torch.Tensor) -> torch.Tensor:
    """Per-interval good-difference masks from ima DQ planes.

    A cosmic ray (8192, cumulative from the hit read on) corrupts only the
    interval where the flag appears; saturation (256) any interval that
    touches a saturated read; the static classes (hot, dead, blob,
    unstable) every interval.

    Args:
      dq: (..., NR, S, S) int DQ planes in time order (read_ima).
    Returns (..., NR-1, S, S) bool, True where the difference is usable.
    """
    a, b = dq[..., :-1, :, :], dq[..., 1:, :, :]
    cr_bad = ((a & DQ_COSMIC_RAY) != 0) ^ ((b & DQ_COSMIC_RAY) != 0)
    sat_bad = ((a | b) & DQ_SATURATED) != 0
    static_bad = ((a | b) & DQ_STATIC_BAD) != 0
    return ~(cr_bad | sat_bad | static_bad)


def ref_pixel_correct(reads: torch.Tensor, ref_mask: torch.Tensor,
                      corner: tuple[float, float] | None = None,
                      clip_sigma: float = 5.0):
    """Per-read, per-amplifier reference-pixel bias correction (calwf3
    BLEVCORR): each read's per-quadrant mean reference level, relative to
    read 0, after one clip of the reference pixels more than
    ``clip_sigma`` from their quadrant mean, is subtracted from that
    quadrant. A quadrant without reference pixels is left as it is.

    Args:
      reads: (..., NR, S, S) read stack (DN or e-).
      ref_mask: (S, S) truthy on the blind reference pixels (DQ 128).
      corner: (x0, y0) of the frame in the 1024^2 full frame; None =
        centered.

    Returns (corrected (..., NR, S, S), offsets (..., NR, 4)), offsets[0]
    = 0. The contractions run in fp32 with TF32 off (the package sets it).
    """
    reads = reads.to(torch.float32)
    S = reads.shape[-1]
    quad = quadrant_map(S, corner, device=reads.device)         # (S, S)
    w = (ref_mask > 0).to(torch.float32)[None, :, :] \
        * (quad[None] == torch.arange(4, device=reads.device
                                      )[:, None, None])         # (4, S, S)
    counts = torch.clamp_min(w.sum(dim=(1, 2)), 1.0)            # (4,)
    mean = torch.einsum("...kij,qij->...kq", reads, w) / counts  # (NR, 4)
    resid = reads - mean[..., quad]
    var = torch.einsum("...kij,qij->...kq", resid * resid, w) / counts
    good = (torch.abs(resid)
            <= clip_sigma * torch.sqrt(var)[..., quad] + 1e-6)
    wk = w * good[..., None, :, :].to(torch.float32)            # (NR,4,S,S)
    counts_k = torch.clamp_min(wk.sum(dim=(-2, -1)), 1.0)
    mean = torch.einsum("...kij,...kqij->...kq", reads, wk) / counts_k
    has_ref = (w.sum(dim=(1, 2)) > 0).to(torch.float32)         # (4,)
    offsets = (mean - mean[..., :1, :]) * has_ref
    return reads - offsets[..., quad], offsets


def cr_bad_diff_masks(cr_pos: torch.Tensor, cr_count: torch.Tensor,
                      s: int) -> torch.Tensor:
    """Per-INTERVAL corruption masks from the simulator's hit lists: a hit
    during read interval k corrupts exactly the difference reads[k+1] -
    reads[k].

    Args:
      cr_pos: (B, nsamp, 2, MAX_CR) int32 hit rows/cols.
      cr_count: (B, nsamp) int32 actual hits per interval.
    Returns (B, nsamp, s, s) bool — True where the interval diff is BAD.
    """
    B, nsamp, _, n_cr = cr_pos.shape
    valid = torch.arange(n_cr, device=cr_pos.device) < cr_count[..., None]
    idx = cr_pos[:, :, 0].long() * s + cr_pos[:, :, 1].long()
    # counts of valid hits per pixel: integer adds, exact in any order
    hits = torch.zeros((B, nsamp, s * s), dtype=torch.int32,
                       device=cr_pos.device)
    hits.scatter_add_(-1, idx, valid.to(torch.int32))
    return (hits > 0).view(B, nsamp, s, s)


def linearize_reads(reads_dn: torch.Tensor, nonlin_coeffs: torch.Tensor,
                    full_well_e: float, gain,
                    bias_e=None, n_iter: int = 4) -> torch.Tensor:
    """calwf3 NLINCORR: invert the per-pixel cubic non-linearity.

    The detector compresses the accumulated charge before readout:
    measured = Q * (1 - (c1 q + c2 q^2 + c3 q^3)), q = min(Q, fw)/fw. The
    inversion is the fixed point Q <- m / (1 - p(q(Q))) from Q = m;
    ``n_iter = 4`` lands at float32 roundoff. Pixels at or above the
    saturation ceiling stay at full well.

    Args:
      reads_dn: (..., NR, S, S) raw-DN read stack (time order).
      nonlin_coeffs: (3, S, S) per-pixel cubic planes.
      full_well_e: charge capacity (electrons), a host number
        (``Tables.readout_consts[1]``), so nothing waits for the card.
      gain: e-/DN, a 0-dim tensor or an (S, S) map.
      bias_e: optional bias pedestal in ELECTRONS (scalar or (S, S) plane)
        subtracted before the inversion.

    Returns the linearized stack in ELECTRONS (bias-subtracted).
    """
    reads_dn = reads_dn.to(torch.float32)
    c1, c2, c3 = nonlin_coeffs[0], nonlin_coeffs[1], nonlin_coeffs[2]
    m = reads_dn * gain
    if bias_e is not None:
        m = m - bias_e
    fw = float(np.float32(full_well_e))
    sat_ceiling = fw * (1.0 - ((c3 + c2) + c1))   # measured signal at fw
    out = m
    for _ in range(n_iter):
        q = torch.clamp(out, 0.0, fw) / fw
        out = m / (1.0 - ((c3 * q + c2) * q + c1) * q)
    return torch.where(m >= sat_ceiling, fw, out)


def repair_read_stack(reads_dn: torch.Tensor,
                      good: torch.Tensor) -> torch.Tensor:
    """Rebuild a read stack with corrupted intervals repaired.

    The stack is reassembled from per-interval differences; each corrupted
    difference is replaced by the mean of its clean dispersion-direction
    (column) neighbours in the same interval, else its clean
    cross-dispersion (row) neighbours, else 0, rescaled so that the
    neighbours' clean-interval sum matches the pixel's own (within the
    JAX package's guards).

    Args:
      reads_dn: (..., NR, S, S) reads in time order.
      good: (..., NR-1, S, S) bool, True = interval difference usable.
    Returns the repaired (..., NR, S, S) stack; with all-good masks the
    diffs telescope back to the input.
    """
    diffs = torch.diff(reads_dn, dim=-3)

    def neighbour_mean(axis):
        # non-wrapping nearest-neighbour mean over clean neighbours: roll,
        # then mask out the entries that wrapped around the edge
        n = diffs.shape[axis]
        idx_shape = [1] * diffs.dim()
        idx_shape[axis] = n
        idx = torch.arange(n, device=diffs.device).view(idx_shape)
        ga = torch.roll(good, 1, dims=axis) & (idx > 0)
        gb = torch.roll(good, -1, dims=axis) & (idx < n - 1)
        va = torch.roll(diffs, 1, dims=axis)
        vb = torch.roll(diffs, -1, dims=axis)
        w = ga.to(diffs.dtype) + gb.to(diffs.dtype)
        est = (torch.where(ga, va, 0.0) + torch.where(gb, vb, 0.0)) \
            / torch.clamp_min(w, 1.0)
        return est, w > 0

    est_x, have_x = neighbour_mean(-1)
    est_y, have_y = neighbour_mean(-2)
    est = torch.where(have_x, est_x, torch.where(have_y, est_y, 0.0))

    # shape from the neighbours, amplitude from the pixel's own clean ramp
    # the sums over the read axis (at most 15 terms) run in read order, as
    # elementwise adds: the card rounds as the CPU does, which matters
    # where the ratio below divides two near-cancelling sums (a cosmic ray
    # in the interval a scan lights the pixel)
    goodf = good.to(diffs.dtype)
    own_sum = prefix_sum(diffs * goodf, dim=-3)[..., -1:, :, :]
    nb_sum = prefix_sum(est * goodf, dim=-3)[..., -1:, :, :]
    scale = own_sum / torch.where(nb_sum == 0.0, 1.0, nb_sum)
    scale_ok = (torch.abs(nb_sum) > 0.05 * torch.abs(own_sum) + 1e-3) \
        & (scale > 0.0) & (scale < 8.0)
    est = torch.where(scale_ok, est * scale, est)

    repaired = torch.where(good, diffs, est)
    first = reads_dn[..., :1, :, :]
    return torch.cat([first, first + prefix_sum(repaired, dim=-3)],
                     dim=-3)


def hit_budget(nsamp: int, n_cr: int) -> int:
    """How many of the nsamp * MAX_CR padded hit entries
    :func:`_cr_hit_deltas` keeps: the total over nsamp intervals is
    Poisson(nsamp * lam), lam recovered from the per-interval bound
    MAX_CR = lam + 6 sigma + 4, so mean + 10 sigma + nsamp never drops a
    hit of a correctly sized list. Static shapes only: a Python int."""
    H = nsamp * n_cr
    if nsamp <= 2:
        return H
    u = max((-6.0 + (20.0 + 4.0 * n_cr) ** 0.5) / 2.0, 0.0)
    mean_total = nsamp * u * u
    stat = int(mean_total + 10.0 * max(mean_total, 1.0) ** 0.5 + nsamp) + 1
    return min(H, max(H // 2 + 3 * n_cr, stat))


def _cr_hit_deltas(reads_dn: torch.Tensor, cr_pos: torch.Tensor,
                   cr_count: torch.Tensor):
    """Per-hit repaired-diff deltas, batched over exposures.

    For every (padded) hit, the correction ``delta = est - d_own`` that the
    dense repair would apply to that hit's interval difference, from
    gathers and pairwise site comparisons only (per interval (nsamp,
    MAX_CR, MAX_CR); across intervals (Hb, Hb), Hb = :func:`hit_budget`).

    Args:
      reads_dn: (B, NR, S, S); cr_pos: (B, nsamp, 2, MAX_CR) int32;
      cr_count: (B, nsamp) int32.
    Returns (delta (B, Hb), k_idx (B, Hb), xs (B, Hb)); padded entries
    carry delta = 0.
    """
    B, nr, S, _ = reads_dn.shape
    nsamp, n_cr = cr_pos.shape[1], cr_pos.shape[3]
    H = nsamp * n_cr
    dev, dtype = reads_dn.device, reads_dn.dtype
    k_idx = torch.arange(nsamp, device=dev).repeat_interleave(n_cr
                                                              ).expand(B, H)
    ys = cr_pos[:, :, 0, :].reshape(B, H).long()
    xs = cr_pos[:, :, 1, :].reshape(B, H).long()
    valid_k = torch.arange(n_cr, device=dev) < cr_count[..., None]
    valid = valid_k.reshape(B, H)

    # same-interval comparisons: (B, nsamp, MAX_CR, MAX_CR)
    pid_k = cr_pos[:, :, 0, :].long() * S + cr_pos[:, :, 1, :].long()
    other = valid_k[..., None, :]
    mult = torch.clamp_min(
        ((pid_k[..., :, None] == pid_k[..., None, :]) & other
         ).to(dtype).sum(-1), 1.0).reshape(B, H)
    hit_l = ((pid_k[..., :, None] - 1 == pid_k[..., None, :]) & other
             ).any(-1).reshape(B, H)
    hit_r = ((pid_k[..., :, None] + 1 == pid_k[..., None, :]) & other
             ).any(-1).reshape(B, H)

    flat = reads_dn.reshape(B, nr * S * S)

    def at(k, y, x):
        return torch.gather(flat, 1, (k * S + y) * S + x)

    h_budget = hit_budget(nsamp, n_cr)
    if h_budget < H:
        # Keep the LARGEST corrupted diffs if the valid count ever exceeds
        # the budget (only with an undersized max_cr_per_read). A stable
        # sort, as jnp.argsort's, so ties keep list order.
        d_mag = torch.abs(at(k_idx + 1, ys, xs) - at(k_idx, ys, xs))
        order = torch.argsort(
            torch.where(valid, -d_mag, torch.inf), dim=1, stable=True)
        sel = order[:, :h_budget]
        k_idx, ys, xs, valid, mult, hit_l, hit_r = (
            torch.gather(t, 1, sel)
            for t in (k_idx, ys, xs, valid, mult, hit_l, hit_r))
    valid_f = valid.to(dtype)

    xl = torch.clamp_min(xs - 1, 0)
    xr = torch.clamp_max(xs + 1, S - 1)
    pid = ys * S + xs
    last = nr - 1
    zero, end = torch.zeros_like(k_idx), torch.full_like(k_idx, last)

    def diff_at(x):
        return at(k_idx + 1, ys, x) - at(k_idx, ys, x)

    def total_at(x):                        # reads[-1] - reads[0]
        return at(end, ys, x) - at(zero, ys, x)

    d_own, d_l, d_r = diff_at(xs), diff_at(xl), diff_at(xr)
    wl = (xl != xs) & ~hit_l
    wr = (xr != xs) & ~hit_r
    w = wl.to(dtype) + wr.to(dtype)
    est = (torch.where(wl, d_l, 0.0) + torch.where(wr, d_r, 0.0)) \
        / torch.clamp_min(w, 1.0)

    # clean CDS totals: the total less the pixel's corrupted diffs (each
    # site once), at the hit pixel and both neighbours
    site_bad = valid_f * d_own / mult                        # (B, Hb)

    def bad_at(target):
        return torch.sum(torch.where(
            pid[:, None, :] == target[:, :, None], site_bad[:, None, :],
            0.0), dim=2)

    own_clean = total_at(xs) - bad_at(pid)
    nb_clean = (torch.where(wl, total_at(xl) - bad_at(pid - 1) - d_l, 0.0)
                + torch.where(wr, total_at(xr) - bad_at(pid + 1) - d_r,
                              0.0)) / torch.clamp_min(w, 1.0)
    scale = own_clean / torch.where(nb_clean == 0.0, 1.0, nb_clean)
    scale_ok = (torch.abs(nb_clean) > 0.05 * torch.abs(own_clean) + 1e-3) \
        & (scale > 0.0) & (scale < 8.0)
    est = torch.where(scale_ok, est * scale, est)
    delta = torch.where(valid & (w > 0), est - d_own,
                        torch.where(valid, -d_own, 0.0)) / mult
    return delta, k_idx, xs


def extract_spectra_cr(reads_dn: torch.Tensor, cr_pos: torch.Tensor,
                       cr_count: torch.Tensor,
                       read_times: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Column spectra (B, S) of B exposures with their cosmic-ray hits
    repaired after extraction, in column space.

    Both estimators are linear in the reads, so a hit's repaired-diff
    delta maps to a per-column correction: weight 1 for CDS (last read
    minus read 0), ``T * sum_{j>k} c_j`` for the up-the-ramp slope
    (``read_times`` given; c_j its least-squares coefficients).

    Args:
      reads_dn: (B, NR, S, S); cr_pos: (B, nsamp, 2, MAX_CR) int32;
      cr_count: (B, nsamp) int32; read_times: (NR,) or None.
    """
    S = reads_dn.shape[-1]
    delta, k_idx, xs = _cr_hit_deltas(reads_dn, cr_pos, cr_count)
    if read_times is None:
        base = (reads_dn[:, -1] - reads_dn[:, 0]).sum(dim=-2)
        wgt = delta
    else:
        base = ramp_slope_frame(reads_dn.movedim(1, 0), read_times
                                ).sum(dim=-2)
        t = read_times.to(reads_dn.dtype)
        dt = t - t.mean()
        coef = dt / torch.sum(dt * dt)
        # delta lands on reads k+1..: slope * T changes by delta * g[k]
        g = (t[-1] - t[0]) * torch.flip(
            torch.cumsum(torch.flip(coef, [0]), 0), [0])[1:]   # (nsamp,)
        wgt = delta * g[k_idx]
    cols = torch.arange(S, device=reads_dn.device)
    corr = torch.sum(torch.where(xs[:, :, None] == cols, wgt[:, :, None],
                                 0.0), dim=1)
    return base + corr


def ramp_slope_frame(reads_dn: torch.Tensor,
                     read_times: torch.Tensor) -> torch.Tensor:
    """Per-pixel least-squares up-the-ramp slope x exposure time, over the
    LEADING axis of ``reads_dn`` (NR, ...): a CDS-equivalent accumulated
    frame. The contraction is fp32 with TF32 off (the package sets it at
    import), as the JAX package asks for ``Precision.HIGHEST``."""
    t = read_times.to(reads_dn.dtype)
    dt = t - t.mean()
    denom = torch.sum(dt * dt)
    sbar = reads_dn.mean(dim=0)
    slope = torch.tensordot(dt, reads_dn - sbar[None], dims=1) / denom
    return slope * (t[-1] - t[0])


def repair_read_stack_sparse(reads_dn: torch.Tensor, cr_pos: torch.Tensor,
                             cr_count: torch.Tensor) -> torch.Tensor:
    """The cosmic-ray repair of one exposure at its hit sites only: the
    dense repair's correction (the neighbour-shape estimate rescaled to
    the pixel's own clean amplitude) computed per hit, scatter-added per
    interval and prefix-summed down the ramp. Equal to
    :func:`repair_read_stack` wherever a hit pixel's column neighbours are
    clean in every interval.

    Args:
      reads_dn: (NR, S, S) reads in time order.
      cr_pos: (nsamp, 2, MAX_CR) hit rows/cols; cr_count: (nsamp,).
    """
    nsamp, _, n_cr = cr_pos.shape
    S = reads_dn.shape[-1]
    dev, dtype = reads_dn.device, reads_dn.dtype
    k_idx = torch.arange(nsamp, device=dev).repeat_interleave(n_cr)
    ys = cr_pos[:, 0, :].reshape(-1).long()
    xs = cr_pos[:, 1, :].reshape(-1).long()
    valid = (torch.arange(n_cr, device=dev)[None, :]
             < cr_count[:, None]).reshape(-1)
    valid_f = valid.to(dtype)

    # two hits can land on one pixel in one interval: per-site quantities
    # divide by the multiplicity, so each corrupted site counts once
    counts = torch.zeros((nsamp, S, S), dtype=dtype, device=dev)
    counts.index_put_((k_idx, ys, xs), valid_f, accumulate=True)
    hits = counts > 0
    mult = torch.clamp_min(counts[k_idx, ys, xs], 1.0)

    def diff_at(y, x):
        return reads_dn[k_idx + 1, y, x] - reads_dn[k_idx, y, x]

    d_own = diff_at(ys, xs)
    bad_px = torch.zeros((S, S), dtype=dtype, device=dev)
    bad_px.index_put_((ys, xs), torch.where(valid, d_own, 0.0) / mult,
                      accumulate=True)
    total_clean = (reads_dn[-1] - reads_dn[0]) - bad_px

    xl = torch.clamp_min(xs - 1, 0)
    xr = torch.clamp_max(xs + 1, S - 1)
    wl = (xl != xs) & ~hits[k_idx, ys, xl]
    wr = (xr != xs) & ~hits[k_idx, ys, xr]
    d_l = diff_at(ys, xl)
    d_r = diff_at(ys, xr)
    w = wl.to(dtype) + wr.to(dtype)
    est = (torch.where(wl, d_l, 0.0) + torch.where(wr, d_r, 0.0)) \
        / torch.clamp_min(w, 1.0)
    own_clean = total_clean[ys, xs]
    nb_clean = (torch.where(wl, total_clean[ys, xl] - d_l, 0.0)
                + torch.where(wr, total_clean[ys, xr] - d_r, 0.0)) \
        / torch.clamp_min(w, 1.0)
    scale = own_clean / torch.where(nb_clean == 0.0, 1.0, nb_clean)
    scale_ok = (torch.abs(nb_clean) > 0.05 * torch.abs(own_clean) + 1e-3) \
        & (scale > 0.0) & (scale < 8.0)
    est = torch.where(scale_ok, est * scale, est)
    delta = torch.where(valid & (w > 0), est - d_own,
                        torch.where(valid, -d_own, 0.0)) / mult

    corr = torch.zeros((nsamp, S, S), dtype=dtype, device=dev)
    corr.index_put_((k_idx, ys, xs), delta, accumulate=True)
    return torch.cat([reads_dn[:1], reads_dn[1:] + torch.cumsum(corr, 0)])


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------

def net_frame(reads_dn: torch.Tensor, gain,
              read_times: torch.Tensor | None = None,
              good_diffs: torch.Tensor | None = None) -> torch.Tensor:
    """Accumulated-charge frame in electrons from reads (..., NR, S, S):
    CDS (last minus zeroth read) by default, the up-the-ramp
    least-squares slope with ``read_times``; ``good_diffs`` (..., NR-1, S,
    S) bool repairs the flagged intervals first (repair_read_stack)."""
    if good_diffs is not None:
        reads_dn = repair_read_stack(reads_dn, good_diffs)
    if read_times is None:
        return (reads_dn[..., -1, :, :] - reads_dn[..., 0, :, :]) * gain
    return ramp_slope_frame(reads_dn.movedim(-3, 0), read_times) * gain


def extract_exposure(reads_dn: torch.Tensor, gain,
                     y_window: tuple[int, int],
                     bg_rows: tuple[int, int],
                     read_times: torch.Tensor | None = None,
                     good_diffs: torch.Tensor | None = None) -> torch.Tensor:
    """Net electrons per column (..., S): the net frame less its
    per-column sky (the median of ``bg_rows``), box-summed over
    ``y_window``."""
    net = net_frame(reads_dn, gain, read_times, good_diffs)
    bg = _median(net[..., bg_rows[0]: bg_rows[1], :], -2)
    net = net - bg[..., None, :]
    return net[..., y_window[0]: y_window[1], :].sum(dim=-2)


def spatial_profile(frame_e: torch.Tensor, y_window: tuple[int, int],
                    smooth_x: int = 8,
                    support_frac: float = 0.03) -> torch.Tensor:
    """Normalised cross-dispersion profile P(y, x) for optimal extraction
    from a high-S/N background-subtracted frame (S, S): clipped at zero,
    boxcar-smoothed along the dispersion axis (width 2 smooth_x + 1, edge
    padded, as differences of a cumulative sum), thresholded at
    ``support_frac`` of each column's peak and normalised per column over
    the window rows; a column without signal gets a flat profile."""
    win = torch.clamp_min(frame_e[y_window[0]: y_window[1], :], 0.0)
    w_rows = win.shape[0]
    if smooth_x > 0:
        k = 2 * smooth_x + 1
        pad = torch.cat([win[:, :1].expand(-1, smooth_x), win,
                         win[:, -1:].expand(-1, smooth_x)], dim=1)
        c = prefix_sum(pad, dim=1)
        c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
        win = (c[:, k:] - c[:, :-k]) / k
    win = torch.where(win > support_frac * torch.amax(win, 0, keepdim=True),
                      win, 0.0)
    colsum = torch.sum(win, dim=0, keepdim=True)
    ok = colsum > 1e-6
    return torch.where(ok, win / torch.where(ok, colsum, 1.0), 1.0 / w_rows)


def optimal_extract(net_e: torch.Tensor, profile: torch.Tensor,
                    y_window: tuple[int, int], var_floor_e2) -> torch.Tensor:
    """Horne (1986) profile-weighted extraction of net frames (..., S, S):
    f(x) = sum_y P D / V / sum_y P^2 / V with the model variance
    V = max(P f_box, 0) + ``var_floor_e2`` (the estimator's read-noise
    variance, read_noise_var_e2)."""
    d = net_e[..., y_window[0]: y_window[1], :]
    f_box = torch.sum(d, dim=-2, keepdim=True)
    v = torch.clamp_min(profile * f_box, 0.0) + var_floor_e2
    num = torch.sum(profile * d / v, dim=-2)
    den = torch.sum(profile * profile / v, dim=-2)
    return num / torch.clamp_min(den, 1e-12)


def read_noise_var_e2(read_noise_e: float, n_reads: int,
                      ramp: bool = False) -> float:
    """Read-noise variance (e-^2) of the accumulated-charge estimators:
    2 rn^2 for CDS, rn^2 12 (NR-1) / (NR (NR+1)) for the up-the-ramp
    slope."""
    if ramp:
        return float(read_noise_e) ** 2 * 12.0 * (n_reads - 1) \
            / (n_reads * (n_reads + 1))
    return 2.0 * float(read_noise_e) ** 2


# ---------------------------------------------------------------------------
# Dispersion-direction drifts
# ---------------------------------------------------------------------------

def _catmull_rom(f: torch.Tensor, q: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cubic Catmull-Rom sampling of ``f`` (..., n), a unit grid, at
    positions ``q`` (..., m); ``f``'s leading axes broadcast against
    ``q``'s. Returns (value, d value / d q), constant with zero slope
    beyond the grid."""
    n = f.shape[-1]
    f = f.expand(*q.shape[:-1], n)
    i = torch.clamp(torch.floor(q).long(), 0, n - 2)
    t = q - i.to(q.dtype)

    def at(j):
        return torch.gather(f, -1, torch.clamp(j, 0, n - 1))

    fm1, f0, f1, f2 = at(i - 1), at(i), at(i + 1), at(i + 2)
    b = f1 - fm1
    c = 2.0 * fm1 - 5.0 * f0 + 4.0 * f1 - f2
    d = -fm1 + 3.0 * f0 - 3.0 * f1 + f2
    val = 0.5 * (2.0 * f0 + (b + (c + d * t) * t) * t)
    dval = 0.5 * (b + (2.0 * c + 3.0 * d * t) * t)
    lo, hi = q < 0.0, q > n - 1.0
    val = torch.where(lo, f[..., :1], torch.where(hi, f[..., -1:], val))
    dval = torch.where(lo | hi, 0.0, dval)
    return val, dval


def spectral_shifts(spectra: torch.Tensor, x_window: tuple[int, int],
                    n_iter: int = 3) -> torch.Tensor:
    """Per-exposure sub-pixel dispersion-direction drifts (px) of spectra
    (n_exp, S): Gauss-Newton fits of s_i(x) = a_i ref(x - delta_i) against
    the visit-mean spectrum, cubic resampling with its analytic
    derivative, the amplitude profiled out each step, interior columns
    only (2-px margin). s_i appears shifted redward by delta_i."""
    x0, x1 = x_window
    win = spectra[:, x0:x1]                                  # (n_exp, W)
    w = win.shape[1]
    xs = torch.arange(w, dtype=spectra.dtype, device=spectra.device)
    ref = torch.mean(win / torch.mean(win, dim=1, keepdim=True), dim=0)
    m = ((xs >= 2) & (xs < w - 2)).to(spectra.dtype)[None, :]
    delta = torch.zeros(win.shape[0], dtype=spectra.dtype,
                        device=spectra.device)
    for _ in range(n_iter):
        r, dr = _catmull_rom(ref, xs[None, :] - delta[:, None])
        a = torch.sum(win * r * m, dim=1) / torch.clamp_min(
            torch.sum(r * r * m, dim=1), 1e-12)
        e = win - a[:, None] * r
        jac = -a[:, None] * dr
        num = torch.sum(e * jac * m, dim=1)
        den = torch.clamp_min(torch.sum(jac * jac * m, dim=1), 1e-12)
        delta = delta + num / den
    return delta


def align_spectra(spectra: torch.Tensor, shifts: torch.Tensor
                  ) -> torch.Tensor:
    """Undo per-exposure drifts: s_i sampled at x + delta_i (cubic).
    For diagnostics; light curves use shift_detrend."""
    s = spectra.shape[-1]
    xs = torch.arange(s, dtype=spectra.dtype, device=spectra.device)
    return _catmull_rom(spectra, xs[None, :] + shifts[:, None])[0]


def drift_binned_flux(spectra: torch.Tensor, shifts: torch.Tensor,
                      edges: torch.Tensor) -> torch.Tensor:
    """Channel fluxes (n_exp, len(edges) - 1) with bin edges that follow
    each exposure's drift: differences of the cumulative column flux,
    cubic-resampled at edges + delta_i. With zero shifts and integer edges
    it reproduces the plain partial sums."""
    cum = torch.cat([torch.zeros_like(spectra[:, :1]),
                     prefix_sum(spectra, dim=1)], dim=1)     # (n_exp, S+1)
    q = edges.to(spectra.dtype)[None, :] + shifts[:, None]
    at = _catmull_rom(cum, q)[0]
    return at[:, 1:] - at[:, :-1]


def dispersion_centroid(spectra: torch.Tensor,
                        x_window: tuple[int, int]) -> torch.Tensor:
    """Flux-weighted column centroid over the window (..., ): the drift
    regressor for shift_detrend. Clean it of the transit first
    (clean_drift_regressor) on a transit or eclipse visit."""
    x0, x1 = x_window
    win = spectra[..., x0:x1]
    xs = torch.arange(x0, x1, dtype=spectra.dtype, device=spectra.device)
    return torch.sum(win * xs, dim=-1) / torch.clamp_min(
        torch.sum(win, dim=-1), 1e-12)


def drift_regressor(spectra: torch.Tensor, x_window: tuple[int, int],
                    white_flux: torch.Tensor,
                    oot: torch.Tensor) -> torch.Tensor:
    """The model-free transit-immune drift regressor: the dispersion
    centroid with the white dip t = max(0, 1 - white / mean_oot(white)),
    zero out of transit, least-squares projected out."""
    reg = dispersion_centroid(spectra, x_window)
    w = oot.to(reg.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    wbar = torch.clamp_min(torch.sum(white_flux * w) / n, 1e-12)
    t = torch.clamp_min(1.0 - white_flux / wbar, 0.0) * (1.0 - w)
    tc = t - torch.mean(t)
    rc = reg - torch.mean(reg)
    coef = torch.sum(rc * tc) / torch.clamp_min(torch.sum(tc * tc), 1e-12)
    return reg - coef * tc


def _time_axis(exp_mid_s: torch.Tensor) -> torch.Tensor:
    """The visit's time mapped onto [-1, 1]."""
    return ((exp_mid_s - exp_mid_s[0])
            / torch.clamp_min(exp_mid_s[-1] - exp_mid_s[0], 1e-9)
            * 2.0 - 1.0)


def transit_drift_basis(exp_mid_s: torch.Tensor, orbit: OrbitParams,
                        ld: torch.Tensor, rp0, n_quad: int = 32
                        ) -> torch.Tensor:
    """Model basis (n_exp, 4) spanning a chromatic transit's centroid
    excursion: the dip at ``rp0``, its derivative in rp (forward-mode
    autodiff through the occultation integral), and both times the visit
    time on [-1, 1]. Combine with clean_drift_regressor."""
    z, in_front = projected_separation(exp_mid_s, orbit)

    def lc(rp):
        f = transit_depth_curve(z, rp, ld, n_quad)
        return 1.0 - (1.0 - f) * in_front

    rp = torch.as_tensor(rp0, dtype=torch.float32, device=exp_mid_s.device)
    lc0, dlc = torch.func.jvp(lc, (rp,), (torch.ones_like(rp),))
    dip = 1.0 - lc0
    t = _time_axis(exp_mid_s)
    return torch.stack([dip, dlc, dip * t, dlc * t], dim=1)


def white_drift_basis(white_flux: torch.Tensor, oot: torch.Tensor,
                      exp_mid_s: torch.Tensor) -> torch.Tensor:
    """Data-driven contamination basis (n_exp, 2) when no transit model is
    known: [d, d t] with d = 1 - white / mean_oot(white)."""
    w = oot.to(white_flux.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    wbar = torch.clamp_min(torch.sum(white_flux * w) / n, 1e-12)
    d = 1.0 - white_flux / wbar
    t = _time_axis(exp_mid_s)
    return torch.stack([d, d * t], dim=1)


def clean_drift_regressor(cen: torch.Tensor, basis: torch.Tensor,
                          exp_mid_s: torch.Tensor,
                          poly_deg: int = 2) -> torch.Tensor:
    """Remove a transit-shaped contamination from a drift regressor: fit
    cen = B gamma + smooth(t) through the time-polynomial-orthogonalised
    instrument Bt = (I - P_poly) B, gamma = (Bt^T B)^-1 Bt^T cen, and
    return cen - B gamma. Basis columns are normalised before the solve.
    fp32 contractions with TF32 off; ``solve_ex`` makes no host sync.

    The regressor's mean is taken off before the solve and put back
    after: the same gamma in real arithmetic (the polynomial spans the
    constant, so Bt^T 1 = 0), but Bt^T cen no longer cancels a ~30 px
    centroid level in float32. The near-singular solve amplifies that
    cancellation: without it the port's and the JAX package's regressors
    differed by 1e-4 px and their channel curves by 1.8e-5."""
    level = cen.mean()
    cen = cen - level
    t = _time_axis(exp_mid_s)
    T = torch.stack([t ** k for k in range(poly_deg + 1)], dim=1)
    B = basis / torch.clamp_min(torch.linalg.norm(basis, dim=0),
                                1e-12)[None, :]
    Bt = B - T @ torch.linalg.solve_ex(T.T @ T, T.T @ B)[0]
    eye = torch.eye(B.shape[1], dtype=B.dtype, device=B.device)
    gam = torch.linalg.solve_ex(Bt.T @ B + 1e-9 * eye,
                                (Bt.T @ cen)[:, None])[0][:, 0]
    return cen - B @ gam + level


def shift_detrend(flux: torch.Tensor, shifts: torch.Tensor,
                  oot: torch.Tensor) -> torch.Tensor:
    """Divide the linear drift response out of binned light curves
    (n_exp,) or (n_exp, n_chan): F_ij = F_j (1 + c_j delta_i), c_j fitted
    by least squares on the out-of-transit epochs only."""
    squeeze = flux.dim() == 1
    f = flux[:, None] if squeeze else flux
    w = oot.to(f.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    d = (shifts - torch.sum(shifts * w) / n)[:, None]
    fbar = torch.sum(f * w[:, None], dim=0) / n               # (n_chan,)
    var = torch.clamp_min(torch.sum(w[:, None] * d * d, dim=0), 1e-9)
    b = torch.sum(w[:, None] * d * (f - fbar), dim=0) / var
    corr = f * (fbar / (fbar + b * d))
    return corr[:, 0] if squeeze else corr


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

# Projected separation beyond which an epoch counts as out-of-transit
# baseline (planet radii are <= 0.2 R_star for every supported system).
OOT_Z = 1.25


def out_of_transit_mask(exp_mid_s: torch.Tensor,
                        orbit: OrbitParams) -> torch.Tensor:
    """Boolean out-of-transit mask: the one definition of 'baseline'."""
    z, in_front = projected_separation(exp_mid_s, orbit)
    return (z > OOT_Z) | (in_front < 0.5)


def scan_direction_factor(white: torch.Tensor, oot: torch.Tensor,
                          reverse: torch.Tensor) -> torch.Tensor:
    """Per-exposure divisor (..., n_exp) removing the forward/reverse scan
    offset: reverse exposures are scaled by the ratio of the two
    directions' out-of-transit means; 1 when either direction has fewer
    than 2 out-of-transit exposures.

    Args:
      white: (..., n_exp) white flux; oot, reverse: (n_exp,) masks
        (bool or float), reverse True on reverse-scan exposures.
    """
    w = torch.as_tensor(white, dtype=torch.float32)
    o = torch.as_tensor(oot, device=w.device).to(torch.float32)
    r = torch.as_tensor(reverse, device=w.device).to(torch.float32)
    n_f = torch.sum(o * (1.0 - r))
    n_r = torch.sum(o * r)
    m_f = torch.sum(w * o * (1.0 - r), dim=-1) / torch.clamp_min(n_f, 1.0)
    m_r = torch.sum(w * o * r, dim=-1) / torch.clamp_min(n_r, 1.0)
    ok = (n_f >= 2.0) & (n_r >= 2.0) & (m_f > 0.0)
    fac = torch.where(ok, m_r / torch.clamp_min(m_f, 1e-30), 1.0)
    return torch.where(r > 0.0, fac[..., None], 1.0)


def amp_offset_correct(nets: torch.Tensor, quad_map: torch.Tensor,
                       y_window: tuple[int, int],
                       x_window: tuple[int, int]) -> torch.Tensor:
    """Per-exposure per-amplifier additive-offset removal for subarrays
    without reference pixels: each quadrant's offset is the median of its
    pixels outside the ``y_window`` x ``x_window`` source box (0 where
    fewer than 16 remain), subtracted from the quadrant.

    Args:
      nets: (n_exp, S, S) background-subtracted net frames.
      quad_map: (S, S) int quadrant index (calibration.quadrant_map).
    """
    S = nets.shape[-1]
    quad_map = quad_map.to(nets.device).long()
    src = torch.zeros((S, S), dtype=torch.bool, device=nets.device)
    src[y_window[0]: y_window[1], x_window[0]: x_window[1]] = True
    offs = []
    for q in range(4):
        sel = (quad_map == q) & ~src
        med = _median(torch.where(sel, nets, math.nan).flatten(-2), -1,
                      nan=True)
        offs.append(torch.where(sel.sum() >= 16, med, 0.0))
    offs = torch.stack(offs, dim=-1)                          # (n_exp, 4)
    return nets - offs[..., quad_map]


# ---------------------------------------------------------------------------
# A visit's light curves
# ---------------------------------------------------------------------------

def _oot_normalise(flux: torch.Tensor, oot: torch.Tensor,
                   channels: bool = False) -> torch.Tensor:
    """Divide ``flux`` by its out-of-transit mean over the exposure axis:
    the last axis of a white curve (..., n_exp), the one before it of
    channel curves (..., n_exp, n_chan) (``channels``)."""
    o = oot.to(flux.dtype)
    if channels:
        o = o[:, None]
    base = torch.sum(flux * o, dim=-2 if channels else -1, keepdim=True) \
        / torch.clamp_min(torch.sum(oot.to(flux.dtype)), 1.0)
    return flux / base


def _channel_flux(spectra: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """Channel sums (..., n_chan) of spectra (..., S) as differences of the
    cumulative column flux at the edges (the JAX package's recipe, so
    both packages round alike)."""
    cum = torch.cat([torch.zeros_like(spectra[..., :1]),
                     prefix_sum(spectra, dim=-1)], dim=-1)
    e = torch.as_tensor(edges, device=spectra.device)
    return cum[..., e[1:]] - cum[..., e[:-1]]


def reduce_visit(reads_dn: torch.Tensor, gain,
                 exp_mid_s: torch.Tensor, orbit: OrbitParams,
                 *, y_window: tuple[int, int], x_window: tuple[int, int],
                 bg_rows: tuple[int, int] = (0, 16),
                 n_chan: int = 16,
                 read_times: torch.Tensor | None = None,
                 good_diffs: torch.Tensor | None = None,
                 optimal: bool = False,
                 read_noise_e: float = 12.0,
                 align: bool = False,
                 ld: torch.Tensor | None = None,
                 rp0=0.155,
                 scan_dir: torch.Tensor | None = None,
                 quad_map: torch.Tensor | None = None) -> ReducedVisit:
    """White and channel light curves from a visit's raw reads, every
    exposure in one tensor program.

    Args:
      reads_dn: (n_exp, NR, S, S) raw reads in time order.
      exp_mid_s: (n_exp,) exposure mid-times on the orbit's clock.
      y_window: extraction rows; x_window: dispersion columns carrying
        signal; bg_rows: sky rows (per-column median); n_chan: channels
        across x_window.
      read_times: (NR,) sample times: the up-the-ramp slope instead of CDS.
      good_diffs: (n_exp, NR-1, S, S) bool interval masks (True = usable)
        from ~cr_bad_diff_masks / good_diff_masks_from_dq: the DQ-aware
        repair.
      optimal: Horne extraction with the visit-mean frame's profile and
        the estimator's read-noise floor (``read_noise_e``).
      align: fit per-exposure drifts (``x_shifts``), detrend the curves
        against a transit-cleaned centroid (the model basis with ``ld``
        and ``rp0``, else the white dip), and realign the spectra.
      scan_dir: (n_exp,) reverse-scan mask: each direction normalised by
        its own out-of-transit baseline first.
      quad_map: (S, S) amplifier-quadrant map: per-exposure per-amplifier
        offset removal (amp_offset_correct).
    """
    net = net_frame(reads_dn, gain, read_times, good_diffs)  # (n_exp, S, S)
    bg = _median(net[..., bg_rows[0]: bg_rows[1], :], -2)
    nets = net - bg[..., None, :]
    if quad_map is not None:
        nets = amp_offset_correct(nets, quad_map, y_window, x_window)
    if optimal:
        prof = spatial_profile(torch.mean(nets, dim=0), y_window)
        floor = read_noise_var_e2(read_noise_e, reads_dn.shape[1],
                                  ramp=read_times is not None)
        spectra = optimal_extract(nets, prof, y_window, floor)
    else:
        spectra = nets[:, y_window[0]: y_window[1], :].sum(dim=1)

    oot = out_of_transit_mask(exp_mid_s, orbit)
    if scan_dir is not None:
        corr = scan_direction_factor(
            spectra[:, x_window[0]: x_window[1]].sum(dim=1), oot, scan_dir)
        spectra = spectra / corr[:, None]

    if align:
        shifts = spectral_shifts(spectra, x_window)
    else:
        shifts = torch.zeros(spectra.shape[0], dtype=spectra.dtype,
                             device=spectra.device)

    edges = _channel_edges(x_window, n_chan)
    cols = torch.as_tensor(np.stack([edges[:-1], edges[1:]], axis=1),
                           dtype=torch.int32, device=spectra.device)
    white_flux = spectra[:, x_window[0]: x_window[1]].sum(dim=1)
    chan_flux = _channel_flux(spectra, edges)                 # (n_exp, n_chan)
    if align:
        if ld is not None:
            basis = transit_drift_basis(exp_mid_s, orbit, ld, rp0)
        else:
            basis = white_drift_basis(white_flux, oot, exp_mid_s)
        reg = clean_drift_regressor(
            dispersion_centroid(spectra, x_window), basis, exp_mid_s)
        white_flux = shift_detrend(white_flux, reg, oot)
        chan_flux = shift_detrend(chan_flux, reg, oot)
    white = _oot_normalise(white_flux, oot)
    chan = _oot_normalise(chan_flux, oot, channels=True)

    spectra_out = align_spectra(spectra, shifts) if align else spectra
    return ReducedVisit(spectra_e=spectra_out, white_lc=white,
                        channel_lc=chan, channel_cols=cols, x_shifts=shifts)


# ---------------------------------------------------------------------------
# Depth fits
# ---------------------------------------------------------------------------

def _beta_red(resid: torch.Tensor, w: torch.Tensor,
              n_bin: int) -> torch.Tensor:
    """Pont et al. (2006) time-binning red-noise factor of residuals
    (..., n) in time order: the binned scatter (bins of ``n_bin``) over
    its white-noise expectation, floored at 1. Weights ``w`` (n,)."""
    n = resid.shape[-1]
    m = n // n_bin
    r = (resid * w)[..., : m * n_bin].reshape(resid.shape[:-1] + (m, n_bin))
    wb = w[: m * n_bin].reshape(m, n_bin)
    nb = torch.clamp_min(wb.sum(dim=-1), 1.0)                 # (m,)
    bmean = r.sum(dim=-1) / nb
    mu = bmean.mean(dim=-1, keepdim=True)
    var_binned = torch.sum((bmean - mu) ** 2, dim=-1) / max(m - 1, 1)
    sigma1_sq = (torch.sum(w * resid ** 2, dim=-1)
                 / torch.clamp_min(torch.sum(w) - 1.0, 1.0))
    expect = sigma1_sq / torch.clamp_min(nb.mean(), 1.0)
    return torch.sqrt(torch.clamp_min(
        var_binned / torch.clamp_min(expect, 1e-30), 1.0))


def fit_depths(channel_lc: torch.Tensor, exp_mid_s: torch.Tensor,
               orbit: OrbitParams, ld, rp_init,
               n_quad: int = 32, n_newton: int = 12,
               weights: torch.Tensor | None = None,
               baseline_var: bool = True,
               red_noise: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel Rp/Rs by Newton steps on the chi^2 of the transit model.

    Each channel's chi^2 depends on its own rp only, so the Hessian is
    diagonal: one ``autograd.grad`` of the summed chi^2 gives every
    channel's gradient, a second of the gradients' sum every channel's
    curvature, and one forward-mode ``jvp`` with a tangent of ones the
    model's derivative. The launches do not grow with the channels or the
    realisations, and the steps make no host sync.

    Args:
      channel_lc: (..., n_exp, n_chan) normalised light curves; leading
        axes (realisations) are fitted together.
      ld: shared (4,) Claret coefficients or per-channel (n_chan, 4).
      rp_init: a scalar start.
      weights: optional (n_exp,) exposure weights shared by the channels.
      baseline_var: add the out-of-transit normalisation variance
        (drp/deps = 2 sum(w m' lc) / h, var(eps) = noise_var / N_oot).
      red_noise: scale sigma by the Pont beta of the residuals (bins of
        n_exp // 8, at least 2).

    Returns (rp_hat, rp_sigma), each (..., n_chan).
    """
    with span("fit.depths"):
        lc = channel_lc.to(torch.float32)
        dev = lc.device
        n_exp, n_chan = lc.shape[-2:]
        z, in_front = projected_separation(exp_mid_s, orbit)
        zc, fc = z[:, None], in_front[:, None]
        ld = torch.as_tensor(ld, dtype=torch.float32, device=dev)
        ld_chan = (ld if ld.dim() == 2 else ld[None, :]).expand(n_chan, 4)
        w = (torch.ones(n_exp, dtype=torch.float32, device=dev)
             if weights is None
             else torch.as_tensor(weights, dtype=torch.float32, device=dev))
        wc = w[:, None]
        oot_f = out_of_transit_mask(exp_mid_s, orbit).to(torch.float32)

        def model(rp):          # (..., n_chan) -> (..., n_exp, n_chan)
            f = transit_depth_curve(zc, rp[..., None, :], ld_chan, n_quad)
            return 1.0 - (1.0 - f) * fc

        def grad_and_curvature(rp):
            with torch.enable_grad():
                r = rp.detach().requires_grad_(True)
                chi2 = torch.sum(wc * (model(r) - lc) ** 2, dim=-2)
                g, = torch.autograd.grad(chi2.sum(), r, create_graph=True)
                h, = torch.autograd.grad(g.sum(), r)
            return g.detach(), h

        rp = torch.as_tensor(rp_init, dtype=torch.float32, device=dev).expand(
            lc.shape[:-2] + (n_chan,)).clone()
        for _ in range(n_newton):
            g, h = grad_and_curvature(rp)
            step = g / torch.where(torch.abs(h) > 1e-12, h, 1e-12)
            rp = torch.clamp(rp - step, 0.01, 0.5)
        resid = model(rp).detach() - lc
        noise_var = (torch.sum(wc * resid ** 2, dim=-2)
                     / torch.clamp_min(torch.sum(w) - 1.0, 1.0))
        h = torch.clamp_min(grad_and_curvature(rp)[1], 1e-12)
        var_rp = 2.0 * noise_var / h
        if baseline_var:
            _, mprime = torch.func.jvp(model, (rp,), (torch.ones_like(rp),))
            drp_deps = 2.0 * torch.sum(wc * mprime * lc, dim=-2) / h
            n_oot = torch.clamp_min(torch.sum(w * oot_f), 1.0)
            var_rp = var_rp + drp_deps ** 2 * noise_var / n_oot
        sigma = torch.sqrt(var_rp)
        if red_noise:
            sigma = sigma * _beta_red(resid.transpose(-1, -2), w,
                                      max(n_exp // 8, 2))
        return rp, sigma


def common_mode_correct(white_lc: torch.Tensor, channel_lc: torch.Tensor,
                        exp_mid_s: torch.Tensor, orbit: OrbitParams,
                        ld, rp_init, n_quad: int = 32, n_newton: int = 12,
                        return_white_sigma: bool = False):
    """Divide white-light systematics out of the channel curves: the ratio
    of the white curve (..., n_exp) to its fitted transit model is a
    per-exposure common-mode template. Returns the corrected channel
    curves (..., n_exp, n_chan); with ``return_white_sigma`` also the
    white fit's depth sigma (...), the common-mode error every channel
    depth inherits."""
    rp_white, sig_white = fit_depths(white_lc[..., None], exp_mid_s, orbit,
                                     ld, rp_init, n_quad, n_newton)
    z, in_front = projected_separation(exp_mid_s, orbit)
    ld = torch.as_tensor(ld, dtype=torch.float32, device=white_lc.device)
    f = transit_depth_curve(z, rp_white, ld, n_quad)          # (..., n_exp)
    white_model = 1.0 - (1.0 - f) * in_front
    template = white_lc / white_model
    corrected = channel_lc / template[..., None]
    if return_white_sigma:
        return corrected, sig_white[..., 0]
    return corrected


def divide_white_fit_depths(white_lc: torch.Tensor, channel_lc: torch.Tensor,
                            exp_mid_s: torch.Tensor, orbit: OrbitParams,
                            ld, rp_init, n_quad: int = 32,
                            n_newton: int = 12,
                            weights: torch.Tensor | None = None,
                            return_components: bool = False
                            ) -> tuple[torch.Tensor, ...]:
    """Divide-white, then the per-channel depth fit, with the common-mode
    error of the white fit propagated: the depths' covariance is
    diag(sigma_rel^2) + sigma_common^2 ones((n, n)).

    Returns (rp_hat, rp_sigma), rp_sigma = sqrt(sigma_rel^2 +
    sigma_common^2); with ``return_components``, (rp_hat, rp_sigma,
    sigma_rel, sigma_common), sigma_common one number per curve set.
    """
    corrected, sig_white = common_mode_correct(
        white_lc, channel_lc, exp_mid_s, orbit, ld, rp_init, n_quad,
        n_newton, return_white_sigma=True)
    rp, sig = fit_depths(corrected, exp_mid_s, orbit, ld, rp_init,
                         n_quad, n_newton, weights=weights)
    total = torch.sqrt(sig ** 2 + sig_white[..., None] ** 2)
    if return_components:
        return rp, total, sig, sig_white
    return rp, total


def spectra_to_depths(spectra_e: torch.Tensor, exp_mid_s: torch.Tensor,
                      orbit: OrbitParams, ld, rp_init, *,
                      x_window: tuple[int, int], n_chan: int = 8,
                      divide_white: bool = True,
                      subtract_bg: bool = False, n_quad: int = 32,
                      n_newton: int = 12,
                      scan_dir: torch.Tensor | None = None,
                      sigma_components: bool = False
                      ) -> tuple[torch.Tensor, ...]:
    """Extracted spectra -> fitted channel depths, every realisation in one
    tensor program: (mc, n_exp, S) gives (mc, n_chan) depths and sigmas,
    one visit (n_exp, S) gives (n_chan,).

    Channels are binned over ``x_window`` from the cumulative column
    flux, normalised by their out-of-transit mean, divided by the white
    curve's systematics template (``divide_white``) and fitted.
    ``subtract_bg``: remove each exposure's sky, the median of the columns
    outside ``x_window``, from the white and channel fluxes (the
    ensemble's spectra are full-frame column sums). ``scan_dir``: (n_exp,)
    reverse-scan mask, each direction normalised by its own baseline.
    ``sigma_components``: also return (sigma_rel, sigma_common); without
    divide_white sigma_rel is the total and sigma_common 0.
    """
    sp = torch.as_tensor(spectra_e).to(torch.float32)
    squeeze = sp.dim() == 2
    if squeeze:
        sp = sp[None]
    t = torch.as_tensor(exp_mid_s, device=sp.device).to(torch.float32)
    oot = out_of_transit_mask(t, orbit).to(torch.float32)
    edges = _channel_edges(x_window, n_chan)
    S = sp.shape[-1]
    widths = torch.as_tensor((edges[1:] - edges[:-1]).astype(np.float32),
                             device=sp.device)
    has_outside = x_window[0] > 0 or x_window[1] < S

    white = sp[..., x_window[0]: x_window[1]].sum(dim=-1)    # (mc, n_exp)
    chan = _channel_flux(sp, edges)                  # (mc, n_exp, n_chan)
    if subtract_bg and has_outside:
        s_out = torch.cat([sp[..., : x_window[0]], sp[..., x_window[1]:]],
                          dim=-1)
        bg_col = _median(s_out, -1)                           # (mc, n_exp)
        white = white - (x_window[1] - x_window[0]) * bg_col
        chan = chan - bg_col[..., None] * widths
    if scan_dir is not None:
        corr = scan_direction_factor(white, oot, scan_dir)
        white = white / corr
        chan = chan / corr[..., None]
    white = _oot_normalise(white, oot)
    chan = _oot_normalise(chan, oot, channels=True)
    if divide_white:
        out = divide_white_fit_depths(white, chan, t, orbit, ld, rp_init,
                                      n_quad, n_newton,
                                      return_components=sigma_components)
    else:
        rp, sig = fit_depths(chan, t, orbit, ld, rp_init, n_quad, n_newton)
        out = ((rp, sig, sig, torch.zeros(rp.shape[:-1], device=rp.device))
               if sigma_components else (rp, sig))
    if squeeze:
        out = tuple(o[0] for o in out)
    return out


def constrained_mask(depth, sigma, *, sigma_floor: float = 0.05,
                     bounds: tuple[float, float] | None = (0.0105, 0.495)):
    """Per-channel flag of the depths that carry information: False where
    the depth or sigma is not finite, sigma >= ``sigma_floor``, or the
    depth sits within ``bounds`` of fit_depths' clip range [0.01, 0.5]
    (None for unclipped fitters). Takes and returns NumPy arrays or
    tensors alike."""
    lib = torch if isinstance(depth, torch.Tensor) else np
    ok = lib.isfinite(depth) & lib.isfinite(sigma) & (sigma < sigma_floor)
    if bounds is not None:
        ok = ok & (depth > bounds[0]) & (depth < bounds[1])
    return ok


# ---------------------------------------------------------------------------
# Background and white-light systematics fits
# ---------------------------------------------------------------------------

def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its derivative: ``minimum(maximum(x, lo), hi)``
    splits a tie at either bound, 1/2 to each side, where ``torch.clamp``
    gives 1. The fits differentiate through these clips."""
    # filled on the device: a tensor made from a host scalar would be a
    # copy the host waits for
    lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def fit_sky_model(nets_e: torch.Tensor, comps: torch.Tensor,
                  sky_mask: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-exposure least-squares fit of sky-component weights on the
    sky-only pixels (the Iraclis/aXe background), every exposure in one
    batched solve: each exposure's background is a weighted sum of
    component frames, fitted off the trace and subtracted over the whole
    frame.

    Args:
      nets_e: (n_exp, S, S) background-inclusive net frames.
      comps: (K, S, S) component patterns.
      sky_mask: (S, S) 1 = sky-only pixel, 0 = trace or contaminated.

    Returns (weights (n_exp, K), model (n_exp, S, S)). One robust refit
    drops the pixels whose first residual lies more than 5 x the masked
    mean absolute deviation from the masked mean residual (the JAX
    package's "MAD", centred on a mean, not a median). fp32 normal
    equations with TF32 off, a relative Tikhonov floor, ``solve_ex``.
    """
    y = nets_e.to(torch.float32)
    n_exp, S, _ = y.shape
    dev = y.device
    A = torch.as_tensor(comps, dtype=torch.float32, device=dev)
    A = A.reshape(A.shape[0], -1)                                # (K, P)
    m0 = torch.as_tensor(sky_mask, dtype=torch.float32,
                         device=dev).reshape(-1)                 # (P,)
    yf = y.reshape(n_exp, -1)                                    # (n_exp, P)
    eye = torch.eye(A.shape[0], dtype=torch.float32, device=dev)

    def solve(m):                       # m: (P,) shared or (n_exp, P)
        Am = A * m[..., None, :]
        G = Am @ A.T                                             # (..., K, K)
        b = torch.einsum("kp,ep->ek" if m.dim() == 1 else "ekp,ep->ek",
                         Am, yf)
        G = G + 1e-6 * torch.diag_embed(torch.diagonal(
            G, dim1=-2, dim2=-1)) + 1e-12 * eye
        return torch.linalg.solve_ex(G, b[..., None])[0][..., 0]

    w = solve(m0)
    r = yf - w @ A
    n = torch.clamp_min(torch.sum(m0), 1.0)
    med = torch.sum(r * m0, dim=-1, keepdim=True) / n
    mad = torch.sum(torch.abs(r - med) * m0, dim=-1, keepdim=True) / n
    m1 = m0 * (torch.abs(r - med) < 5.0 * torch.clamp_min(mad, 1e-3))
    w = solve(m1)
    return w, (w @ A).reshape(n_exp, S, S)


def fit_eclipse_depths(channel_lc: torch.Tensor, exp_mid_s: torch.Tensor,
                       orbit: OrbitParams, rp_over_rs,
                       weights: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel eclipse depth Fp/Fs: F = c (1 + fp vis(t)) is linear in
    (c, c fp), so each channel is a 2x2 weighted least squares on the
    uniform-disk visibility at the SCALAR geometric radius
    ``rp_over_rs``. In-transit epochs are weighted out; ``weights``
    (n_exp,) (RampFit.weights) multiplies in. Explicit float32 sums, as in
    the JAX package.

    Args:
      channel_lc: (n_exp, n_chan) curves normalised to any baseline.
    Returns (fp_hat (n_chan,), fp_sigma (n_chan,)), sigma from the
    residual scatter and the normal equations' covariance.
    """
    lc = channel_lc.to(torch.float32)
    z, in_front = projected_separation(exp_mid_s, orbit)
    rp = torch.as_tensor(rp_over_rs, dtype=torch.float32, device=lc.device)
    vis = eclipse_visibility(z, in_front, rp)
    w = out_of_transit_mask(exp_mid_s, orbit).to(lc.dtype)
    if weights is not None:
        w = w * torch.as_tensor(weights, dtype=lc.dtype, device=lc.device)
    n = torch.sum(w)
    s1 = torch.sum(w * vis)
    s2 = torch.sum(w * vis * vis)
    y0 = torch.sum(w[:, None] * lc, dim=0)                      # (n_chan,)
    y1 = torch.sum((w * vis)[:, None] * lc, dim=0)
    det = n * s2 - s1 * s1
    a0 = (s2 * y0 - s1 * y1) / det
    a1 = (n * y1 - s1 * y0) / det
    fp = a1 / a0
    model = a0[None, :] + a1[None, :] * vis[:, None]
    resid = (lc - model) * w[:, None]
    noise_var = torch.sum(resid ** 2, dim=0) / torch.clamp_min(n - 2.0, 1.0)
    cov00 = s2 / det
    cov11 = n / det
    cov01 = -s1 / det
    var_fp = noise_var * (cov11 / a0 ** 2
                          + cov00 * (a1 / a0 ** 2) ** 2
                          - 2.0 * cov01 * a1 / a0 ** 3)
    return fp, torch.sqrt(torch.clamp_min(var_fp, 0.0))


@dataclass
class PhaseFit:
    """Outputs of :func:`fit_phase_curve` (per channel)."""

    fp: torch.Tensor            # dayside eclipse depth Fp/Fs
    fp_sigma: torch.Tensor      # its 1-sigma (delta method)
    amp: torch.Tensor           # thermal phase amplitude A in [0, 2]
    amp_sigma: torch.Tensor     # its 1-sigma (delta method, unclipped:
    #                             huge when A is a clamp artifact)
    offset_rad: torch.Tensor    # hot-spot offset (+ = eastward)
    slope: torch.Tensor         # fitted linear baseline (fraction over
    #                             the visit half-span)
    chi2: torch.Tensor          # weighted residual sum of squares


def _phase_unpack(av: torch.Tensor):
    """(fp, r, offset) of one channel's harmonic coefficients (5,),
    UNCLIPPED: the delta-method sigma differentiates through it."""
    b = av[2:] / torch.clamp_min(av[0], 1e-9)
    r = torch.sqrt(b[1] ** 2 + b[2] ** 2 + 1e-20)
    return b[0] + r, r, torch.atan2(-b[2], b[1])


def _phase_amp_raw(av: torch.Tensor) -> torch.Tensor:
    fpv, rv, _ = _phase_unpack(av)
    denom = torch.where(torch.abs(fpv) > 1e-9, fpv, 1e-9)
    return 2.0 * rv / denom


def fit_phase_curve(channel_lc: torch.Tensor, exp_mid_s: torch.Tensor,
                    orbit: OrbitParams, rp_over_rs) -> PhaseFit:
    """Closed-form thermal phase-curve fit per channel.

    F = c (1 + fp [1 - A (1 - cos(phi + phi0)) / 2] vis(t)) plus a linear
    time baseline is linear in five coefficients on the basis [1, t, vis,
    vis cos phi, vis sin phi] (phi the true-anomaly phase angle, 0 at
    mid-secondary); one 5x5 weighted least squares per channel, in-transit
    epochs weighted out, fp32 with TF32 off and a relative ridge. fp_sigma
    and amp_sigma come from the residual scatter through the delta method:
    the gradient (``torch.func.grad``, one channel per ``vmap`` lane) of
    the UNCLIPPED map from the coefficients, so a degenerate coverage keeps
    its huge sigma while the reported fp and A are clamped to [-0.05, 0.5]
    and [0, 2]. ``rp_over_rs`` is the SCALAR geometric radius.

    ``channel_lc`` is (n_exp,) or (n_exp, n_chan), normalised to any
    baseline (c absorbs it).
    """
    t = torch.as_tensor(exp_mid_s).to(torch.float32)
    dev = t.device
    lc = torch.as_tensor(channel_lc, device=dev).to(torch.float32)
    squeeze = lc.dim() == 1
    f = lc[:, None] if squeeze else lc                         # (n, m)
    rp = torch.as_tensor(rp_over_rs, dtype=torch.float32, device=dev)
    z, in_front = projected_separation(t, orbit)
    vis = eclipse_visibility(z, in_front, rp)
    phi = orbital_phase_angle(t, orbit)
    w = out_of_transit_mask(t, orbit).to(torch.float32)        # (n,)

    t_norm = ((t - t.mean())
              / torch.clamp_min(0.5 * (t.max() - t.min()), 1e-9))
    X = torch.stack([torch.ones_like(vis), t_norm, vis,
                     vis * torch.cos(phi), vis * torch.sin(phi)], dim=1)
    XtX = torch.einsum("ni,nj,n->ij", X, X, w)
    XtY = torch.einsum("ni,nm,n->im", X, f, w)
    ridge = 1e-7 * torch.diagonal(XtX).sum() / 5.0 + 1e-12
    M = XtX + ridge * torch.eye(5, dtype=torch.float32, device=dev)
    a = torch.linalg.solve_ex(M, XtY)[0]                       # (5, m)

    fp_raw, r_harm, off = _phase_unpack(a)
    fp = torch.clamp(fp_raw, -0.05, 0.5)
    amp = torch.clamp(2.0 * r_harm / torch.clamp_min(fp, 1e-9), 0.0, 2.0)
    slope = a[1] / torch.clamp_min(a[0], 1e-9)                 # (m,)

    resid = (X @ a - f) * w[:, None]
    dof = torch.clamp_min(torch.sum(w) - 5.0, 1.0)
    noise_var = torch.sum(resid ** 2, dim=0) / dof             # (m,)
    cov_u = torch.linalg.inv_ex(M)[0]                          # unit noise

    def delta_sigma(fn):
        g = torch.func.vmap(torch.func.grad(fn), in_dims=1)(a)  # (m, 5)
        return torch.sqrt(torch.clamp_min(
            noise_var * torch.einsum("mi,ij,mj->m", g, cov_u, g), 0.0))

    fp_sigma = delta_sigma(lambda v: _phase_unpack(v)[0])
    amp_sigma = delta_sigma(_phase_amp_raw)
    chi2 = torch.sum(resid ** 2, dim=0)
    out = PhaseFit(fp=fp, fp_sigma=fp_sigma, amp=amp, amp_sigma=amp_sigma,
                   offset_rad=off, slope=slope, chi2=chi2)
    if squeeze:
        out = PhaseFit(**{k.name: getattr(out, k.name)[0]
                          for k in dataclasses.fields(out)})
    return out


def orbit_phase(exp_mid_s: torch.Tensor, gap_s: float = 1200.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-exposure (time since orbit start, first-orbit mask) from the
    exposure timeline alone: any gap above ``gap_s`` starts a new HST
    orbit, whose clock zero is its first exposure. One ``cummax``."""
    t = torch.as_tensor(exp_mid_s)
    n = t.shape[0]
    gap = torch.diff(t, prepend=t[:1])
    new_orbit = gap > gap_s
    orbit_id = torch.cumsum(new_orbit.to(torch.int32), dim=0)
    first = torch.arange(n, device=t.device) == 0
    marks = torch.where(new_orbit | first, t, -math.inf)
    return t - torch.cummax(marks, dim=0).values, orbit_id == 0


def _with_value(r: torch.Tensor):
    return r, r


def _lm_normal_eqs(resid, theta: torch.Tensor):
    """(J^T J, J^T r) of a residual function at ``theta``: the Jacobian
    (n, nd) by ``torch.func.jacfwd``, which hands back the residual as its
    auxiliary output; fp32 contractions with TF32 off."""
    J, r = torch.func.jacfwd(lambda th: _with_value(resid(th)),
                             has_aux=True)(theta)
    return torch.einsum("ni,nj->ij", J, J), torch.einsum("ni,n->i", J, r)


def _lm_step(resid, theta: torch.Tensor, chi2: torch.Tensor,
             lam: torch.Tensor, eye: torch.Tensor):
    """One damped Levenberg-Marquardt step of :func:`_lm_minimize`, taken
    or refused by ``torch.where`` (a NaN chi^2 compares false, so its step
    is refused); ``eye`` is the (nd, nd) identity. Returns the new (theta,
    chi2, lambda), each a tensor of its own."""
    JTJ, g = _lm_normal_eqs(resid, theta)
    diag = torch.diagonal(JTJ)
    ridge = 1e-7 * diag.sum() / eye.shape[0] + 1e-12
    A = JTJ + lam * torch.diag_embed(diag) + ridge * eye
    theta_new = theta - torch.linalg.solve_ex(A, g)[0]
    chi2_new = torch.sum(resid(theta_new) ** 2)
    ok = chi2_new < chi2
    return (torch.where(ok, theta_new, theta),
            torch.where(ok, chi2_new, chi2),
            torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-8, 1e8))


def _replayable(theta0: torch.Tensor) -> bool:
    """Whether :func:`_lm_minimize` replays its steps from a CUDA graph:
    ``theta0`` is on a card, outside every ``torch.func`` transform (the
    ``vmap`` of ``fit_white_ramp``'s geometry seeds), does not require
    grad, and its stream is not capturing already."""
    return (theta0.is_cuda and not theta0.requires_grad
            and torch._C._functorch.peek_interpreter_stack() is None
            and not torch.cuda.is_current_stream_capturing())


class _Graphs(threading.local):
    """Per thread and card: the side stream the LM step is captured on,
    the memory pool that every capture there shares, and the last graph,
    which keeps that pool live between calls. Per thread, so that no two
    threads capture into one pool at once."""

    def __init__(self):
        self.of: dict[torch.device, list] = {}


_graphs = _Graphs()


def _lm_replay(resid, state: tuple, eye: torch.Tensor, n_replays: int):
    """Capture one :func:`_lm_step` from ``state`` (theta, chi2, lambda)
    into a CUDA graph that writes its result back into ``state``, and
    replay it ``n_replays`` times on the current stream: the same kernels
    on the same inputs as the eager steps, with no host sync. Drives
    ``CUDAGraph`` directly: ``torch.cuda.graph`` synchronises the card and
    empties the allocator's cache on entry. Returns ``state``."""
    dev = eye.device
    with torch.cuda.device(dev):
        held = _graphs.of.get(dev)        # [side stream, pool, last graph]
        if held is None:
            held = _graphs.of[dev] = [torch.cuda.Stream(dev),
                                      torch.cuda.graph_pool_handle(), None]
        side, pool, _ = held
        graph = torch.cuda.CUDAGraph()
        with span("lm.capture"):
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                # other threads (autograd's, a mesh's workers) may call
                # CUDA meanwhile: only this thread's calls are checked
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    for s, new in zip(state, _lm_step(resid, *state, eye)):
                        s.copy_(new)
                finally:
                    graph.capture_end()
        held[2] = graph                   # the previous graph goes
        for _ in range(n_replays):
            with span("lm.replay"):
                graph.replay()
    return state


def _lm_minimize(resid, theta0: torch.Tensor, n_steps: int,
                 lam0: float = 1e-3):
    """Damped Levenberg-Marquardt with a fixed step count of
    :func:`_lm_step`, lambda a 0-dim tensor; no host sync. Shared by
    :func:`fit_white_ramp` and :func:`fit_white_recte`; batched over
    starting points with ``torch.func.vmap``. Where :func:`_replayable`,
    the first step runs eagerly and the rest replay it from a CUDA graph
    (:func:`_lm_replay`); elsewhere (the CPU, ``vmap``, grad) every step
    runs eagerly. Spans (``utils.profiling``): an ``lm.step`` per eager
    step (under ``vmap``, one covers the step of every start), an
    ``lm.capture`` per capture and an ``lm.replay`` per replay. Returns
    (theta, chi2)."""
    eye = torch.eye(theta0.shape[0], dtype=torch.float32,
                    device=theta0.device)
    theta = theta0
    chi2 = torch.sum(resid(theta0) ** 2)
    lam = torch.tensor(lam0, dtype=torch.float32, device=theta0.device)
    replay = n_steps >= 2 and _replayable(theta0)
    for _ in range(1 if replay else n_steps):
        with span("lm.step"):
            theta, chi2, lam = _lm_step(resid, theta, chi2, lam, eye)
    if replay:
        # the first step's outputs are the graph's state: its own tensors,
        # and the graph is never replayed after this call
        theta, chi2, _ = _lm_replay(resid, (theta, chi2, lam), eye,
                                    n_steps - 1)
    return theta, chi2


def ramp_transit_model(theta6: torch.Tensor, t_day: torch.Tensor,
                       t_orb: torch.Tensor, firstf: torch.Tensor,
                       z: torch.Tensor, in_front: torch.Tensor,
                       ld: torch.Tensor, n_quad: int,
                       vis: torch.Tensor | None = None):
    """The white-light ramp x signal model of :func:`fit_white_ramp`:
    theta6 = (c, depth, ra per day, rb, rb in orbit 1, log tau), tau
    clipped to [30, 20000] s and the depth to its physical range (Rp/Rs
    [0.01, 0.5], or Fp/Fs [-0.02, 0.1] on the eclipse visibility ``vis``).
    Returns (model flux, systematic-only factor)."""
    c, rp, ra, rb, rbf, log_tau = (theta6[0], theta6[1], theta6[2],
                                   theta6[3], theta6[4], theta6[5])
    tau = _clip(torch.exp(log_tau), 30.0, 20000.0)
    amp = torch.where(firstf > 0.5, rbf, rb)
    sys = (1.0 - ra * t_day) * (1.0 - amp * torch.exp(-t_orb / tau))
    if vis is not None:
        tr = 1.0 + _clip(rp, -0.02, 0.1) * vis
    else:
        f = transit_depth_curve(z, _clip(rp, 0.01, 0.5), ld, n_quad)
        tr = 1.0 - (1.0 - f) * in_front
    return c * sys * tr, sys


@dataclass
class RampFit:
    """Joint white-light ramp + transit fit (:func:`fit_white_ramp`)."""

    rp: torch.Tensor              # white depth: Rp/Rs, or Fp/Fs (eclipse)
    rp_sigma: torch.Tensor        # its 1-sigma from the LM curvature
    c: torch.Tensor               # out-of-transit flux normalisation
    slope_per_day: torch.Tensor   # visit-long linear slope (frac/day)
    hook_amp: torch.Tensor        # orbit-ramp amplitude (orbits >= 2)
    hook_amp_first: torch.Tensor  # orbit-ramp amplitude in orbit 1
    hook_tau_s: torch.Tensor      # orbit-ramp e-folding time (s)
    template: torch.Tensor        # (n_exp,) fitted systematic (no c, no
    #                               transit): divide it out of any curve
    chi2: torch.Tensor            # sum of squared residuals at the fit
    t0_offset_s: torch.Tensor     # fitted mid-transit shift (0 unless
    #                               fit_geometry)
    orbit: OrbitParams            # the orbit the fit used (t0, a/Rs and
    #                               inclination FITTED with fit_geometry)
    weights: torch.Tensor         # (n_exp,) robust keep mask: 0 on the
    #                               exposures clip_sigma clipped


def fit_white_ramp(white_lc: torch.Tensor, exp_mid_s: torch.Tensor,
                   orbit: OrbitParams, ld, rp_init=0.15, *,
                   gap_s: float = 1200.0, n_iter: int = 60,
                   n_quad: int = 32, fit_geometry: bool = False,
                   t0_window_s: float = 600.0, eclipse: bool = False,
                   fp_init=1.5e-3, clip_sigma: float | None = None,
                   clip_rounds: int = 4) -> RampFit:
    """Fit the white curve as transit x instrument ramp (Iraclis):
    F = c (1 - ra t) (1 - rb exp(-t_orb / tau)) T(t; rp), with its own ramp
    amplitude in the first orbit; the orbit clocks come from
    :func:`orbit_phase`. Levenberg-Marquardt (:func:`_lm_minimize`,
    ``n_iter`` steps) on theta = (c, rp, ra per day, rb, rb first, log tau)
    with ``jacfwd`` Jacobians through the occultation integral.

    ``eclipse``: the signal is 1 + fp vis(t) at the geometric radius
    ``rp_init`` (theta[1] = Fp/Fs from ``fp_init``); in-transit epochs are
    left out of the fit. ``fit_geometry`` (transit only) frees (t0 offset
    [s], a/Rs, cos i) after the 6-parameter fit: 13 dt0 seeds across
    +-``t0_window_s``, each refined by a 25-step LM, all in one ``vmap``,
    the best polished by ``n_iter`` more. ``clip_sigma``: each of
    ``clip_rounds`` rounds zero-weights the single worst residual beyond
    ``clip_sigma`` robust sigmas (1.4826 x the MAD of the baseline
    residuals, NaN-skipping medians as ``jnp.nanmedian``) and refits.
    """
    with span("fit.white"):
        lc = torch.as_tensor(white_lc).to(torch.float32)
        dev = lc.device
        t = torch.as_tensor(exp_mid_s, device=dev).to(torch.float32)
        ld = torch.as_tensor(ld, dtype=torch.float32, device=dev)
        t_orb, first = orbit_phase(t, gap_s)
        firstf = first.to(torch.float32)
        t_day = (t - t.mean()) / 86400.0
        oot = out_of_transit_mask(t, orbit).to(torch.float32)
        c0 = torch.sum(lc * oot) / torch.clamp_min(torch.sum(oot), 1.0)
        ndim = 9 if fit_geometry else 6
        z_fix, infr_fix = projected_separation(t, orbit)
        rp_geom = torch.as_tensor(rp_init, dtype=torch.float32, device=dev)

        def orbit_of(theta):
            if theta.shape[0] == 6:
                return orbit
            return dataclasses.replace(
                orbit, t0_s=orbit.t0_s + theta[6],
                sma_rs=_clip(theta[7], 1.5, 50.0),
                inc_rad=torch.arccos(_clip(theta[8], 0.0, 0.6)))

        def model(theta):
            if theta.shape[0] == 6:
                z, in_front = z_fix, infr_fix
            else:
                z, in_front = projected_separation(t, orbit_of(theta))
            vis = eclipse_visibility(z, in_front, rp_geom) if eclipse else None
            return ramp_transit_model(theta[:6], t_day, t_orb, firstf, z,
                                      in_front, ld, n_quad, vis)

        # eclipse mode has no transit factor: in-transit epochs stay out
        fit_mask = oot if eclipse else torch.ones_like(lc)

        def resid(theta):
            return (model(theta)[0] - lc) * fit_mask

        if fit_geometry and eclipse:
            raise ValueError("fit_geometry is a transit-mode feature "
                             "(fit the ephemeris on a transit visit)")
        rp0 = torch.as_tensor(fp_init if eclipse else rp_init,
                              dtype=torch.float32, device=dev).reshape(())
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        theta0 = torch.stack([c0, rp0, f32(0.0), f32(2e-3), f32(4e-3),
                              f32(math.log(250.0))])
        # stage 1: the 6-parameter fit; the geometry's landscape is nonconvex
        # from a cold start
        theta, chi2 = _lm_minimize(resid, theta0, n_iter)
        normal_eqs = partial(_lm_normal_eqs, resid)
        if fit_geometry:
            sma0 = torch.as_tensor(orbit.sma_rs, dtype=torch.float32,
                                   device=dev).reshape(())
            cosi0 = torch.cos(torch.as_tensor(
                orbit.inc_rad, dtype=torch.float32, device=dev)).reshape(())
            dt0_grid = torch.linspace(-t0_window_s, t0_window_s, 13,
                                      dtype=torch.float32, device=dev)

            def seed_fit(dt0):
                th = torch.cat([theta, torch.stack([dt0, sma0, cosi0])])
                return _lm_minimize(resid, th, 25)

            ths, c2s = torch.func.vmap(seed_fit)(dt0_grid)
            theta = ths.index_select(0, torch.argmin(c2s).reshape(1))[0]
            theta, chi2 = _lm_minimize(resid, theta, n_iter)

        w_keep = torch.ones_like(lc)
        if clip_sigma is not None:
            # one exposure per round at most; the scale is the baseline
            # residuals' robust scatter (out of eclipse and transit in eclipse
            # mode), which an unmodelled in-transit feature cannot inflate
            if eclipse:
                vis0 = eclipse_visibility(z_fix, infr_fix, rp_geom)
                scale_mask = (vis0 > 0.999).to(torch.float32) * fit_mask
            else:
                scale_mask = oot
            idx = torch.arange(lc.shape[0], device=dev)
            for _ in range(clip_rounds):
                r = resid(theta)
                kept = scale_mask * w_keep
                r_oot = torch.where(kept > 0.0, r, math.nan)
                med = _median(r_oot, 0, nan=True)
                sig = 1.4826 * _median(torch.abs(r_oot - med), 0, nan=True)
                sig = torch.maximum(
                    sig, 1e-9 * torch.clamp_min(torch.abs(c0), 1e-12))
                dev_r = torch.abs(r - med) * w_keep   # clipped points stay out
                hit = torch.amax(dev_r) > clip_sigma * sig   # NaN sig: False
                w_keep = torch.where((idx == torch.argmax(dev_r)) & hit, 0.0,
                                     w_keep)
                wres = (lambda th, _w=w_keep: _w * resid(th))
                theta, chi2 = _lm_minimize(wres, theta, n_iter)
                normal_eqs = partial(_lm_normal_eqs, wres)

        _, sys = model(theta)
        JTJ, _ = normal_eqs(theta)
        n = (torch.sum(w_keep * fit_mask) if clip_sigma is not None
             else torch.sum(fit_mask))
        noise_var = chi2 / torch.clamp_min(n - ndim, 1.0)
        eye = torch.eye(ndim, dtype=torch.float32, device=dev)
        cov = torch.linalg.inv_ex(JTJ + 1e-9 * eye)[0]
        rp_sigma = torch.sqrt(torch.clamp_min(cov[1, 1] * noise_var, 0.0))
        depth = (torch.clamp(theta[1], -0.02, 0.1) if eclipse
                 else torch.clamp(theta[1], 0.01, 0.5))
        return RampFit(rp=depth, rp_sigma=rp_sigma, c=theta[0],
                       slope_per_day=theta[2], hook_amp=theta[3],
                       hook_amp_first=theta[4],
                       hook_tau_s=torch.clamp(torch.exp(theta[5]), 30.0,
                                              20000.0),
                       template=sys, chi2=chi2,
                       t0_offset_s=theta[6] if fit_geometry else f32(0.0),
                       orbit=orbit_of(theta), weights=w_keep)


def ramp_detrend(channel_lc: torch.Tensor, ramp, exp_mid_s: torch.Tensor,
                 orbit: OrbitParams) -> torch.Tensor:
    """Divide a fitted systematic template (``ramp.template``, a RampFit or
    RecteWhiteFit) out of channel curves (n_exp, n_chan) and re-normalise
    each to its out-of-transit baseline."""
    with span("fit.detrend"):
        w = out_of_transit_mask(exp_mid_s, orbit).to(channel_lc.dtype)
        n = torch.clamp_min(torch.sum(w), 1.0)
        corr = channel_lc / ramp.template[:, None]
        base = torch.sum(corr * w[:, None], dim=0) / n
        return corr / base[None, :]


@dataclass
class RecteWhiteFit:
    """Physical RECTE white-light fit (:func:`fit_white_recte`)."""

    rp: torch.Tensor              # white-light transit Rp/Rs
    rp_sigma: torch.Tensor        # its 1-sigma from the LM curvature
    c: torch.Tensor               # out-of-transit flux normalisation
    slope_per_day: torch.Tensor   # visit-long linear slope (frac/day)
    f0_s: torch.Tensor            # initial slow-trap fill in [0, 1]
    f0_f: torch.Tensor            # initial fast-trap fill in [0, 1]
    rate_scale: torch.Tensor      # multiplier on the supplied rate
    template: torch.Tensor        # (n_exp,) fitted systematic: feed to
    #                               ramp_detrend
    chi2: torch.Tensor            # sum of squared residuals at the fit


def fit_white_recte(white_lc: torch.Tensor, exp_mid_s: torch.Tensor,
                    orbit: OrbitParams, ld, rp_init=0.15, *, rate_e_s,
                    exptime_s: float, n_iter: int = 80,
                    n_quad: int = 32) -> RecteWhiteFit:
    """Fit the white curve as transit x the PHYSICAL two-trap RECTE ramp
    (Zhou et al. 2017; :func:`ops.recte.white_ramp`) at an effective
    illumination rate. theta = (c, rp, ra per day, logit f0_s, logit f0_f,
    log rate_scale); Levenberg-Marquardt (:func:`_lm_minimize`) with
    ``jacfwd`` through the trap recurrence over the exposures (on a card
    one kernel launch for its value and one for its six tangents) and the
    occultation integral. ``rate_e_s``: the aperture's mean illuminated
    rate (e-/s), calibrated by the fitted rate scale; ``exptime_s``: the
    exposure time, exposure starts taken as mid - exptime / 2. Span
    ``fit.recte`` (``utils.profiling``), the steps' spans under it."""
    with span("fit.recte"):
        lc = torch.as_tensor(white_lc).to(torch.float32)
        dev = lc.device
        t = torch.as_tensor(exp_mid_s, device=dev).to(torch.float32)
        ld = torch.as_tensor(ld, dtype=torch.float32, device=dev)
        starts = t - 0.5 * exptime_s
        t_day = (t - t.mean()) / 86400.0
        oot = out_of_transit_mask(t, orbit).to(torch.float32)
        c0 = torch.sum(lc * oot) / torch.clamp_min(torch.sum(oot), 1.0)
        z, in_front = projected_separation(t, orbit)
        rate0 = torch.as_tensor(rate_e_s, dtype=torch.float32, device=dev)

        def model(theta):
            c, rp, ra, u_s, u_f, log_rs = (theta[0], theta[1], theta[2],
                                           theta[3], theta[4], theta[5])
            rate = rate0 * torch.exp(_clip(log_rs, -3.0, 3.0))
            ramp = white_ramp(rate, starts, exptime_s,
                              f0_s=torch.sigmoid(u_s),
                              f0_f=torch.sigmoid(u_f))
            sys = (1.0 - ra * t_day) * ramp
            f = transit_depth_curve(z, _clip(rp, 0.01, 0.5), ld, n_quad)
            tr = 1.0 - (1.0 - f) * in_front
            return c * sys * tr, sys

        def resid(theta):
            return model(theta)[0] - lc

        # the fills start mid-range (the sigmoid's gradient vanishes at the
        # rails); the rate scale at the supplied estimate
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        theta0 = torch.stack([
            c0, torch.as_tensor(rp_init, dtype=torch.float32,
                                device=dev).reshape(()),
            f32(0.0), f32(-1.5), f32(-1.5), f32(0.0)])
        theta, chi2 = _lm_minimize(resid, theta0, n_iter)
        _, sys = model(theta)
        JTJ, _ = _lm_normal_eqs(resid, theta)
        noise_var = chi2 / max(lc.shape[0] - 6, 1)
        eye = torch.eye(6, dtype=torch.float32, device=dev)
        cov = torch.linalg.inv_ex(JTJ + 1e-9 * eye)[0]
        rp_sigma = torch.sqrt(torch.clamp_min(cov[1, 1] * noise_var, 0.0))
        return RecteWhiteFit(
            rp=torch.clamp(theta[1], 0.01, 0.5), rp_sigma=rp_sigma,
            c=theta[0], slope_per_day=theta[2],
            f0_s=torch.sigmoid(theta[3]), f0_f=torch.sigmoid(theta[4]),
            rate_scale=torch.exp(torch.clamp(theta[5], -3.0, 3.0)),
            template=sys, chi2=chi2)

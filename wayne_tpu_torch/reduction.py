"""On-device reduction of simulated reads (port of the part of the JAX
package's ``reduction`` that the Monte-Carlo dataset path runs).

Plain tensor functions with the JAX package's names and semantics:

  * :func:`linearize_reads` — calwf3 NLINCORR, the per-pixel cubic
    non-linearity inverted before any flux estimator;
  * :func:`ramp_slope_frame` — the up-the-ramp least-squares slope;
  * :func:`cr_bad_diff_masks` and :func:`repair_read_stack` — the dense
    per-interval cosmic-ray repair of a read stack;
  * :func:`extract_spectra_cr` (through :func:`_cr_hit_deltas`) — column
    spectra with the simulator's cosmic-ray hits repaired in column space.

Where the JAX package maps one exposure with ``jax.vmap``, the hit-list
functions here take a leading exposure axis B: reads (B, NR, S, S), hit
lists (B, NSAMP, 2, MAX_CR), counts (B, NSAMP). Nothing waits for the
host: the hit budget comes from static shapes, and the per-hit sums are
pairwise masks, not scatters, so the card gives the same answer on every
run.

The rest of the JAX package's ``reduction`` (``reduce_visit``, the depth
fits, ``spectra_to_depths``, the reference-pixel and amplifier
corrections) comes with ROADMAP Queue A8.
"""

from __future__ import annotations

import numpy as np
import torch


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
    goodf = good.to(diffs.dtype)
    own_sum = torch.sum(diffs * goodf, dim=-3, keepdim=True)
    nb_sum = torch.sum(est * goodf, dim=-3, keepdim=True)
    scale = own_sum / torch.where(nb_sum == 0.0, 1.0, nb_sum)
    scale_ok = (torch.abs(nb_sum) > 0.05 * torch.abs(own_sum) + 1e-3) \
        & (scale > 0.0) & (scale < 8.0)
    est = torch.where(scale_ok, est * scale, est)

    repaired = torch.where(good, diffs, est)
    first = reads_dn[..., :1, :, :]
    return torch.cat([first, first + torch.cumsum(repaired, dim=-3)],
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

"""One exposure per batch row: disperse -> splat -> scan -> up-the-ramp
(port of the JAX package's ``ops/exposure.simulate_exposure``).

The front half is plain tensor work, batched over exposures (the JAX
package's ``vmap`` written out as a leading dimension) and over reads:

  1. the field-dependent trace and the wavelength -> column deposit X
     (with ``extra_beams`` the 0th-order spot and the 2nd order fold into
     X), and each companion's own trace and deposit,
  2. per read interval and subsegment: the transit light curve (with the
     planet's eclipse and phase-curve light, and the starspot delta), SSV
     and the visit trend, and the exact time-integrated moving-Gaussian
     row profiles inside a row band around the scan position,
  3. the splat, band = Y^T (counts X): two fp32 contractions (TF32 off),
     plus one contraction and one matmul per companion,
  4. the response plane (flat, QE, unstable RTS pixels) and the RECTE
     escape fraction ``trap_mult`` on the band; the background rate is sky
     and dark thinned by ``trap_mult``, plus ``persist_rate``.

The back half is the readout (:mod:`wayne_tpu_torch.ops.readout`: the
CUDA kernels on the card, their plain versions on the CPU), by one of two
routes that draw the same random numbers:

  * ``fused_reads`` (the default): one call of the whole-exposure readout
    for every read of the chunk. It serves every window width: the
    full-frame window (``band_px = 0``, W = S, as the direct image uses)
    goes through it too.
  * ``fused_reads=False``: one call per emitted read (NSAMP + 1 per
    chunk; read 0 is a read with zero entries). The banded read step
    takes the expected band and Poisson-samples it itself, on the
    whole-exposure kernel's counters. With the band off and IPC off the
    full-frame read step runs instead, on the band sampled in torch
    (``sample_band``) plus the cosmic-ray hits; with the band off and IPC
    on, the banded step runs at W = S, y0 = 0.

``exact_poisson`` draws every Poisson variate (the band, the background,
the cosmic-ray count) from the exact law (``ops.random.exact_poisson``)
instead of the three-regime sampler: in the readout, the kernels' second
instantiation.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from wayne_tpu_torch.calibration import Tables, quadrant_map
from wayne_tpu_torch.config import ExposureStatic
from wayne_tpu_torch.ops.dispersion import (
    flat_plane, trace_params, trace_y, wl_to_x, x_deposit_matrix,
    x_deposit_matrix_gaussian,
)
from wayne_tpu_torch.ops.psf import pixel_fractions_moving, pixel_fractions_static
from wayne_tpu_torch.ops.random import (
    TAG_BIAS_DRIFT, TAG_CR_COUNT, TAG_CR_HIT, TAG_RTS, TAG_SSV_WALK,
    box_muller, exact_poisson, fast_poisson, key_words, philox4x32,
    uniform24,
)
from wayne_tpu_torch.ops.readout import (
    add_hits, exposure_readout, hit_ranks, read_step, read_step_banded,
    sample_band,
)
from wayne_tpu_torch.ops.spots import spot_delta
from wayne_tpu_torch.ops.transit import transit_light_curve
from wayne_tpu_torch.scene import Scene
from wayne_tpu_torch.trends import (
    ssv_mean_factor, ssv_random_walk, visit_trend_factor,
)


@dataclass
class ExposureResult:
    """Per-exposure outputs, with a leading exposure dimension (B)."""

    reads_dn: torch.Tensor       # (B, NSAMP+1, S, S) reads, DN, time order
    ideal_e: torch.Tensor        # (B, S, S) noise-free accumulated source e-
    saturated_frac: torch.Tensor  # (B,) fraction at full well, last read
    cr_pos: torch.Tensor         # (B, NSAMP, 2, MAX_CR) int32 hit rows/cols
    cr_count: torch.Tensor       # (B, NSAMP) int32 hits per interval


def _cosmic_rays(seed: torch.Tensor, tables: Tables, cfg: ExposureStatic,
                 dt: torch.Tensor):
    """Cosmic-ray hits of every read interval of every exposure.

    MAX_CR candidate hits per read; the Poisson-distributed count masks the
    excess and is clamped to MAX_CR (it tallies hits actually deposited).
    Draws are Philox streams of the exposure seed (count: counter (read, 0,
    TAG_CR_COUNT), the exact sampler's blocks (read, 0, TAG_CR_COUNT, n)
    with ``exact_poisson``; hit i: counter (read, i, TAG_CR_HIT)).

    Returns (positions (B, R, 2, MAX_CR) int32, masked charges
    (B, R, MAX_CR), counts (B, R) int32).
    """
    S, n_max = cfg.subarray, cfg.max_cr_per_read
    dev = dt.device
    k0, k1 = key_words(seed)
    rd = torch.arange(dt.shape[0], device=dev)
    lam = (tables.cr_rate_px_s * (S * S) * dt).expand(seed.shape[0], -1)
    if cfg.exact_poisson:
        n = exact_poisson(lam, k0[:, None], k1[:, None], rd, 0, TAG_CR_COUNT)
    else:
        w0, w1, w2, _ = philox4x32(k0[:, None], k1[:, None], rd, 0,
                                   TAG_CR_COUNT, 0)
        z, _ = box_muller(w0, w1)
        n = fast_poisson(lam, uniform24(w2), z)
    n = torch.clamp_max(n, n_max)
    i = torch.arange(n_max, device=dev)
    h0, h1, h2, _ = philox4x32(k0[:, None, None], k1[:, None, None],
                               rd[:, None], i, TAG_CR_HIT, 0)
    pos = torch.stack([h0 % S, h1 % S], dim=2).to(torch.int32)
    charge = tables.cr_mean_e * -torch.log(uniform24(h2))
    mask = (i < n[..., None]).to(charge.dtype)
    return pos, charge * mask, n.to(torch.int32)


def _bias_drift_dn(seed: torch.Tensor, tables: Tables, cfg: ExposureStatic,
                   gain_div) -> torch.Tensor:
    """(B, NR, S, S) per-read per-amplifier bias-drift offsets in DN: each
    read's four amplifier biases wander by Tables.bias_drift_e RMS. The
    drift enters where the pedestal does, after which the chain is linear,
    so adding it to the finished reads is exact. Normal draws: counter
    (read, amplifier, TAG_BIAS_DRIFT)."""
    S, nr = cfg.subarray, cfg.nsamp + 1
    dev = seed.device
    k0, k1 = key_words(seed)
    w0, w1, _, _ = philox4x32(
        k0[:, None, None], k1[:, None, None],
        torch.arange(nr, device=dev)[:, None], torch.arange(4, device=dev),
        TAG_BIAS_DRIFT, 0)
    delta_e = tables.bias_drift_e * box_muller(w0, w1)[0]      # (B, NR, 4)
    quad = quadrant_map(S, tables.subarray_corner, device=dev)
    return delta_e[:, :, quad] / gain_div


def _gather_rows(frame: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """frame (B, S, S) rows (B, ..., W) -> (B, ..., W, S)."""
    bidx = torch.arange(frame.shape[0], device=frame.device)
    return frame[bidx.view((-1,) + (1,) * (rows.dim() - 1)), rows]


def _rts_sign(seed: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S, S) unstable-pixel state of each exposure, +1 (high) or -1
    (low) with probability 1/2 each: the top bit of Philox counter
    (row, col, TAG_RTS) of the exposure seed."""
    dev = seed.device
    k0, k1 = key_words(seed)
    pix = torch.arange(S, device=dev)
    w0, _, _, _ = philox4x32(k0[:, None, None], k1[:, None, None],
                             pix[:, None], pix, TAG_RTS, 0)
    return torch.where(w0 >= 2**31, 1.0, -1.0).to(torch.float32)


def _deposit(tables: Tables, cfg: ExposureStatic, tp, sigma: torch.Tensor,
             S: int):
    """(X (B, NL, S), y_base (B, NL)) of one source's trace ``tp``."""
    x_edges = wl_to_x(tables.wl_edges, tp)                      # (B, NL+1)
    X = (x_deposit_matrix_gaussian(x_edges, S, sigma) if cfg.x_psf
         else x_deposit_matrix(x_edges, S))                     # (B, NL, S)
    return X, trace_y(wl_to_x(tables.wl_centers, tp), tp)


def simulate_exposure(scene: Scene, tables: Tables,
                      cfg: ExposureStatic) -> ExposureResult:
    """Simulate a batch of exposures (``scene`` leaves carry a leading
    exposure dimension B). See the module docstring for the pipeline."""
    dev = tables.device
    S, K, R = cfg.subarray, cfg.n_sub, cfg.nsamp
    B = scene.n
    flags = cfg.noise
    f32 = torch.float32
    band = cfg.band_px if 0 < cfg.band_px < S else 0      # 0 = full frame
    col = lambda v: v[:, None, None]                      # (B,) -> (B, 1, 1)

    tp = trace_params(tables, scene.x_ref, scene.y_ref)
    sigma = (tables.psf_sigma.expand(B, -1) if scene.psf_scale is None
             else tables.psf_sigma * scene.psf_scale[:, None])  # (B, NL)
    X, y_base = _deposit(tables, cfg, tp, sigma, S)
    if cfg.extra_beams:
        # aXe beams B/C on the +1st order's trace row and scan motion: the
        # 0th-order spot at x_ref + beam0_dx (linear split over two
        # columns) and the 2nd order (dispersion doubled about x_ref) fold
        # into X as extra deposit.
        grid = torch.arange(S, dtype=f32, device=dev)
        x_ref = tp.x_ref[:, None]                                   # (B, 1)
        hat = torch.clamp_min(
            1.0 - torch.abs(x_ref + tables.beam0_dx - grid), 0.0)   # (B, S)
        x_edges = wl_to_x(tables.wl_edges, tp)
        X2 = x_deposit_matrix(x_ref + 2.0 * (x_edges - x_ref), S)
        X = X + tables.beam0_rel * hat[:, None, :] + tables.beam2_rel * X2

    # Companion field sources: each disperses from its own field position
    # and carries no transit or spot signal (time-separable in the splat).
    comps = []
    if scene.companions is not None:
        cp = scene.companions
        dlam = torch.diff(tables.wl_edges)
        for i in range(cp.dx_px.shape[-1]):
            tp_c = trace_params(tables, scene.x_ref + cp.dx_px[:, i],
                                scene.y_ref + cp.dy_px[:, i])
            X_c, y_c = _deposit(tables, cfg, tp_c, sigma, S)
            comps.append((X_c, y_c,
                          cp.flux[:, i] * tables.sensitivity * dlam))

    # Photon response: flat (optional) x reference-pixel mask x QE, and
    # the unstable pixels' per-exposure high/low state.
    response = tables.active_mask
    if flags.flat:
        response = flat_plane(tables, tp) * tables.active_mask
    response = (response * tables.qe_map).expand(B, S, S)
    if tables.rts_amp is not None:
        response = response * (1.0 + tables.rts_amp
                               * _rts_sign(scene.seed, S))
    gain_div = tables.gain_map if flags.gain_variations else tables.gain

    bg_rate = torch.zeros((B, S, S), dtype=f32, device=dev)
    if flags.sky:
        bg_rate = bg_rate + col(scene.sky_level) * tables.sky_frame
        if scene.sky_he_level is not None and tables.sky_he_frame is not None:
            bg_rate = bg_rate + col(scene.sky_he_level) * tables.sky_he_frame
    if flags.dark:
        bg_rate = bg_rate + tables.dark_map
    if scene.trap_mult is not None:
        # RECTE capture thins the expected sky + dark (a thinned Poisson
        # process is Poisson); the release rides in persist_rate unthinned
        bg_rate = bg_rate * scene.trap_mult
    if scene.persist_rate is not None:
        bg_rate = bg_rate + scene.persist_rate
    bg_rate = bg_rate * tables.active_mask
    # no sky, dark or persistence: the background is exactly zero and
    # Poisson(0) = 0, so the readout skips its sampler
    has_bg = flags.sky or flags.dark or scene.persist_rate is not None

    # --- every read interval at once: (B, R, K) subsegments --------------
    read_times = tables.read_times
    t_a = read_times[:-1]
    dt = read_times[1:] - read_times[:-1]                          # (R,)
    t_edges = t_a[:, None] + (dt / K)[:, None] * torch.arange(
        K + 1, dtype=f32, device=dev)                               # (R, K+1)
    t_mid = 0.5 * (t_edges[:, :-1] + t_edges[:, 1:])                # (R, K)
    rate0 = (scene.stellar_flux * tables.sensitivity
             * torch.diff(tables.wl_edges))                         # (B, NL)
    times_abs = col(scene.exp_start_s) + t_mid                      # (B, R, K)
    t_flat = times_abs.reshape(B, R * K)
    lc = transit_light_curve(
        t_flat, scene.orbit, scene.rp_over_rs, scene.ld, cfg.transit_quad,
        fp_over_fs=scene.fp_over_fs if cfg.eclipse else None,
        phase_amp=scene.phase_amp, phase_offset_rad=scene.phase_offset)
    if scene.spots is not None:
        lc = lc + spot_delta(t_flat, scene.orbit, scene.rp_over_rs,
                             scene.ld, scene.spots)
    lc = lc.reshape(B, R, K, -1)                                    # (B,R,K,NL)
    factor = torch.ones((B, R, K), dtype=f32, device=dev)
    if flags.ssv and cfg.scan:
        e = t_edges.expand(B, R, K + 1)
        factor = factor * ssv_mean_factor(e[..., :-1], e[..., 1:],
                                          scene.trends)
        if cfg.ssv_walk:
            # one walk per exposure, continuous across reads
            k0, k1 = key_words(scene.seed)
            w0, w1, _, _ = philox4x32(
                k0[:, None], k1[:, None],
                torch.arange(R * K, device=dev), 0, TAG_SSV_WALK, 0)
            factor = factor * ssv_random_walk(
                box_muller(w0, w1)[0], scene.trends).reshape(B, R, K)
    if flags.visit_trend:
        factor = factor * visit_trend_factor(
            col(scene.exp_start_s) + t_mid,
            col(scene.exp_start_s) - col(scene.orbit_start_s) + t_mid,
            scene.is_first_orbit, scene.trends)
    fac_dt = factor * (dt / K)[:, None]
    counts = rate0[:, None, None, :] * lc * fac_dt[..., None]       # (B,R,K,NL)

    # --- the row band of each read: [y0, y0 + W), 8-aligned ---------------
    if band:
        margin = 5.0 * torch.amax(sigma, dim=-1) + 1.0
        y_min = torch.amin(y_base, dim=-1)
        for _, y_c, _ in comps:          # the band covers companion traces
            y_min = torch.minimum(y_min, torch.amin(y_c, dim=-1))
        y_band_lo = y_min - margin                                   # (B,)
        if cfg.scan:
            off = col(scene.scan_speed) * t_edges                    # (B,R,K+1)
            off_lo = torch.minimum(off[..., 0], off[..., -1])
            y0f = torch.floor(y_band_lo[:, None] + off_lo)
        else:
            y0f = torch.floor(y_band_lo[:, None] + 0.0).expand(B, R)
        y0 = torch.clamp(y0f, 0.0, float(S - band)).to(torch.int32)
        y0 = torch.div(y0, 8, rounding_mode="floor") * 8
        W = band
    else:
        y0 = torch.zeros((B, R), dtype=torch.int32, device=dev)
        W = S
    y_edges = ((torch.arange(W + 1, dtype=f32, device=dev) - 0.5)
               + y0.to(f32)[..., None])                             # (B,R,W+1)

    # --- row profiles Y (B, R, K, NL, W) and the splat --------------------
    def row_profiles(yb: torch.Tensor) -> torch.Tensor:
        if cfg.scan:
            off = col(scene.scan_speed) * t_edges                   # (B,R,K+1)
            yb = yb[:, None, None, :]
            return pixel_fractions_moving(
                y_edges[:, :, None, None, :], yb + off[..., :-1, None],
                yb + off[..., 1:, None], sigma[:, None, None, :])
        return pixel_fractions_static(
            y_edges[:, :, None, :], yb[:, None, :], sigma[:, None, :]
        )[:, :, None].expand(B, R, K, -1, -1)

    Yw = torch.einsum("brkl,brklw->brlw", counts, row_profiles(y_base))
    frames = torch.matmul(Yw.transpose(-1, -2), X[:, None])         # (B,R,W,S)
    for X_c, y_c, rate0_c in comps:
        # time-separable: K contracts with the shared factor, then the
        # companion's rate scales each wavelength
        Yw_c = (torch.einsum("brk,brklw->brlw", fac_dt, row_profiles(y_c))
                * rate0_c[:, None, :, None])
        frames = frames + torch.matmul(Yw_c.transpose(-1, -2), X_c[:, None])
    rows = y0.long()[..., None] + torch.arange(W, device=dev)       # (B,R,W)
    frames = frames * _gather_rows(response, rows)
    if scene.trap_mult is not None:
        # the trap deficit is part of the expected signal: ideal_e too
        frames = frames * _gather_rows(scene.trap_mult, rows)

    ideal_e = torch.zeros((B, S, S), dtype=f32, device=dev)
    if cfg.compute_ideal:
        for r in range(R):
            idx = rows[:, r, :, None].expand(B, W, S)
            ideal_e = ideal_e.scatter(
                1, idx, torch.gather(ideal_e, 1, idx) + frames[:, r])

    n_cr = cfg.max_cr_per_read
    if flags.cosmic_rays:
        cr_pos, cr_q, cr_count = _cosmic_rays(scene.seed, tables, cfg, dt)
    else:
        cr_pos = torch.zeros((B, R, 2, n_cr), dtype=torch.int32, device=dev)
        cr_q = torch.zeros((B, R, n_cr), dtype=f32, device=dev)
        cr_count = torch.zeros((B, R), dtype=torch.int32, device=dev)

    # --- the readout: per-emitted-read entries; read 0 is zero entries
    # (dt = 0, zero band, no CR): Poisson(0) = 0 in every regime.
    nr = R + 1
    zero_i = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    y0s = torch.cat([zero_i, y0], dim=1)
    dts = torch.cat([torch.zeros(1, dtype=f32, device=dev), dt]
                    ).expand(B, nr)
    cr_pos_all = torch.cat([torch.zeros((B, 1, 2, n_cr), dtype=torch.int32,
                                        device=dev), cr_pos], dim=1)
    cr_q_all = torch.cat([torch.zeros((B, 1, n_cr), dtype=f32, device=dev),
                          cr_q], dim=1)
    readout = dict(
        seed=scene.seed.to(torch.int32).contiguous(),
        bg_rate=bg_rate.contiguous(), bias_map=tables.bias_map.contiguous(),
        # the kernel contract: the gain operand is the RECIPROCAL plane
        inv_gain=(1.0 / tables.gain_map).contiguous(),
        nl_coeffs=tables.nonlin_coeffs.contiguous(),
        consts=tables.readout_consts,
        poisson=flags.poisson, read_noise=flags.read_noise,
        non_linearity=flags.non_linearity, bias=flags.bias,
        scalar_gain=not flags.gain_variations, bg_poisson=has_bg,
        exact_poisson=cfg.exact_poisson)
    if cfg.fused_reads:
        reads_dn, cum = exposure_readout(
            y0s=y0s.contiguous(), dts=dts.contiguous(),
            bands=torch.cat([torch.zeros((B, 1, W, S), dtype=f32,
                                         device=dev), frames],
                            dim=1).contiguous(),
            cr_pos=cr_pos_all.contiguous(), cr_q=cr_q_all.contiguous(),
            with_cr=flags.cosmic_rays, ipc=flags.ipc, **readout)
    else:
        reads_dn, cum = _read_by_read(y0s, dts, frames, cr_pos_all, cr_q_all,
                                      flags, readout)
    sat = (cum >= tables.full_well_e).to(f32).mean(dim=(-2, -1))
    if flags.bias_drift:
        reads_dn = reads_dn + _bias_drift_dn(scene.seed, tables, cfg,
                                             gain_div)
    return ExposureResult(reads_dn=reads_dn, ideal_e=ideal_e,
                          saturated_frac=sat, cr_pos=cr_pos,
                          cr_count=cr_count)


def _read_by_read(y0s, dts, frames, cr_pos, cr_q, flags, readout):
    """The readout one emitted read at a time (``fused_reads=False``):
    NSAMP + 1 launches per chunk. Per-emitted-read entries as for the
    whole-exposure readout (y0s, dts (B, NR); cr_pos (B, NR, 2, MAX_CR),
    cr_q (B, NR, MAX_CR)); frames (B, NSAMP, W, S) are the intervals'
    expected bands. Returns (reads_dn (B, NR, S, S), the last cum)."""
    B, R, W, S = frames.shape
    dev = frames.device
    seed = readout["seed"]
    # per-read slices of the leading read axis are contiguous
    y0s, dts = y0s.t().contiguous(), dts.t().contiguous()
    cr_pos = cr_pos.transpose(0, 1).contiguous()
    cr_q = cr_q.transpose(0, 1).contiguous()
    # The banded step (B2) samples the expected band itself. Band off and
    # IPC off: the full-frame step (B3) on the band sampled here + hits.
    # Band off with IPC on runs the banded step at W = S, y0 = 0 (B2),
    # which computes the same chain with IPC.
    full_frame = W == S and not flags.ipc
    if full_frame and flags.cosmic_rays:
        # hits on one pixel add in list order; one wait for the host per
        # chunk, for the number of scatters that takes
        ranks = hit_ranks(cr_pos, cr_q)
        n_ranks = int(ranks.max()) + 1
    cum = torch.zeros((B, S, S), dtype=torch.float32, device=dev)
    reads = []
    for k in range(R + 1):
        if k == 0:
            band = torch.zeros((B, W, S), dtype=torch.float32, device=dev)
        else:
            band = frames[:, k - 1]
        if full_frame:
            if flags.poisson and k:
                band = sample_band(seed, k, y0s[k], band,
                                   readout["exact_poisson"])
            if flags.cosmic_rays:
                band = add_hits(band, cr_pos[k], cr_q[k], ranks[k], n_ranks)
            cum, dn = read_step(read=k, dt=dts[k], cum=cum,
                                add=band.contiguous(), **readout)
        else:
            cum, dn = read_step_banded(
                read=k, y0=y0s[k], dt=dts[k], cum=cum,
                band=band.contiguous(), cr_pos=cr_pos[k], cr_q=cr_q[k],
                with_cr=flags.cosmic_rays, ipc=flags.ipc, **readout)
        reads.append(dn)
    return torch.stack(reads, dim=1), cum

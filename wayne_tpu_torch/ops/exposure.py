"""One exposure per batch row: disperse -> splat -> scan -> up-the-ramp
(port of the JAX package's ``ops/exposure.simulate_exposure``).

The front half is plain tensor work, batched over exposures (the JAX
package's ``vmap`` written out as a leading dimension) and over reads:

  1. the field-dependent trace and the wavelength -> column deposit X,
  2. per read interval and subsegment: the transit light curve, SSV and
     the visit trend, and the exact time-integrated moving-Gaussian row
     profiles inside a row band around the scan position,
  3. the splat, band = Y^T (counts X): two fp32 contractions (TF32 off).

The back half is one call of the whole-exposure readout
(:func:`wayne_tpu_torch.ops.readout.exposure_readout`): the CUDA kernel on
the card, its plain version on the CPU. One readout serves every window
width: the full-frame window (``band_px = 0``, W = S, as the direct image
uses) goes through it too.

Not ported yet, and raising NotImplementedError with their ROADMAP item:
the per-read kernels (``fused_reads=False``), ``exact_poisson``, unstable
(RTS) pixels, ``extra_beams`` and the eclipse/phase-curve light.
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
    TAG_BIAS_DRIFT, TAG_CR_COUNT, TAG_CR_HIT, TAG_SSV_WALK, box_muller,
    fast_poisson, key_words, philox4x32, uniform24,
)
from wayne_tpu_torch.ops.readout import exposure_readout
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


def _check_supported(tables: Tables, cfg: ExposureStatic) -> None:
    todo = {
        "fused_reads=False (the per-read kernels, ROADMAP Queue B2/B3)":
            not cfg.fused_reads,
        "exact_poisson (ROADMAP Queue A3)": cfg.exact_poisson,
        "extra_beams (ROADMAP Queue A7)": cfg.extra_beams,
        "eclipse / phase-curve light (ROADMAP Queue A7)": cfg.eclipse,
        "unstable (RTS) pixels (ROADMAP Queue A3)": tables.rts_amp is not None,
    }
    missing = [name for name, hit in todo.items() if hit]
    if missing:
        raise NotImplementedError(
            "not ported to wayne_tpu_torch yet: " + ", ".join(missing))


def _cosmic_rays(seed: torch.Tensor, tables: Tables, cfg: ExposureStatic,
                 dt: torch.Tensor):
    """Cosmic-ray hits of every read interval of every exposure.

    MAX_CR candidate hits per read; the Poisson-distributed count masks the
    excess and is clamped to MAX_CR (it tallies hits actually deposited).
    Draws are Philox streams of the exposure seed (count: counter (read, 0,
    TAG_CR_COUNT); hit i: counter (read, i, TAG_CR_HIT)).

    Returns (positions (B, R, 2, MAX_CR) int32, masked charges
    (B, R, MAX_CR), counts (B, R) int32).
    """
    S, n_max = cfg.subarray, cfg.max_cr_per_read
    dev = dt.device
    k0, k1 = key_words(seed)
    rd = torch.arange(dt.shape[0], device=dev)
    lam = (tables.cr_rate_px_s * (S * S) * dt).expand(seed.shape[0], -1)
    w0, w1, w2, _ = philox4x32(k0[:, None], k1[:, None], rd, 0,
                               TAG_CR_COUNT, 0)
    z, _ = box_muller(w0, w1)
    n = torch.clamp_max(fast_poisson(lam, uniform24(w2), z), n_max)
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


def simulate_exposure(scene: Scene, tables: Tables,
                      cfg: ExposureStatic) -> ExposureResult:
    """Simulate a batch of exposures (``scene`` leaves carry a leading
    exposure dimension B). See the module docstring for the pipeline."""
    _check_supported(tables, cfg)
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
    x_edges = wl_to_x(tables.wl_edges, tp)                     # (B, NL+1)
    X = (x_deposit_matrix_gaussian(x_edges, S, sigma) if cfg.x_psf
         else x_deposit_matrix(x_edges, S))                    # (B, NL, S)
    y_base = trace_y(wl_to_x(tables.wl_centers, tp), tp)       # (B, NL)

    # Photon response: flat (optional) x reference-pixel mask x QE.
    response = tables.active_mask
    if flags.flat:
        response = flat_plane(tables, tp) * tables.active_mask
    response = (response * tables.qe_map).expand(B, S, S)
    gain_div = tables.gain_map if flags.gain_variations else tables.gain

    bg_rate = torch.zeros((B, S, S), dtype=f32, device=dev)
    if flags.sky:
        bg_rate = bg_rate + col(scene.sky_level) * tables.sky_frame
        if scene.sky_he_level is not None and tables.sky_he_frame is not None:
            bg_rate = bg_rate + col(scene.sky_he_level) * tables.sky_he_frame
    if flags.dark:
        bg_rate = bg_rate + tables.dark_map
    bg_rate = bg_rate * tables.active_mask
    # dark and sky off: the background is exactly zero and Poisson(0) = 0,
    # so the readout skips its sampler
    has_bg = flags.sky or flags.dark

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
    lc = transit_light_curve(times_abs.reshape(B, R * K), scene.orbit,
                             scene.rp_over_rs, scene.ld, cfg.transit_quad
                             ).reshape(B, R, K, -1)                 # (B,R,K,NL)
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
        y_band_lo = torch.amin(y_base, dim=-1) - margin              # (B,)
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
    if cfg.scan:
        offsets = col(scene.scan_speed) * t_edges                   # (B,R,K+1)
        yb = y_base[:, None, None, :]
        Y = pixel_fractions_moving(
            y_edges[:, :, None, None, :], yb + offsets[..., :-1, None],
            yb + offsets[..., 1:, None], sigma[:, None, None, :])
    else:
        Y = pixel_fractions_static(
            y_edges[:, :, None, :], y_base[:, None, :], sigma[:, None, :]
        )[:, :, None].expand(B, R, K, -1, -1)
    Yw = torch.einsum("brkl,brklw->brlw", counts, Y)                # (B,R,NL,W)
    frames = torch.matmul(Yw.transpose(-1, -2), X[:, None])         # (B,R,W,S)
    rows = y0.long()[..., None] + torch.arange(W, device=dev)       # (B,R,W)
    frames = frames * _gather_rows(response, rows)

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

    # --- the readout: one call for every read of the batch ---------------
    # Per-emitted-read arrays; read 0 is zero entries (dt = 0, zero band,
    # no CR): Poisson(0) = 0 in every regime.
    nr = R + 1
    zero_i = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    reads_dn, cum = exposure_readout(
        scene.seed.to(torch.int32).contiguous(),
        torch.cat([zero_i, y0], dim=1).contiguous(),
        torch.cat([torch.zeros(1, dtype=f32, device=dev), dt]
                  ).expand(B, nr).contiguous(),
        torch.cat([torch.zeros((B, 1, W, S), dtype=f32, device=dev), frames],
                  dim=1).contiguous(),
        bg_rate.contiguous(), tables.bias_map.contiguous(),
        # the kernel contract: the gain operand is the RECIPROCAL plane
        (1.0 / tables.gain_map).contiguous(),
        tables.nonlin_coeffs.contiguous(),
        torch.cat([torch.zeros((B, 1, 2, n_cr), dtype=torch.int32,
                               device=dev), cr_pos], dim=1).contiguous(),
        torch.cat([torch.zeros((B, 1, n_cr), dtype=f32, device=dev), cr_q],
                  dim=1).contiguous(),
        tables.readout_consts,
        poisson=flags.poisson, read_noise=flags.read_noise,
        non_linearity=flags.non_linearity, bias=flags.bias,
        scalar_gain=not flags.gain_variations, with_cr=flags.cosmic_rays,
        bg_poisson=has_bg, ipc=flags.ipc)
    sat = (cum >= tables.full_well_e).to(f32).mean(dim=(-2, -1))
    if flags.bias_drift:
        reads_dn = reads_dn + _bias_drift_dn(scene.seed, tables, cfg,
                                             gain_div)
    return ExposureResult(reads_dn=reads_dn, ideal_e=ideal_e,
                          saturated_frac=sat, cr_pos=cr_pos,
                          cr_count=cr_count)

"""Forward-model retrieval through the simulator in PyTorch (port of the
JAX package's ``retrieval``): fit a visit's transmission (or emission)
spectrum, and optional nuisances, directly to its extracted column sums by
Levenberg-Marquardt, with exact ``torch.func.jacfwd`` Jacobians through
the whole exposure engine: trace, deposit, moving-PSF splat, flat, sky,
dark, non-linearity, up-the-ramp readout and the extraction estimator.
The model is the simulator with its stochastic noise sources off
(:func:`deterministic_cfg`).

On the card the model twin's readout is the whole-exposure kernel
(``csrc/readout.cu``), one launch per chunk; its derivative comes from
``ops.readout.exposure_readout``'s autograd Function, whose tangent is
torch arithmetic on the saved inputs (the chain is linear with the noise
off). The value always comes from the kernel, which only ever sees primal
tensors.

The tiny (p, p) normal equations are solved in float64 NumPy on the host,
as in the JAX package: near-singular least squares does not survive
reduced-precision arithmetic.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from wayne_tpu_torch.calibration import Tables
from wayne_tpu_torch.config import ExposureStatic
from wayne_tpu_torch.ops.dispersion import trace_params, wl_to_x
from wayne_tpu_torch.ops.exposure import simulate_exposure
from wayne_tpu_torch.ops.kepler import projected_separation
from wayne_tpu_torch.ops.transit import eclipse_visibility
from wayne_tpu_torch.ops.visit import pad_scenes
from wayne_tpu_torch.pytree import tree_map
from wayne_tpu_torch.reduction import (
    _channel_edges, _channel_flux, _oot_normalise, _with_value,
    constrained_mask, out_of_transit_mask, ramp_slope_frame,
)
from wayne_tpu_torch.scene import Scene


@dataclass
class RetrievalResult:
    """Forward-model retrieval output (host NumPy). ``rp``/``rp_sigma``
    hold the fitted per-channel depth: Rp/Rs in transit mode, Fp/Fs in
    eclipse mode."""

    rp: np.ndarray          # (n_chan,) fitted Rp/Rs (or Fp/Fs) per channel
    rp_sigma: np.ndarray    # (n_chan,) 1-sigma from the J^T J curvature
    chi2: float             # final chi^2 over all (exposure, channel) points
    n_points: int           # number of residual points
    n_iter: int             # LM iterations actually run
    ramp: np.ndarray | None     # fitted [slope/s, hook_amp] if fit_ramp
    ramp_sigma: np.ndarray | None
    scan_offset: float | None = None        # fitted reverse-scan flux
    scan_offset_sigma: float | None = None  # offset if fit_scan_offset
    spot_scale: float | None = None         # fitted spot-deficit scale
    spot_scale_sigma: float | None = None   # (fit_spots)
    constrained: np.ndarray | None = None   # (n_chan,) quality flag
    #                           (reduction.constrained_mask)


def deterministic_cfg(cfg: ExposureStatic) -> ExposureStatic:
    """The model twin of a data config: every deterministic effect the
    data had (flat, sky, dark, non-linearity, bias, gain structure, IPC,
    SSV sinusoid, visit trend), none of the sampled ones (photon and read
    noise, cosmic rays, the per-read bias wander). The whole-exposure
    readout (``fused_reads``) always: its derivative is the autograd
    Function of ``ops.readout.exposure_readout``, and its values equal the
    per-read route's. ``ssv_walk`` off: :func:`deterministic_scenes` zeroes
    the walk's amplitude, whose factor is then exactly 1."""
    noise = dataclasses.replace(
        cfg.noise, poisson=False, read_noise=False, cosmic_rays=False,
        bias_drift=False)
    return dataclasses.replace(cfg, noise=noise, use_pallas=False,
                               exact_poisson=False, compute_ideal=False,
                               fused_reads=True, ssv_walk=False)


def deterministic_scenes(scenes: Scene) -> Scene:
    """Zero the random-walk SSV amplitude of a batched Scene: the model
    must not inject its own realisation of a noise process (the
    deterministic SSV sinusoid stays)."""
    trends = dataclasses.replace(
        scenes.trends, ssv_rw_amp=torch.zeros_like(scenes.trends.ssv_rw_amp))
    return dataclasses.replace(scenes, trends=trends)


def bin_channel_map(scenes: Scene, tables: Tables,
                    x_window: tuple[int, int], n_chan: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side wavelength-bin -> channel assignment at exposure 0's
    pointing: (idx (NL,) int, in_window (NL,) bool). Bins whose trace
    column falls outside ``x_window`` keep their initial depth. Raises when
    a channel owns no bin centre (its Jacobian column would be zero)."""
    x0 = tree_map(lambda x: x[0], scenes)
    tp = trace_params(tables, x0.x_ref, x0.y_ref)
    xc = wl_to_x(tables.wl_centers, tp).cpu().numpy().astype(np.float64)
    edges = _channel_edges(x_window, n_chan).astype(np.float64)
    idx = np.clip(np.searchsorted(edges, xc, side="right") - 1,
                  0, n_chan - 1).astype(np.int64)
    in_win = (xc >= edges[0]) & (xc < edges[-1])
    owned = np.bincount(idx[in_win], minlength=n_chan)
    if np.any(owned == 0):
        empty = np.nonzero(owned == 0)[0]
        raise ValueError(
            f"channels {empty.tolist()} contain no wavelength-bin centers "
            f"(n_lambda={xc.size} over window {x_window}); reduce n_chan "
            f"or raise n_lambda")
    return idx, in_win


def forward_spectra(scenes: Scene, tables: Tables, cfg: ExposureStatic,
                    chunk: int = 2, estimator: str = "cds",
                    y_window: tuple[int, int] | None = None) -> torch.Tensor:
    """Expected extracted spectra (n_exp, S) of a visit, differentiably:
    ``chunk`` exposures per :func:`simulate_exposure` call (one readout
    launch each), each chunk reduced to its column sums before the next,
    so the (N, NR, S, S) read stack never exists whole (under ``jacfwd``
    every intermediate carries a tangent per parameter).

    ``estimator``: "cds" (last minus zeroth read) or "ramp" (the
    least-squares slope x exposure time); ``y_window`` restricts the
    column sums to rows [y0, y1). The data must be reduced the same way.
    """
    padded, n = pad_scenes(scenes, chunk)
    out = []
    for c0 in range(0, padded.n, chunk):
        reads = simulate_exposure(tree_map(lambda x: x[c0: c0 + chunk],
                                           padded), tables, cfg).reads_dn
        if estimator == "ramp":
            net = ramp_slope_frame(reads.transpose(0, 1), tables.read_times)
        else:
            net = reads[:, -1] - reads[:, 0]
        if y_window is not None:
            net = net[:, y_window[0]: y_window[1]]
        out.append(net.sum(dim=1))                          # (chunk, S)
    return torch.cat(out)[:n]


def _lm_val_jac(theta, scenes_m, tables, data_chan, oot, sigma_j, idx,
                in_win, d_fixed, rev_mask, edges, *, cfg, chunk, estimator,
                y_window, n_rp, eclipse, fit_t0, fit_ramp, fit_scan_offset,
                fit_spots=False, with_jac):
    """Residuals (and with ``with_jac`` the ``jacfwd`` Jacobian, the
    residuals its auxiliary output: one pass) of one visit's fit at
    ``theta`` (a float32 tensor on the tables' device).

    theta: [depths (n_rp)] (+ [dt0_s] if fit_t0) (+ [visit_slope_per_s,
    hook_amp] if fit_ramp) (+ [scan_offset] if fit_scan_offset)
    (+ [spot_scale] if fit_spots: contrast -> 1 - s (1 - contrast0)).
    ``d_fixed`` (NL,) is the spectrum held outside the window;
    ``rev_mask`` (n_exp,) marks reverse scans.
    """
    n_exp = data_chan.shape[0]

    def resid(th):
        d_chan = th[:n_rp]
        d_bin = in_win * d_chan[idx] + (1.0 - in_win) * d_fixed
        d_bin = d_bin[None].expand(n_exp, -1)
        sc = dataclasses.replace(
            scenes_m, **{("fp_over_fs" if eclipse else "rp_over_rs"): d_bin})
        k = n_rp
        if fit_t0:
            sc = dataclasses.replace(sc, orbit=dataclasses.replace(
                sc.orbit, t0_s=sc.orbit.t0_s + th[k]))
            k += 1
        if fit_ramp:
            tr = sc.trends
            sc = dataclasses.replace(sc, trends=dataclasses.replace(
                tr, visit_slope_per_s=th[k].expand(
                    tr.visit_slope_per_s.shape),
                hook_amp=th[k + 1].expand(tr.hook_amp.shape)))
            k += 2
        if fit_scan_offset:
            # the achromatic source-flux scale the simulator applies to
            # reverse exposures (companions are scanned sources too)
            fac = 1.0 + th[k] * rev_mask                    # (n_exp,)
            sc = dataclasses.replace(
                sc, stellar_flux=sc.stellar_flux * fac[:, None],
                companions=(None if sc.companions is None else
                            dataclasses.replace(
                                sc.companions,
                                flux=sc.companions.flux
                                * fac[:, None, None])))
            k += 1
        if fit_spots:
            sp = sc.spots
            sc = dataclasses.replace(sc, spots=dataclasses.replace(
                sp, contrast=1.0 - th[k] * (1.0 - sp.contrast)))
        model = forward_spectra(sc, tables, cfg, chunk, estimator, y_window)
        model_chan = _oot_normalise(_channel_flux(model, edges), oot,
                                    channels=True)
        return ((model_chan - data_chan) / sigma_j[None, :]).reshape(-1)

    if with_jac:
        J, r = torch.func.jacfwd(lambda th: _with_value(resid(th)),
                                 has_aux=True)(theta)
        return r, J
    return resid(theta)


def _channel_chi_scale(r: np.ndarray, n_exp: int, n_chan: int,
                       n_par: int) -> np.ndarray:
    """Per-channel residual-rms rescale factors of the reported sigma: the
    rms of each channel's standardised residuals over its n_exp points,
    with n_exp minus its depth, its share of the shared nuisances and the
    OOT normalisation as the degrees of freedom (the per-channel noise
    prior is estimated from the out-of-transit points only)."""
    res = r.reshape(n_exp, n_chan)
    dof_c = max(n_exp - 2.0 - (n_par - n_chan) / n_chan, 1.0)
    return np.sqrt(np.maximum((res**2).sum(axis=0) / dof_c, 1e-12))


def _baseline_var_extra(J: np.ndarray, A: np.ndarray,
                        blocks: list) -> np.ndarray:
    """The variance each fitted parameter takes from the out-of-transit
    normalisation of the observed channel curves (delta method: a relative
    baseline error eps_c moves the minimiser by -A J^T (dr/deps_c) eps_c,
    var(eps_c) = (sigma_c scale_c)^2 / N_oot). ``blocks``: one (row0,
    data_chan (n_exp, n_chan), n_oot, sigma (n_chan,), scale (n_chan,))
    per visit, residual rows laid out (exposure, channel) from ``row0``."""
    extra = np.zeros(A.shape[0])
    JT = J.T
    for row0, data_chan, n_oot, sigma, scale in blocks:
        n_exp, n_chan = data_chan.shape
        for c in range(n_chan):
            u = np.zeros(J.shape[0])
            u[row0 + c: row0 + n_exp * n_chan: n_chan] = (
                data_chan[:, c] / sigma[c])
            v = A @ (JT @ u)
            extra += v**2 * ((sigma[c] * scale[c])**2 / max(n_oot, 1.0))
    return extra


def _lm(theta, val_jac, resid_only, n_lm: int):
    """The host Levenberg-Marquardt loop of both retrievals (float64
    normal equations): returns (theta, residuals, Jacobian, chi2,
    iterations)."""
    r, J = val_jac(theta)
    chi2 = float(r @ r)
    lam, n_iter = 1e-3, 0
    for _ in range(n_lm):
        n_iter += 1
        JtJ = J.T @ J
        g = J.T @ r
        step = np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ))
                               + 1e-12 * np.eye(JtJ.shape[0]), g)
        cand = theta - step
        r_c = resid_only(cand)
        chi2_c = float(r_c @ r_c)
        if chi2_c < chi2:
            rel = np.max(np.abs(step) / np.maximum(np.abs(theta), 1e-8))
            theta, chi2 = cand, chi2_c
            lam = max(lam * 0.3, 1e-7)
            r, J = val_jac(theta)
            if rel < 1e-7:
                break
        else:
            lam *= 10.0
            if lam > 1e6:
                break
    return theta, r, J, chi2, n_iter


def _eclipse_covered(mid, orbit0, rp) -> bool:
    z, infr = projected_separation(mid, orbit0)
    vis = eclipse_visibility(z, infr, rp)
    return float(vis.max() - vis.min()) >= 0.1


def retrieve_transmission(spectra_obs, scenes: Scene, tables: Tables,
                          cfg: ExposureStatic, *, x_window: tuple[int, int],
                          n_chan: int = 8, rp_init=0.12,
                          estimator: str = "cds",
                          y_window: tuple[int, int] | None = None,
                          fit_ramp: bool = False,
                          fit_scan_offset: bool = False,
                          fit_spots: bool = False, mode: str = "transit",
                          n_lm: int = 10, chunk: int = 2,
                          sigma: np.ndarray | None = None
                          ) -> RetrievalResult:
    """Fit the transmission spectrum through the full forward model.

    Args:
      spectra_obs: (n_exp, S) OBSERVED raw column sums (over all rows, or
        ``y_window``) of the same ``estimator`` ("cds" or "ramp") this
        function applies to the model: no background subtraction, flat
        fielding or detrending (the model predicts the raw expectation).
      scenes: the visit's batched Scene with the true observing state;
        its ``rp_over_rs`` is the initial spectrum, kept outside the
        window. ``cfg``: the DATA config (the twin is derived).
      x_window / n_chan: the dispersion-direction channels
        (``reduction._channel_edges``).
      rp_init: scalar or (n_chan,) starting depth (Rp/Rs, or Fp/Fs in
        eclipse mode).
      fit_ramp: also fit [visit_slope_per_s, hook_amp] (needs the visit
        trend); fit_scan_offset: the reverse-scan flux offset (needs both
        scan directions); fit_spots: one spot-deficit scale (needs
        ``scenes.spots``), from a spot-blind 0.
      mode: "transit" (Rp/Rs) or "eclipse" (Fp/Fs; needs ``cfg.eclipse``
        and occultation coverage).
      sigma: per-channel noise of the normalised curves (default: the
        data's out-of-transit scatter).

    Returns a RetrievalResult (host NumPy).
    """
    dev = tables.device
    spectra_obs = torch.as_tensor(spectra_obs, device=dev).to(torch.float32)
    n_exp = spectra_obs.shape[0]
    if n_exp != scenes.n:
        raise ValueError(f"spectra_obs has {n_exp} exposures but scenes "
                         f"has {scenes.n}")
    if fit_ramp and not cfg.noise.visit_trend:
        raise ValueError("fit_ramp requires cfg.noise.visit_trend")
    if fit_spots and scenes.spots is None:
        raise ValueError("fit_spots requires scenes.spots (the Scene "
                         "must carry a SpotParams set whose deficit "
                         "the scale multiplies)")
    if mode not in ("transit", "eclipse"):
        raise ValueError(f"mode must be 'transit' or 'eclipse', got {mode!r}")
    eclipse = mode == "eclipse"
    if eclipse and not cfg.eclipse:
        raise ValueError("mode='eclipse' needs a cfg with eclipse=True "
                         "(the visit must model planet dayside light)")

    cfg_m = deterministic_cfg(cfg)
    scenes_m = deterministic_scenes(scenes)
    idx_np, in_win_np = bin_channel_map(scenes, tables, x_window, n_chan)
    idx = torch.as_tensor(idx_np, device=dev)
    in_win = torch.as_tensor(in_win_np, dtype=torch.float32, device=dev)
    edges = _channel_edges(x_window, n_chan)
    rp_fixed, fp_fixed = scenes.rp_over_rs[0], scenes.fp_over_fs[0]

    orbit0 = tree_map(lambda x: x[0], scenes.orbit)
    exptime = float(tables.read_times[-1])
    mid = scenes.exp_start_s + 0.5 * exptime
    oot = out_of_transit_mask(mid, orbit0).to(torch.float32)
    if float(oot.sum()) < 2:
        raise ValueError("fewer than 2 out-of-transit exposures — the "
                         "channel light curves cannot be normalised")
    if eclipse and not _eclipse_covered(mid, orbit0, torch.mean(rp_fixed)):
        raise ValueError("no secondary-eclipse coverage in this "
                         "visit (planet visibility barely changes) "
                         "— Fp/Fs cannot be separated from the "
                         "baseline")

    data_chan = _oot_normalise(_channel_flux(spectra_obs, edges), oot,
                               channels=True)
    if sigma is None:
        n_oot = torch.clamp_min(oot.sum(), 2.0)
        mean = (data_chan * oot[:, None]).sum(0) / n_oot
        var = (((data_chan - mean[None, :]) ** 2) * oot[:, None]
               ).sum(0) / (n_oot - 1.0)
        sigma_j = torch.sqrt(torch.clamp_min(var, 1e-12))
    else:
        sigma_j = torch.as_tensor(sigma, device=dev).to(torch.float32)

    n_rp = n_chan
    theta0 = np.full(n_rp, float(np.mean(rp_init)), np.float64)
    if np.ndim(rp_init) == 1:
        theta0[:] = np.asarray(rp_init, np.float64)
    if fit_ramp:
        tr = scenes.trends
        theta0 = np.concatenate([theta0, [
            float(tr.visit_slope_per_s.reshape(-1)[0]),
            float(tr.hook_amp.reshape(-1)[0])]])
    rev_mask = torch.zeros((n_exp,), dtype=torch.float32, device=dev)
    if fit_scan_offset:
        rev = scenes.scan_speed < 0
        if bool(rev.all()) or not bool(rev.any()):
            raise ValueError(
                "fit_scan_offset needs a forward/reverse alternating "
                "visit (scenes.scan_speed carries only one sign)")
        rev_mask = rev.to(torch.float32)
        theta0 = np.concatenate([theta0, [0.0]])
    if fit_spots:
        # spot-blind start: the data pull the deficit up to the Scene's
        theta0 = np.concatenate([theta0, [0.0]])

    traced = (scenes_m, tables, data_chan, oot, sigma_j, idx, in_win,
              fp_fixed if eclipse else rp_fixed, rev_mask, edges)
    statics = dict(cfg=cfg_m, chunk=chunk, estimator=estimator,
                   y_window=y_window, n_rp=n_rp, eclipse=eclipse,
                   fit_t0=False, fit_ramp=fit_ramp,
                   fit_scan_offset=fit_scan_offset, fit_spots=fit_spots)
    on_dev = lambda th: torch.as_tensor(th, dtype=torch.float32, device=dev)
    host = lambda a: a.detach().cpu().numpy().astype(np.float64)

    def val_jac(th):
        r, J = _lm_val_jac(on_dev(th), *traced, with_jac=True, **statics)
        return host(r), host(J)

    def resid_only(th):
        return host(_lm_val_jac(on_dev(th), *traced, with_jac=False,
                                **statics))

    theta, r, J, chi2, n_iter = _lm(theta0.copy(), val_jac, resid_only, n_lm)

    # curvature errors at the solution, each channel's rescaled by its own
    # residual rms, plus the OOT-normalisation term
    A = np.linalg.pinv(J.T @ J)
    scale_c = _channel_chi_scale(r, n_exp, n_rp, theta.size)
    extra = _baseline_var_extra(
        J, A, [(0, host(data_chan), float(oot.sum()), host(sigma_j),
                scale_c)])
    sig = np.sqrt(np.maximum(np.diag(A), 0.0))
    sig[:n_rp] *= scale_c
    if theta.size > n_rp:
        sig[n_rp:] *= np.sqrt(chi2 / max(r.size - theta.size, 1))
    sig = np.sqrt(sig**2 + extra)
    ok = np.asarray(constrained_mask(
        theta[:n_rp], sig[:n_rp],
        **(dict(sigma_floor=0.02, bounds=None) if eclipse else {})))
    k = n_rp
    ramp = ramp_sig = None
    if fit_ramp:
        ramp, ramp_sig = theta[k: k + 2].copy(), sig[k: k + 2].copy()
        k += 2
    scan_off = scan_off_sig = None
    if fit_scan_offset:
        scan_off, scan_off_sig = float(theta[k]), float(sig[k])
        k += 1
    spot_s = spot_s_sig = None
    if fit_spots:
        spot_s, spot_s_sig = float(theta[k]), float(sig[k])
    return RetrievalResult(
        rp=theta[:n_rp].copy(), rp_sigma=sig[:n_rp].copy(),
        chi2=chi2, n_points=int(r.size), n_iter=n_iter,
        ramp=ramp, ramp_sigma=ramp_sig,
        scan_offset=scan_off, scan_offset_sigma=scan_off_sig,
        spot_scale=spot_s, spot_scale_sigma=spot_s_sig, constrained=ok)


@dataclass
class JointRetrievalResult:
    """Joint multi-visit retrieval output (host NumPy). ``rp``/``rp_sigma``
    hold the SHARED depth: Rp/Rs in transit mode, Fp/Fs in eclipse mode."""

    rp: np.ndarray           # (n_chan,) shared fitted spectrum
    rp_sigma: np.ndarray     # (n_chan,)
    t0_offsets_s: np.ndarray | None        # (n_visits,) fitted per-visit
    #                                        mid-transit offsets from the
    #                                        assumed linear ephemeris
    t0_offsets_sigma_s: np.ndarray | None
    ramp: np.ndarray | None                # (n_visits, 2) [slope/s, hook]
    ramp_sigma: np.ndarray | None
    chi2: float
    n_points: int
    n_iter: int
    constrained: np.ndarray | None = None  # (n_chan,) quality flag
    data_chan: list | None = None   # per-visit (n_exp, n_chan) observed
    #                                 OOT-normalised channel curves
    model_chan: list | None = None  # per-visit (n_exp, n_chan) model
    #                                 curves at the solution
    sigma_chan: list | None = None  # per-visit (n_chan,) noise priors


def retrieve_transmission_joint(
        spectra_list: list, scenes_list: list, tables: Tables,
        cfg: ExposureStatic, *, x_window: tuple[int, int],
        n_chan: int = 8, rp_init=0.12, estimator: str = "cds",
        y_window: tuple[int, int] | None = None, fit_t0: bool = True,
        fit_ramp: bool = False, t0_window_s: float = 1800.0,
        mode: str = "transit", n_lm: int = 12,
        chunk: int = 2) -> JointRetrievalResult:
    """Fit ONE spectrum jointly across N visits through the full forward
    model, each visit with its own mid-transit offset ``dt0_v`` from the
    assumed ephemeris (``fit_t0``: the transit-timing measurement; grid-
    seeded over +-``t0_window_s`` before LM, since chi2(t0) is nonconvex)
    and optionally its own [visit slope, hook amplitude] (``fit_ramp``).
    One residual + Jacobian program per visit over [shared depths, its own
    nuisances]; the global Jacobian is assembled block-sparse on the host.
    ``mode="eclipse"`` fits a shared Fp/Fs spectrum (needs ``cfg.eclipse``
    and occultation coverage in every visit).
    """
    n_vis = len(spectra_list)
    if n_vis != len(scenes_list) or n_vis == 0:
        raise ValueError("need equally many spectra and scenes, >= 1")
    if mode not in ("transit", "eclipse"):
        raise ValueError(f"mode must be 'transit' or 'eclipse', got {mode!r}")
    eclipse = mode == "eclipse"
    if eclipse and not cfg.eclipse:
        raise ValueError("mode='eclipse' needs a cfg with eclipse=True "
                         "(the visit must model planet dayside light)")
    dev = tables.device
    cfg_m = deterministic_cfg(cfg)
    edges = _channel_edges(x_window, n_chan)
    n_rp = n_chan
    n_nuis = (1 if fit_t0 else 0) + (2 if fit_ramp else 0)
    if fit_ramp and not cfg.noise.visit_trend:
        raise ValueError("fit_ramp requires cfg.noise.visit_trend")
    host = lambda a: a.detach().cpu().numpy().astype(np.float64)

    exptime = float(tables.read_times[-1])
    per_visit = []
    for sp, sc in zip(spectra_list, scenes_list):
        sp = torch.as_tensor(sp, device=dev).to(torch.float32)
        n_exp = sp.shape[0]
        if n_exp != sc.n:
            raise ValueError("spectra/scenes exposure mismatch")
        idx_np, in_win_np = bin_channel_map(sc, tables, x_window, n_chan)
        orbit0 = tree_map(lambda x: x[0], sc.orbit)
        mid = sc.exp_start_s + 0.5 * exptime
        oot = out_of_transit_mask(mid, orbit0).to(torch.float32)
        if float(oot.sum()) < 2:
            raise ValueError("a visit has < 2 out-of-transit exposures")
        if eclipse and not _eclipse_covered(mid, orbit0,
                                            torch.mean(sc.rp_over_rs[0])):
            raise ValueError("a visit has no secondary-eclipse "
                             "coverage (planet visibility barely "
                             "changes) — Fp/Fs cannot be separated "
                             "from the baseline")
        data_chan = _oot_normalise(_channel_flux(sp, edges), oot,
                                   channels=True)
        # per-channel noise from first differences of the out-of-transit
        # points (std(diff)/sqrt 2): immune to smooth baseline structure
        # both data and model share (a carried-persistence afterglow)
        dn_np = host(data_chan).astype(np.float32)
        oot_np = host(oot) > 0.5
        if oot_np.sum() >= 3:
            diffs = np.diff(dn_np[oot_np, :], axis=0)
            sig_np = diffs.std(axis=0, ddof=1) / np.sqrt(2.0)
        else:
            sig_np = dn_np[oot_np, :].std(axis=0, ddof=1)
        per_visit.append(dict(
            scenes_m=deterministic_scenes(sc), data_chan=data_chan, oot=oot,
            sigma=torch.as_tensor(np.maximum(sig_np, 1e-6), device=dev).to(
                torch.float32),
            idx=torch.as_tensor(idx_np, device=dev),
            in_win=torch.as_tensor(in_win_np, dtype=torch.float32,
                                   device=dev),
            rp_fixed=(sc.fp_over_fs[0] if eclipse else sc.rp_over_rs[0]),
            n_exp=n_exp))

    statics = dict(cfg=cfg_m, chunk=chunk, estimator=estimator,
                   y_window=y_window, n_rp=n_rp, eclipse=eclipse,
                   fit_t0=fit_t0, fit_ramp=fit_ramp, fit_scan_offset=False)
    on_dev = lambda th: torch.as_tensor(th, dtype=torch.float32, device=dev)

    def visit_args(v):
        pv = per_visit[v]
        return (pv["scenes_m"], tables, pv["data_chan"], pv["oot"],
                pv["sigma"], pv["idx"], pv["in_win"], pv["rp_fixed"],
                torch.zeros((pv["n_exp"],), dtype=torch.float32, device=dev),
                edges)

    def resid_v(tv, v):
        return host(_lm_val_jac(on_dev(tv), *visit_args(v), with_jac=False,
                                **statics))

    theta0 = np.full(n_rp, float(np.mean(rp_init)), np.float64)
    if np.ndim(rp_init) == 1:
        theta0[:] = np.asarray(rp_init, np.float64)
    nuis0 = []
    for sc in scenes_list:
        if fit_t0:
            nuis0.append(0.0)
        if fit_ramp:
            nuis0 += [float(sc.trends.visit_slope_per_s.reshape(-1)[0]),
                      float(sc.trends.hook_amp.reshape(-1)[0])]
    theta = (np.concatenate([theta0, np.asarray(nuis0, np.float64)])
             if nuis0 else theta0.copy())
    n_par = theta.size

    def split(th, v):
        base = n_rp + v * n_nuis
        return np.concatenate([th[:n_rp], th[base: base + n_nuis]])

    if fit_t0 and t0_window_s > 0:
        # grid-seed each visit's dt0: one forward pass per node per visit
        # at the initial spectrum
        nodes = np.linspace(-t0_window_s, t0_window_s, 7)
        for v in range(n_vis):
            base_idx = n_rp + v * n_nuis
            best_dt0, best_c = 0.0, np.inf
            for dt0 in nodes:
                tv = split(theta, v)
                tv[n_rp] = dt0
                r_n = resid_v(tv, v)
                c = float(r_n @ r_n)
                if c < best_c:
                    best_dt0, best_c = float(dt0), c
            theta[base_idx] = best_dt0

    def full_resid(th):
        return np.concatenate([resid_v(split(th, v), v)
                               for v in range(n_vis)])

    def full_val_jac(th):
        rs, Js = [], []
        for v in range(n_vis):
            r_v, J_v = _lm_val_jac(on_dev(split(th, v)), *visit_args(v),
                                   with_jac=True, **statics)
            r_v, J_v = host(r_v), host(J_v)
            Jg = np.zeros((r_v.size, n_par))
            Jg[:, :n_rp] = J_v[:, :n_rp]
            base = n_rp + v * n_nuis
            Jg[:, base: base + n_nuis] = J_v[:, n_rp:]
            rs.append(r_v)
            Js.append(Jg)
        return np.concatenate(rs), np.concatenate(Js, axis=0)

    theta, r, J, chi2, n_iter = _lm(theta, full_val_jac, full_resid, n_lm)

    # residual-rescaled covariance per channel (pooled over the visits for
    # the shared spectrum; each visit's nuisances by its own reduced chi),
    # plus the OOT-normalisation term of every visit
    A = np.linalg.pinv(J.T @ J)
    sig = np.sqrt(np.maximum(np.diag(A), 0.0))
    blocks, row0 = [], 0
    scale_sq = np.zeros(n_rp)
    vis_scale = []
    for pv in per_visit:
        dn = host(pv["data_chan"])
        r_v = r[row0: row0 + dn.size]
        sc_v = _channel_chi_scale(r_v, dn.shape[0], n_rp, n_rp + n_nuis)
        scale_sq += sc_v**2 / n_vis
        dof_v = max(dn.size - n_rp - n_nuis, 1)
        vis_scale.append(float(np.sqrt((r_v**2).sum() / dof_v)))
        blocks.append((row0, dn, float(pv["oot"].sum()), host(pv["sigma"]),
                       sc_v))
        row0 += dn.size
    extra = _baseline_var_extra(J, A, blocks)
    sig[:n_rp] *= np.sqrt(scale_sq)
    for v in range(n_vis):
        base = n_rp + v * n_nuis
        sig[base: base + n_nuis] *= vis_scale[v]
    sig = np.sqrt(sig**2 + extra)
    t0s = t0sig = ramp = ramp_sig = None
    if fit_t0:
        pos = n_rp + np.arange(n_vis) * n_nuis
        t0s, t0sig = theta[pos].copy(), sig[pos].copy()
    if fit_ramp:
        off = n_rp + (1 if fit_t0 else 0)
        pos = off + np.arange(n_vis)[:, None] * n_nuis + np.arange(2)
        ramp, ramp_sig = theta[pos].copy(), sig[pos].copy()
    ok = np.asarray(constrained_mask(
        theta[:n_rp], sig[:n_rp],
        **(dict(sigma_floor=0.02, bounds=None) if eclipse else {})))
    # per-visit observed and model curves at the solution (model = data +
    # standardised residual x sigma)
    data_l, model_l, sigma_l, row0 = [], [], [], 0
    for pv in per_visit:
        dn = host(pv["data_chan"])
        s_v = host(pv["sigma"])
        r_v = r[row0: row0 + dn.size].reshape(dn.shape)
        data_l.append(dn)
        model_l.append(dn + r_v * s_v[None, :])
        sigma_l.append(s_v)
        row0 += dn.size
    return JointRetrievalResult(
        rp=theta[:n_rp].copy(), rp_sigma=sig[:n_rp].copy(),
        t0_offsets_s=t0s, t0_offsets_sigma_s=t0sig, ramp=ramp,
        ramp_sigma=ramp_sig, chi2=chi2, n_points=int(r.size), n_iter=n_iter,
        constrained=ok, data_chan=data_l, model_chan=model_l,
        sigma_chan=sigma_l)

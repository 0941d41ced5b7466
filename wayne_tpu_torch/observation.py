"""Visit orchestration (port of the JAX package's ``observation``).

Builds every host-side input (calibration tables, spectra on the
instrument grid, the visit plan, per-exposure pointing drift, scan
direction and seed words), stacks them into a batched Scene on the device,
runs the visit in chunks and streams ima-style FITS files to disk. Reads
are quantized on the device before the copy to the host (``quantize_adc``),
and the copy of chunk i overlaps the FITS writes of chunk i-1, which run
on one writer thread.

Checkpoint/resume: each exposure lands in its own file, so an interrupted
visit resumes by skipping exposures whose outputs already exist.

Not ported yet (ROADMAP): companions, starspots, persistence, RECTE,
``mesh`` / multi-GPU sharding and ``generate(debug=True)``.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from wayne_tpu_torch.calibration import (
    Tables, imaging_tables, nonlin_fw_deficit, sequence_tables_scope,
)
from wayne_tpu_torch.config import ExposureStatic, NoiseFlags, ObservationConfig
from wayne_tpu_torch.device import resolve_device
from wayne_tpu_torch.io.ima import (
    cr_dq_planes, default_primary_header, saturation_dq, static_dq_plane,
    write_ima,
)
from wayne_tpu_torch.models.grism import make_calibrated_grism
from wayne_tpu_torch.models.planet import Planet
from wayne_tpu_torch.models.stellar import Star
from wayne_tpu_torch.ops.dispersion import trace_params, trace_y, wl_to_x
from wayne_tpu_torch.ops.exposure import ExposureResult, simulate_exposure
from wayne_tpu_torch.ops.random import seed_words
from wayne_tpu_torch.ops.visit import pad_scenes, simulate_visit
from wayne_tpu_torch.pytree import tree_map
from wayne_tpu_torch.scene import Scene
from wayne_tpu_torch.trends import TrendParams
from wayne_tpu_torch.visit_plan import (
    HST_PERIOD_S, VisitPlan, plan_from_start_times, plan_visit,
)

log = logging.getLogger("wayne_tpu_torch")

# Seed-word index of the direct image (exposures use 0..N-1).
_DIRECT_IMAGE_INDEX = 10_000_000


def quantize_adc(reads: torch.Tensor) -> torch.Tensor:
    """Round to the WFC3 IR ADC's 16-bit UNSIGNED DN (0..65535), on the
    reads' device — only half the bytes then cross to the host."""
    return torch.clamp(torch.round(reads), 0.0, 65535.0).to(torch.uint16)


@dataclass
class HostChunk:
    """The write path's outputs of one chunk, on the host."""

    reads_dn: np.ndarray        # (chunk, NR, S, S) float32
    cr_pos: np.ndarray
    cr_count: np.ndarray
    saturated_frac: np.ndarray


def _unported(cfg: ObservationConfig) -> list[str]:
    todo = {"companions (ROADMAP Queue A7)": bool(cfg.companions),
            "starspots (ROADMAP Queue A7)": bool(cfg.star.spots),
            "persistence (ROADMAP Queue A7)": cfg.persistence.enabled,
            "recte (ROADMAP Queue A7)": cfg.recte.enabled}
    return [name for name, hit in todo.items() if hit]


class Observation:
    """One simulated WFC3 IR grism visit on one device.

    ``device``: None (the default) runs on the CUDA card and raises when
    there is none; ``"cpu"`` runs the plain PyTorch path.
    """

    def __init__(self, cfg: ObservationConfig,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(
                "not ported to wayne_tpu_torch yet: " + ", ".join(missing))
        self.cfg = cfg
        with sequence_tables_scope(cfg.calibration.sequence_file):
            self.grism = make_calibrated_grism(cfg, self.device)
            self.static = cfg.exposure_static()
            self.tables: Tables = self.grism.tables
            self.detector_exptime = float(self.tables.read_times[-1])
            if cfg.exp_start_mjd_list:
                self.plan: VisitPlan = plan_from_start_times(
                    cfg.exp_start_mjd_list, self.detector_exptime)
            else:
                self.plan = plan_visit(
                    cfg.n_orbits, self.detector_exptime,
                    cfg.exposure_overhead_s, cfg.start_mjd,
                    cfg.exposures_per_orbit, first_orbit_trim=5 * 60.0)
        self.star = Star(cfg.star)
        self.planet = Planet(cfg.planet, visit_start_mjd=self.plan.start_mjd)
        self.scenes = self._build_scenes()
        self._warn_if_off_detector()

    def _warn_if_off_detector(self) -> None:
        """Warn when the dispersed spectrum misses the subarray, or is
        mostly clipped by it, for any exposure of the visit."""
        S = self.cfg.subarray
        tp = trace_params(self.tables, self.scenes.x_ref, self.scenes.y_ref)
        x_all = wl_to_x(self.tables.wl_centers[[0, -1]], tp)        # (n, 2)
        y0_all = trace_y(x_all[:, :1], tp)[:, 0]
        x_all, y0_all = x_all.cpu().numpy(), y0_all.cpu().numpy()
        x_ref = self.scenes.x_ref.cpu().numpy()
        speed = self.scenes.scan_speed.cpu().numpy()
        y_end = y0_all + speed * self.detector_exptime
        y_lo, y_hi = np.minimum(y0_all, y_end), np.maximum(y0_all, y_end)
        off = ((x_all.max(axis=1) < 0) | (x_all.min(axis=1) >= S)
               | (y_hi < -3) | (y_lo >= S + 3))
        if off.any():
            i = int(np.argmax(off))
            log.warning(
                "spectrum lands outside the %dx%d subarray for %d/%d "
                "exposures (first at exposure %d: columns %.0f..%.0f, "
                "rows %.0f..%.0f for x_ref=%.1f): those frames will "
                "contain background only", S, S, int(off.sum()), off.size,
                i, x_all[i].min(), x_all[i].max(), y_lo[i], y_hi[i],
                x_ref[i])
            return
        x_lo, x_hi = x_all.min(axis=1), x_all.max(axis=1)
        span = np.maximum(x_hi - x_lo, 1.0)
        on = np.clip(x_hi, 0, S) - np.clip(x_lo, 0, S)
        clipped = on < 0.25 * span
        if clipped.any():
            i = int(np.argmax(clipped))
            log.warning(
                "spectrum is mostly clipped by the %dx%d subarray for "
                "%d/%d exposures (first at exposure %d: only %.0f px "
                "on-detector for x_ref=%.1f): move x_ref or enlarge the "
                "subarray", S, S, int(clipped.sum()), clipped.size, i,
                on[i], x_ref[i])

    # ------------------------------------------------------------------
    def _build_scenes(self) -> Scene:
        """The batched Scene: a NumPy copy of the JAX package's recipe
        (same RandomState streams, same order of draws), with the JAX keys
        replaced by the port's seed words of (cfg.seed, exposure index)."""
        cfg, plan = self.cfg, self.plan
        n = plan.n_exposures
        rng = np.random.RandomState(cfg.seed)
        tr = cfg.trends
        idx = np.arange(n)

        def offsets(shift_list, rate):
            if shift_list is not None:
                xs = np.asarray(shift_list, np.float64)
                if xs.size < n:
                    raise ValueError(
                        f"shift list has {xs.size} entries; visit has "
                        f"{n} exposures")
                return xs[:n]
            if not cfg.noise.pointing_drift:
                return np.zeros(n)
            return rate * idx + tr.drift_jitter * rng.standard_normal(n)

        x_ref = cfg.x_ref + offsets(tr.x_shift_list, tr.drift_x_per_exp)
        y_ref = cfg.y_ref + offsets(tr.y_shift_list, tr.drift_y_per_exp)
        if cfg.noise.pointing_drift and (tr.drift_orbit_amp_x
                                         or tr.drift_orbit_amp_y):
            ph = (2.0 * np.pi
                  * (np.asarray(plan.exp_start_s, np.float64)
                     - np.asarray(plan.orbit_start_s, np.float64))
                  / HST_PERIOD_S + np.deg2rad(tr.drift_orbit_phase_deg))
            x_ref = x_ref + tr.drift_orbit_amp_x * np.sin(ph)
            y_ref = y_ref + tr.drift_orbit_amp_y * np.sin(ph)

        speed = np.full(n, cfg.scan_speed_pix_s if cfg.scan else 0.0)
        reverse = np.zeros(n, bool)
        if cfg.scan and cfg.alternate_scan_direction:
            reverse = idx % 2 == 1
            speed[reverse] *= -1.0
            y_ref = y_ref + np.where(
                reverse, abs(cfg.scan_speed_pix_s) * self.detector_exptime, 0.0)
        flux_fac = np.ones(n)
        if tr.reverse_flux_offset:
            if not (cfg.scan and cfg.alternate_scan_direction):
                raise ValueError(
                    "trends.reverse_flux_offset needs scan: true and "
                    "alternate_scan_direction: true (there are no "
                    "reverse-scan exposures to offset)")
            flux_fac = np.where(reverse, 1.0 + tr.reverse_flux_offset, 1.0)

        wl_edges = self.tables.wl_edges.cpu().numpy().astype(np.float64)
        wl_centers = self.tables.wl_centers.cpu().numpy().astype(np.float64)
        stellar = self.star.flux_on_grid(wl_edges)
        rp = self.planet.rp_on_grid(wl_centers)
        fp = self.planet.fp_on_grid(wl_centers)
        ld = self.planet.ld_on_grid(wl_centers)   # (4,) or (NL, 4)

        ssv_phases = rng.uniform(0, 2 * np.pi, n)
        orbit_phase = (2.0 * np.pi
                       * (np.asarray(plan.exp_start_s)
                          - np.asarray(plan.orbit_start_s)) / HST_PERIOD_S)
        psf_scale = None
        if tr.breathing_amp:
            psf_scale = 1.0 + tr.breathing_amp * np.sin(
                orbit_phase + tr.breathing_phase)
        sky = np.full(n, cfg.sky_level)
        if tr.sky_orbit_amp:
            sky = sky * (1.0 + tr.sky_orbit_amp * np.cos(orbit_phase))
        if tr.sky_scatter:
            sky = sky * (1.0 + tr.sky_scatter * rng.standard_normal(n))
        sky = np.maximum(sky, 0.0)
        sky_he = None
        if tr.he_airglow_level:
            he = tr.he_airglow_level * np.maximum(np.cos(orbit_phase), 0.0)
            if tr.he_airglow_scatter:
                he = he * (1.0 + tr.he_airglow_scatter
                           * rng.standard_normal(n))
            sky_he = np.maximum(he, 0.0)

        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                        dtype=torch.float32, device=dev)
        rows = lambda a: f32(a).expand((n,) + np.shape(a)).contiguous()
        per_exp = lambda p: tree_map(
            lambda x: x.to(dev).expand(n).contiguous(), p)
        trends = per_exp(TrendParams.create(
            ssv_amp=tr.ssv_amplitude, ssv_period_s=tr.ssv_period_s,
            ssv_rw_amp=tr.ssv_rw_amplitude,
            visit_slope_per_s=tr.visit_slope_per_day / 86400.0,
            hook_amp=tr.hook_amplitude, hook_tau_s=tr.hook_timescale_s,
            hook_orbit1_scale=tr.hook_orbit1_scale))
        trends.ssv_phase = f32(ssv_phases)
        return Scene(
            x_ref=f32(x_ref), y_ref=f32(y_ref),
            exp_start_s=f32(plan.exp_start_s),
            orbit_start_s=f32(plan.orbit_start_s),
            is_first_orbit=f32(plan.orbit_index == 0),
            scan_speed=f32(speed),
            stellar_flux=f32(flux_fac[:, None] * stellar[None, :]),
            rp_over_rs=rows(rp), fp_over_fs=rows(fp),
            phase_amp=rows(cfg.planet.phase_amplitude),
            phase_offset=rows(np.deg2rad(cfg.planet.phase_offset_deg)),
            ld=rows(ld), orbit=per_exp(self.planet.orbit_params()),
            trends=trends, sky_level=f32(sky),
            seed=seed_words(cfg.seed, torch.arange(n)).to(dev),
            psf_scale=None if psf_scale is None else f32(psf_scale),
            sky_he_level=None if sky_he is None else f32(sky_he),
        )

    # ------------------------------------------------------------------
    def simulate(self, chunk: int = 8) -> ExposureResult:
        """Run the entire visit on the device; a batched ExposureResult."""
        scenes, n = pad_scenes(self.scenes, chunk)
        out = simulate_visit(scenes, self.tables, self.static, chunk)
        return tree_map(lambda x: x[:n], out)

    # ------------------------------------------------------------------
    def generate(self, outdir: str | None = None, chunk: int = 8,
                 progress: Callable[[str], None] | None = None,
                 resume: bool = True) -> list[str]:
        """Simulate the visit and write it as ima-style FITS files (plus
        the visit-opening direct image); returns the exposure paths."""
        cfg = self.cfg
        outdir = outdir or cfg.outdir
        os.makedirs(outdir, exist_ok=True)
        say = progress or (lambda s: log.info("%s", s))
        self._write_direct_image(outdir, resume=resume)

        scenes, n = pad_scenes(self.scenes, chunk)
        read_times = self.tables.read_times.cpu().numpy().astype(np.float64)
        gain = float(self.tables.gain)
        rn = float(self.tables.read_noise_e)
        t_start = time.time()

        def fetch(res: ExposureResult):
            """Start the copy of the write-path outputs to the host."""
            reads = quantize_adc(res.reads_dn) if cfg.quantize_adc \
                else res.reads_dn
            parts = (reads, res.cr_pos, res.cr_count, res.saturated_frac)
            if self.device.type != "cuda":
                return parts, None
            host = tuple(torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                         for p in parts)
            for h, p in zip(host, parts):
                h.copy_(p, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done

        def write(c0: int, fetched) -> None:
            host, done = fetched
            if done is not None:
                done.synchronize()
            reads, cr_pos, cr_count, sat = (t.numpy() for t in host)
            chunk_h = HostChunk(reads.astype(np.float32, copy=False),
                                cr_pos, cr_count, sat)
            futures.append(writer.submit(
                self._write_chunk, c0, chunk_h, outdir, n, read_times,
                gain, rn, resume, say))

        futures: list = []
        with ThreadPoolExecutor(max_workers=1) as writer:
            pending: list = []
            for c0 in range(0, scenes.n, chunk):
                if resume and c0 < n and all(
                        os.path.exists(self._exp_path(outdir, i))
                        for i in range(c0, min(c0 + chunk, n))):
                    continue   # whole chunk already on disk: skip compute
                sl = tree_map(lambda x: x[c0: c0 + chunk], scenes)
                pending.append((c0, fetch(simulate_visit(
                    sl, self.tables, self.static, chunk))))
                if len(pending) > 1:
                    write(*pending.pop(0))
            while pending:
                write(*pending.pop(0))
        paths: list[str] = [p for f in futures for p in f.result()]
        say(f"visit complete: {len(paths)} exposures in "
            f"{time.time() - t_start:.2f}s -> {outdir}")
        return paths

    # ------------------------------------------------------------------
    def _exp_path(self, outdir: str, i: int) -> str:
        return os.path.join(outdir, f"{self.cfg.star.name}_{i:04d}_ima.fits")

    def _detector_planes(self):
        """Calibration-known detector DQ and the bias/gain planes the
        default ERR model propagates (cached; shared by the spectra and
        the direct image)."""
        if not hasattr(self, "_static_dq"):
            t = self.tables
            host = lambda x: x.cpu().numpy()
            self._static_dq = static_dq_plane(
                host(t.dark_map), host(t.active_mask), qe_map=host(t.qe_map),
                rts_amp=None if t.rts_amp is None else host(t.rts_amp))
            if not self._static_dq.any():
                self._static_dq = None
            noise = self.cfg.noise
            self._bias_pedestal_e = (float(t.bias_map.mean())
                                     if noise.bias else 0.0)
            self._gain_map = host(t.gain_map) if noise.gain_variations else None
            self._bias_e_map = host(t.bias_map) if noise.bias else None
        return (self._static_dq, self._bias_pedestal_e, self._gain_map,
                self._bias_e_map)

    def _exposure_dq(self, reads, gain, cr_pos, cr_count, tables):
        """Per-read DQ planes of one exposure (CR + static + saturation)."""
        static_dq = self._detector_planes()[0]
        nr, s = reads.shape[0], reads.shape[1]
        cfg = self.cfg
        dq = (cr_dq_planes(cr_pos, cr_count, nr, s)
              if cfg.noise.cosmic_rays else None)
        if static_dq is not None:
            dq = (np.broadcast_to(static_dq, (nr, s, s)).copy()
                  if dq is None else dq | static_dq[None])
        if cfg.noise.non_linearity:
            dq = saturation_dq(reads, gain, float(tables.full_well_e),
                               nonlin_fw_deficit(tables), dq)
        return dq

    def _write_chunk(self, c0, res: HostChunk, outdir, n, read_times, gain,
                     rn, resume, say) -> list[str]:
        _, bias_ped, gain_map, bias_e_map = self._detector_planes()
        cfg = self.cfg
        scan_speed = self.scenes.scan_speed.cpu().numpy()
        paths = []
        for j in range(res.reads_dn.shape[0]):
            i = c0 + j
            if i >= n:
                break
            path = self._exp_path(outdir, i)
            if resume and os.path.exists(path):
                continue
            dq = self._exposure_dq(res.reads_dn[j], gain, res.cr_pos[j],
                                   res.cr_count[j], self.tables)
            primary = default_primary_header(
                targname=cfg.star.name, grism=cfg.grism, nsamp=cfg.nsamp,
                samp_seq=cfg.samp_seq, subarray=cfg.subarray,
                expstart_mjd=float(self.plan.exp_start_mjd()[i]),
                exptime_s=self.detector_exptime, scan=cfg.scan,
                scan_rate_pix_s=float(scan_speed[i]),
                extra={"SIMSEED": cfg.seed, "EXPINDEX": i,
                       "SAT_FRAC": float(res.saturated_frac[j]),
                       "PERSIST": bool(cfg.persistence.enabled),
                       "NLINCORR": ("PERFORM" if cfg.noise.non_linearity
                                    else "OMIT")})
            write_ima(path, res.reads_dn[j], read_times, primary, gain=gain,
                      read_noise_e=rn, dq=dq, bias_pedestal_e=bias_ped,
                      units=cfg.output_units, gain_map=gain_map,
                      bias_e_map=bias_e_map)
            paths.append(path)
            say(f"exposure {i + 1}/{n} written")
        return paths

    # ------------------------------------------------------------------
    def direct_image_filter(self) -> str:
        return self.cfg.direct_image_filter or (
            "F105W" if self.cfg.grism.upper() == "G102" else "F140W")

    def simulate_direct_image(self, ideal: bool = False):
        """The visit-opening direct image through the same detector chain
        as the spectra: imaging-filter tables (all flux at (x_ref, y_ref)),
        staring, full-frame window (W = S) through the same readout.
        ``ideal=True`` runs it noise-free with ideal_e materialised.

        Returns (ExposureResult with one exposure, imaging Tables,
        ExposureStatic).
        """
        cfg = self.cfg
        nsamp_di = cfg.direct_image_nsamp
        tab = imaging_tables(self.tables, self.direct_image_filter(),
                             nsamp=nsamp_di, samp_seq="RAPID")
        static = ExposureStatic(
            subarray=cfg.subarray, n_lambda=cfg.n_lambda, n_sub=2,
            nsamp=nsamp_di, samp_seq="RAPID", scan=False,
            noise=NoiseFlags.none() if ideal else cfg.noise,
            compute_ideal=ideal,
            max_cr_per_read=self.static.max_cr_per_read,
            transit_quad=16, x_psf=True)
        one = tree_map(lambda a: a[:1], self.scenes)
        zero = torch.zeros(1, device=self.device)
        one.exp_start_s = zero
        one.orbit_start_s = zero
        one.is_first_orbit = zero + 1.0
        one.scan_speed = zero
        one.seed = seed_words(cfg.seed, torch.tensor([_DIRECT_IMAGE_INDEX])
                              ).to(self.device)
        return simulate_exposure(one, tab, static), tab, static

    def _write_direct_image(self, outdir: str, resume: bool = True) -> None:
        """Write the visit-opening direct image as a multiaccum ima."""
        path = os.path.join(outdir, f"{self.cfg.star.name}_direct.fits")
        if resume and os.path.exists(path):
            return
        res, tab, static = self.simulate_direct_image()
        x0 = float(self.scenes.x_ref[0])
        y0 = float(self.scenes.y_ref[0])
        hdr = default_primary_header(
            targname=self.cfg.star.name, grism=self.direct_image_filter(),
            nsamp=static.nsamp, samp_seq=static.samp_seq,
            subarray=self.cfg.subarray, expstart_mjd=self.plan.start_mjd,
            exptime_s=float(tab.read_times[-1]), scan=False,
            scan_rate_pix_s=0.0,
            extra={"OBSTYPE": "IMAGING", "XREF": x0, "YREF": y0,
                   "SIMSEED": self.cfg.seed})
        reads = res.reads_dn[0].cpu().numpy()
        gain = float(self.tables.gain)
        _, bias_ped, gain_map, bias_e_map = self._detector_planes()
        dq = self._exposure_dq(reads, gain, res.cr_pos[0].cpu().numpy(),
                               res.cr_count[0].cpu().numpy(), tab)
        write_ima(path, reads, tab.read_times.cpu().numpy().astype(np.float64),
                  hdr, gain=gain,
                  read_noise_e=float(self.tables.read_noise_e), dq=dq,
                  bias_pedestal_e=bias_ped, units=self.cfg.output_units,
                  gain_map=gain_map, bias_e_map=bias_e_map)

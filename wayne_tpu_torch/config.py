"""Typed configuration for wayne_tpu_torch.

Two kinds of configuration live here:

1. **Static config** (frozen, hashable dataclasses): anything that changes
   array *shapes* or the program that runs — subarray size, number of
   spectral bins, NSAMP, noise toggles.
2. **Host config** (plain dataclasses): the user-facing observation
   description parsed from a YAML parameter file. The YAML schema accepts
   the reference simulator's key names (reference: wayne/run_visit.py —
   single ``-p parameter_file.yml`` entry point) alongside our canonical
   names.

Internal unit conventions (documented once, used everywhere):
  wavelength           micron (um)
  flux density F_lambda erg / s / cm^2 / um
  sensitivity          (e- / s) per (erg / s / cm^2 / um)
  time                 seconds from visit start (device); MJD on host only
  position             detector pixels
  charge               electrons; DN = electrons / gain
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

# ---------------------------------------------------------------------------
# Static (shape-determining / trace-determining) configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NoiseFlags:
    """Which physical effects are enabled. Static: toggling retraces.

    Mirrors the reference's per-effect boolean switches
    (reference: wayne/exposure_generator.py noise kwargs such as ``add_dark``,
    ``add_flat``, ``add_gain_variations``, ``sky_background``, ``cosmic_rate``,
    ``add_read_noise``, ``add_non_linear``, ``add_stellar_noise``).
    """

    poisson: bool = True          # photon (shot) noise on accumulated charge
    read_noise: bool = True       # per-read Gaussian read noise
    dark: bool = True             # dark current accumulation
    sky: bool = True              # master-sky background accumulation
    flat: bool = True             # wavelength-dependent flat-field structure
    non_linearity: bool = True    # HgCdTe non-linearity near full well
    cosmic_rays: bool = True      # Poisson-random CR hits
    bias: bool = True             # zeroth-read / bias pedestal
    gain_variations: bool = True  # inter-quadrant / pixel gain structure
    ssv: bool = True              # scan-speed variations
    visit_trend: bool = True      # orbit hook + visit-long slope
    pointing_drift: bool = True   # x/y reference-position drift
    ipc: bool = False             # inter-pixel capacitance coupling of the
    #                               sensed charge (beyond the reference,
    #                               which does not model IPC — default off)
    bias_drift: bool = False      # per-read per-amplifier electronic bias
    #                               wander (Tables.bias_drift_e RMS; beyond
    #                               the reference, which models only the
    #                               static pedestal — default off). Removed
    #                               downstream by reduction.ref_pixel_correct
    #                               on full-frame products.

    @classmethod
    def none(cls) -> "NoiseFlags":
        return cls(**{f.name: False for f in dataclasses.fields(cls)})

    @classmethod
    def all(cls) -> "NoiseFlags":
        return cls(**{f.name: True for f in dataclasses.fields(cls)})


@dataclass(frozen=True)
class ExposureStatic:
    """Shape/trace-static parameters of a single exposure program.

    One jitted exposure kernel is compiled per distinct ExposureStatic.
    """

    subarray: int = 512          # detector subarray edge S (frames are S x S)
    n_lambda: int = 512          # spectral bins across the grism bandpass
    n_sub: int = 8               # temporal subintervals per read interval
    nsamp: int = 15              # non-destructive reads after the zeroth read
    samp_seq: str = "SPARS10"    # WFC3 sample sequence name
    scan: bool = True            # spatial scan (True) vs staring (False)
    max_cr_per_read: int = 16    # static bound on cosmic-ray hits per read
    transit_quad: int = 64       # quadrature nodes for the occultation integral
    noise: NoiseFlags = field(default_factory=NoiseFlags)
    dtype: str = "float32"       # on-device accumulation dtype
    band_px: int = 0             # row-band width for the splat (0 = full frame);
    #                              must cover scan-per-read + PSF tails + trace
    #                              spread — Observation computes it automatically
    exact_poisson: bool = False  # exact Poisson sampling instead of the
    #                              three-regime sampler (not yet ported:
    #                              raises)
    use_pallas: bool = False     # accepted for config compatibility and
    #                              ignored: the tensors' device decides
    #                              (CUDA -> the readout kernels, CPU ->
    #                              their plain PyTorch versions)
    fused_reads: bool = True     # whole-exposure readout (one launch per
    #                              chunk of exposures); False reads out one
    #                              read at a time (NSAMP + 1 launches per
    #                              chunk): the banded step, or the
    #                              full-frame step with the band and IPC off
    x_psf: bool = False          # also blur the dispersion direction with the
    #                              PSF (reference models cross-dispersion only;
    #                              costs nothing extra — same closed form)
    extra_beams: bool = False    # add the 0th-order spot + 2nd-order
    #                              spectrum (aXe BEAM B/C contamination;
    #                              the reference models +1st order only)
    eclipse: bool = False        # include planet dayside light + its
    #                              secondary-eclipse occultation
    #                              (Scene.fp_over_fs; beyond the
    #                              reference, which models transits only)
    compute_ideal: bool = True   # accumulate the noise-free ideal_e frame
    #                              (oracle diffs / debug guards); the
    #                              production visit path disables it — as a
    #                              jit output it cannot be dead-code
    #                              eliminated and costs ~10% of the visit
    ssv_walk: bool = True        # draw the random-walk SSV; with a zero
    #                              amplitude its factor is exactly 1, so
    #                              ObservationConfig.exposure_static() sets
    #                              False when the config's amplitude is 0
    #                              (decided on the host, not the device)

    def __post_init__(self) -> None:
        if self.subarray not in (64, 128, 256, 512, 1024):
            raise ValueError(f"invalid subarray {self.subarray}")
        if not (1 <= self.nsamp <= 15):
            raise ValueError("NSAMP must be in 1..15 (WFC3 IR limit)")
        if self.n_sub < 1 or self.n_lambda < 2:
            raise ValueError("n_sub >= 1 and n_lambda >= 2 required")


# ---------------------------------------------------------------------------
# Host-side observation description (YAML-facing)
# ---------------------------------------------------------------------------


@dataclass
class StarConfig:
    """Stellar description (reference: wayne observation YAML 'target' block)."""

    name: str = "star"
    temperature_k: float = 4500.0       # blackbody fallback temperature
    magnitude_j: float = 10.0           # J-band magnitude used for rescaling
    radius_rsun: float = 0.67           # stellar radius (R_sun)
    spectrum_file: str | None = None    # two-column (micron, F_lambda) file
    flux_scale: float | None = None     # explicit scale overriding magnitude
    spots: tuple | None = None          # starspots (beyond the reference):
    #                                     list of mappings, each
    #                                     {lon_deg, lat_deg, radius, and
    #                                      temp_k OR contrast} — see
    #                                     ops/spots.py. None = immaculate.
    rotation_period_d: float | None = None  # stellar rotation period
    #                                     (days) carrying the spots across
    #                                     the disk; None = static spots


@dataclass
class PlanetConfig:
    """Planet + orbit (reference: exodata-resolved system parameters)."""

    name: str = "planet"
    period_days: float = 0.813475       # WASP-43 b defaults
    t0_mjd: float = 56000.0             # transit mid-time
    sma_over_rs: float = 4.855          # a / R_star
    inclination_deg: float = 82.1
    eccentricity: float = 0.0
    periastron_deg: float = 90.0
    rp_over_rs: float = 0.1595          # continuum radius ratio
    spectrum_file: str | None = None    # transmission spectrum (micron, Rp/Rs)
    ld_coeffs: tuple[float, float, float, float] = (
        0.65, -0.25, 0.45, -0.2)        # Claret 4-parameter law
    ld_file: str | None = None          # per-wavelength Claret coefficients
    #                                     (5 columns: micron, c1..c4) —
    #                                     clablimb-style table seam
    eclipse_depth: float = 0.0          # dayside emission contrast Fp/Fs
    #                                     (enables secondary-eclipse
    #                                     simulation when nonzero)
    eclipse_file: str | None = None     # per-wavelength Fp/Fs (micron, fp)
    phase_amplitude: float = 0.0        # thermal phase-curve amplitude in
    #                                     [0,1]: planet contrast falls to
    #                                     fp*(1-A) at the nightside
    phase_offset_deg: float = 0.0       # hot-spot offset (+ = peak before
    #                                     mid-eclipse)


@dataclass
class TrendConfig:
    """Systematics amplitudes (reference: wayne/trend_generators/)."""

    ssv_amplitude: float = 0.015        # fractional scan-speed variation (~1.5%)
    ssv_period_s: float = 0.7           # SSV sinusoid period
    ssv_phase: float = 0.0
    ssv_rw_amplitude: float = 0.0       # stochastic (random-walk) SSV variant
    visit_slope_per_day: float = 0.01   # visit-long linear slope (r_a)
    hook_amplitude: float = 0.003       # orbit ramp amplitude (r_b1)
    hook_timescale_s: float = 300.0     # orbit ramp e-folding time (r_b2)
    hook_orbit1_scale: float = 2.0      # stronger hook in first orbit
    drift_x_per_exp: float = 0.002      # px drift per exposure
    drift_y_per_exp: float = 0.005
    drift_jitter: float = 0.005         # random per-exposure pointing jitter (px)
    x_shift_list: tuple | None = None   # explicit per-exposure x offsets (px);
    y_shift_list: tuple | None = None   # overrides the drift+jitter model
    #                                     (reference: wayne accepts explicit
    #                                     x_shifts/y_shifts arrays)
    ssv_resolution: float = 12.0        # subsegments per SSV period when the
    #                                     stripe pattern is super-pixel (error
    #                                     ~(1/res)^2 of peak; 12 -> ~0.3%)
    # --- intra-orbit environmental systematics (beyond the reference) ---
    breathing_amp: float = 0.0          # HST focus "breathing": fractional
    #                                     PSF-width modulation over the
    #                                     thermal/orbital cycle (~1-2% real;
    #                                     0 = off). Keep well under the 5-
    #                                     sigma band margin (<~5%).
    breathing_phase: float = 0.0        # breathing phase at orbit start (rad)
    sky_orbit_amp: float = 0.0          # fractional sky modulation over the
    #                                     orbit (earthshine/He-1.083um airglow
    #                                     rise near the bright limb; 0 = off)
    sky_scatter: float = 0.0            # fractional per-exposure random sky
    #                                     level scatter (0 = off)
    reverse_flux_offset: float = 0.0    # fractional source-flux offset of
    #                                     REVERSE-scan exposures (the WFC3
    #                                     "upstream/downstream" effect: the
    #                                     two scan directions see slightly
    #                                     different effective exposure
    #                                     times, ~0.1-1% in real data).
    #                                     Needs alternate_scan_direction.
    he_airglow_level: float = 0.0       # peak He 1.083 um airglow level
    #                                     (e-/s/px at the helium frame's
    #                                     mean): a SECOND sky component
    #                                     with its own spatial pattern
    #                                     (Tables.sky_he_frame) whose
    #                                     level falls from the peak at
    #                                     orbit start to 0 in shadow
    #                                     (clipped-cosine orbital shape,
    #                                     synthetic). Real WFC3 IR
    #                                     backgrounds carry it separately
    #                                     from zodi/earthshine; 0 = off.
    he_airglow_scatter: float = 0.0     # fractional per-exposure scatter
    #                                     on the airglow level
    drift_orbit_amp_x: float = 0.0      # px: orbital-phase-locked pointing
    #                                     drift (thermal flexure repeating
    #                                     each HST orbit — the dominant
    #                                     short-timescale x-shift structure
    #                                     in real scan visits; ~0.01-0.1 px).
    drift_orbit_amp_y: float = 0.0      # same, cross-dispersion
    drift_orbit_phase_deg: float = 0.0  # sinusoid phase at orbit start


@dataclass
class PersistenceConfig:
    """Exposure-to-exposure image persistence (YAML ``persistence:`` —
    ``true`` or a mapping of these fields). Beyond the reference, which
    models only the within-orbit charge-trapping ramp (hook trend);
    ops/persistence.py."""

    enabled: bool = False
    amplitude_e_s: float = 0.3      # A: release rate of a saturated pixel
    #                                 at t = 1000 s (e-/s; WFC3 ISR 2012-14)
    x0_e: float = 0.0               # sigmoid knee fluence (e-);
    #                                 0 -> 0.95 * full_well_e
    dx_e: float = 18000.0           # sigmoid width (e-)
    gamma: float = 1.0              # power-law decay index
    t_min_s: float = 1.0            # clamp on time-since-stimulus
    direct_image: bool = True       # include the visit-opening direct
    #                                 image as a stimulus (its saturated
    #                                 PSF spot is the classic WFC3
    #                                 persistence source)
    di_gap_s: float = 60.0          # overhead between direct-image end
    #                                 and the first grism exposure
    prior_fluence_file: str | None = None  # (S, S) fluence map (e-) of
    #                                 the PREVIOUS observation's last
    #                                 exposure (.npy or FITS image HDU):
    #                                 afterglow from the prior program —
    #                                 the classic "persistence from the
    #                                 previous target" systematic
    prior_end_s: float = -600.0     # when the prior stimulus ended, on
    #                                 this visit's clock (negative =
    #                                 before the first exposure)


@dataclass
class RecteConfig:
    """Physical charge-trapping ramp, RECTE model (YAML ``recte:`` —
    ``true`` or a mapping of these fields). A physically-motivated
    alternative to the parametric hook trend: two trap populations per
    pixel capture and release charge following the illumination history
    (Zhou et al. 2017, AJ 153, 243); ops/recte.py. When enabled,
    disable the parametric hook (``trends: {hook_amp: 0}``) unless you
    deliberately want both ramps stacked."""

    enabled: bool = False
    n_trap_s: float = 1525.38   # slow-trap count per pixel (Zhou+17)
    eta_s: float = 0.013318     # slow capture efficiency
    tau_s: float = 1.63e4       # slow release timescale (s)
    n_trap_f: float = 162.38    # fast-trap count per pixel
    eta_f: float = 0.008407     # fast capture efficiency
    tau_f: float = 281.463      # fast release timescale (s)
    f0_s: float = 0.0           # initial slow-trap fill fraction at visit
    #                             start (pre-visit pumping; 0 = fresh)
    f0_f: float = 0.0           # initial fast-trap fill fraction


@dataclass
class ProgramConfig:
    """Multi-visit observing program (YAML ``program:`` block).

    Beyond the reference (which simulates one visit per run): the same
    target observed over ``num_visits`` visits — the standard HST
    transit-program design (e.g. WASP-43 b's repeated GO-13467 visits)
    — with the cross-visit physics the single-visit model cannot carry:

    - persistence/trap state threads across visit boundaries
      (``carry_persistence``): each visit's deepest per-pixel fluence
      becomes the next visit's prior-stimulus map
      (PersistenceConfig.prior_fluence_file seam), so visit N opens
      with the afterglow of visit N-1;
    - per-visit ephemeris drift (``t0_drift_s_per_visit``): the TRUE
      transit times walk away from the assumed linear ephemeris by
      this many seconds per visit while the reduction still assumes
      the YAML t0 — the systematic a multi-visit fit must detect.
    """

    num_visits: int = 1
    visit_start_mjds: tuple | None = None  # explicit per-visit starts;
    #                                        None -> spacing below
    visit_spacing_days: float = 0.0        # 0 -> the nearest whole
    #                                        number of planet periods
    #                                        >= 1 day (next transits)
    carry_persistence: bool = True         # thread fluence across visits
    #                                        (needs persistence: enabled)
    t0_drift_s_per_visit: float = 0.0      # true-ephemeris drift


@dataclass
class CalibrationConfig:
    """Optional real STScI calibration products (YAML ``calibration:``
    block). Empty paths keep the synthetic tables; the loaders are in
    :mod:`wayne_tpu_torch.calibration` (``sequence_file`` is applied by
    ``sequence_tables_scope``). Reference: wayne ships the aXe conf,
    sensitivity, flat-cube and sky files in its data directory and loads
    them at Grism/Detector construction."""

    axe_conf: str = ""          # aXe grism .conf (DYDX/DLDP field polys)
    sensitivity_file: str = ""  # 2-col ASCII: wavelength, sensitivity
    flat_file: str = ""         # wavelength-dependent flat cube FITS
    sky_file: str = ""          # master-sky frame FITS
    sky_he_file: str = ""       # He 1.083 um airglow frame FITS (STScI
    #                             ships it as a separate sky component)
    nonlin_file: str = ""       # per-pixel non-linearity cube FITS (c1..c3)
    qe_file: str = ""           # relative-QE / bad-pixel plane FITS (float
    #                             QE plane, or int DQ bits 4=dead 512=blob)
    sequence_file: str = ""     # exact sample-sequence timing JSON

    def any_set(self) -> bool:
        return any(getattr(self, f.name) for f in dataclasses.fields(self))


@dataclass
class ObservationConfig:
    """Full visit description — the YAML parameter file maps onto this."""

    grism: str = "G141"
    subarray: int = 512
    nsamp: int = 15
    samp_seq: str = "SPARS10"
    scan: bool = True
    scan_speed_pix_s: float = 1.0       # spatial-scan rate in pixels / s
    alternate_scan_direction: bool = False  # forward/reverse alternation
    x_ref: float = 256.0                # direct-image reference position
    y_ref: float = 128.0
    n_orbits: int = 4
    exposures_per_orbit: int = 0        # 0 -> fill visibility window
    exposure_overhead_s: float = 20.0   # readout+serial overheads between exps
    start_mjd: float = 55999.86
    exp_start_mjd_list: tuple | None = None  # explicit per-exposure start
    #                                     times (MJD), taken verbatim in
    #                                     place of the cadence planner
    #                                     (reference 'exp_start_times' as
    #                                     a list); a scalar under that key
    #                                     still means start_mjd
    seed: int = 0
    sky_level: float = 1.2              # mean sky rate through grism (e-/s/px)
    cosmic_rate: float = 11.0           # CR events / s / cm^2
    dead_pixel_frac: float = 0.0        # synthetic dead-pixel (DQ 4) fraction
    n_blobs: int = 0                    # synthetic IR blobs (DQ 512) in the
    #                                     subarray (calibration.synthetic_tables)
    blob_attenuation: float = 0.12      # peak blob throughput loss
    unstable_pixel_frac: float = 0.0    # unstable RTS pixels (DQ 32): the
    #                                     response toggles (1 +- amp) per
    #                                     exposure — does NOT cancel in
    #                                     light-curve ratios
    rts_amplitude: float = 0.08         # max RTS toggle amplitude
    star: StarConfig = field(default_factory=StarConfig)
    planet: PlanetConfig = field(default_factory=PlanetConfig)
    trends: TrendConfig = field(default_factory=TrendConfig)
    noise: NoiseFlags = field(default_factory=NoiseFlags)
    calibration: CalibrationConfig = field(
        default_factory=CalibrationConfig)
    persistence: PersistenceConfig = field(
        default_factory=PersistenceConfig)
    recte: RecteConfig = field(default_factory=RecteConfig)
    program: ProgramConfig = field(default_factory=ProgramConfig)
    n_lambda: int = 512
    n_sub: int = 0           # 0 -> auto from SSV period (see auto_n_sub)
    sample_rate_s: float = 0.0  # reference 'sample_rate': seconds per
    #                             temporal subsample; 0 -> auto. The scan
    #                             motion itself integrates in closed form,
    #                             so this only controls flux-variation
    #                             resolution (auto_n_sub caps at 128).
    transit_quad: int = 64
    use_pallas: Any = "auto"  # accepted from YAML and ignored (the device
    #                           of the tensors picks kernel or plain path)
    band_px: int = -1        # row-band width for the splat; -1 = auto
    x_psf: bool = False                 # PSF blur in the dispersion direction
    direct_image_filter: str = ""       # "" -> auto (F140W for G141, F105W
    #                                     for G102); see IMAGING_FILTERS
    direct_image_nsamp: int = 4         # RAPID reads in the direct image
    output_units: str = "counts"        # 'counts' (raw DN) | 'e_per_s'
    extra_beams: bool = False           # 0th-order spot + 2nd-order spectrum
    compute_ideal: bool = False         # materialise the noise-free ideal_e
    #                                     frame per exposure (debug/guards;
    #                                     generate(debug=True) enables it)
    quantize_adc: bool = False          # round reads to integer DN like the
    #                                     detector's 16-bit ADC (also halves
    #                                     the device->host transfer: reads
    #                                     move as int16). Quantization noise
    #                                     (~0.29 DN) is far below read noise.
    companions: tuple | None = None     # contaminating field sources
    #                                     (beyond the reference): list of
    #                                     mappings, each {dx_px, dy_px, and
    #                                     a spectrum: temperature_k +
    #                                     (mag_j OR flux_scale), or
    #                                     spectrum_file}. Their grism
    #                                     spectra disperse from their own
    #                                     field positions and overlap the
    #                                     target's. None = isolated star.
    outdir: str = "wayne_out"

    def exposure_static(self) -> ExposureStatic:
        has_eclipse = bool(self.planet.eclipse_depth
                           or self.planet.eclipse_file)
        if not 0.0 <= self.planet.phase_amplitude <= 1.0:
            raise ValueError(
                f"phase_amplitude must be in [0, 1], got "
                f"{self.planet.phase_amplitude}")
        if self.planet.phase_amplitude and not has_eclipse:
            raise ValueError(
                "phase_amplitude modulates the planet's light — set "
                "eclipse_depth or eclipse_file as well, or the phase "
                "curve would be silently absent")
        return ExposureStatic(
            subarray=self.subarray,
            n_lambda=self.n_lambda,
            n_sub=self.n_sub or self.auto_n_sub(),
            nsamp=self.nsamp,
            samp_seq=self.samp_seq,
            scan=self.scan,
            noise=self.noise,
            band_px=self.band_px if self.band_px >= 0 else self.auto_band_px(),
            max_cr_per_read=self.auto_max_cr(),
            transit_quad=self.transit_quad,
            x_psf=self.x_psf,
            extra_beams=self.extra_beams,
            eclipse=has_eclipse,
            compute_ideal=self.compute_ideal,
            ssv_walk=self.trends.ssv_rw_amplitude != 0.0,
        )

    def auto_n_sub(self) -> int:
        """Subsegments per read. The scan *motion* is integrated in closed
        form and the SSV modulation uses exact per-segment time averages,
        so subsegments only need to resolve (a) light-curve curvature
        (minutes — 8 is plenty) and (b) the *spatial* SSV stripe pattern
        when its wavelength scan_rate * period exceeds ~2 px (sub-pixel
        stripes wash out inside a pixel regardless)."""
        from wayne_tpu_torch.calibration import sample_sequence_times

        n = 8
        times = sample_sequence_times(self.samp_seq, self.nsamp,
                                      self.subarray)
        max_dt = float(max(b - a for a, b in zip(times[:-1], times[1:])))
        if self.sample_rate_s > 0:   # reference-style explicit cadence
            n = max(n, int(max_dt / self.sample_rate_s) + 1)
        stripe_px = abs(self.scan_speed_pix_s) * self.trends.ssv_period_s
        if (self.noise.ssv and self.scan and stripe_px >= 2.0
                and self.trends.ssv_period_s > 0):
            n = max(n, int(self.trends.ssv_resolution * max_dt
                           / self.trends.ssv_period_s) + 1)
        return min(n, 128)

    def auto_max_cr(self) -> int:
        """Static cosmic-ray bound: expected hits per read + 6 sigma.

        (18 um pixels; rate in events/s/cm^2.) Undersizing would silently
        truncate hits, so this is computed from the actual config."""
        from wayne_tpu_torch.calibration import PIXEL_AREA_CM2, sample_sequence_times

        times = sample_sequence_times(self.samp_seq, self.nsamp, self.subarray)
        max_dt = float(max(b - a for a, b in zip(times[:-1], times[1:])))
        lam = self.cosmic_rate * PIXEL_AREA_CM2 * self.subarray**2 * max_dt
        need = lam + 6.0 * lam**0.5 + 4.0
        return int(-(-need // 8) * 8)

    def auto_band_px(self) -> int:
        """Row-band width covering scan-per-read + PSF tails + trace spread.

        The band only accelerates the splat; correctness is kept by a
        conservative margin (PSF sigma < 1 px on WFC3 IR, trace spread
        < 3 px across the bandpass, +safety)."""
        from wayne_tpu_torch.calibration import sample_sequence_times

        times = sample_sequence_times(self.samp_seq, self.nsamp, self.subarray)
        max_dt = float(max(b - a for a, b in zip(times[:-1], times[1:])))
        span = abs(self.scan_speed_pix_s) * max_dt if self.scan else 0.0
        if self.companions:
            # the band must also cover companion traces offset in rows
            dys = [float(c.get("dy_px", 0.0)) for c in self.companions
                   if isinstance(c, Mapping)]
            span += max(dys + [0.0]) - min(dys + [0.0])
        # margin budget: 5*sigma_max below (~4) + trace spread (~3) +
        # 5*sigma_max above (~4) + 8-px alignment slack + rounding pad
        band = int(-(-(span + 23.0) // 16) * 16)
        return band if band < self.subarray else 0


# ---------------------------------------------------------------------------
# YAML loading — accepts reference-style key names
# ---------------------------------------------------------------------------

# Mapping from reference YAML keys (reference: wayne parameter files, e.g.
# the repo's example `*_par.yml`) to (section, field) in ObservationConfig.
_REF_KEY_ALIASES: dict[str, tuple[str | None, str]] = {
    # observation block
    "grism": (None, "grism"),
    "subarray": (None, "subarray"),
    "nsamp": (None, "nsamp"),
    "NSAMP": (None, "nsamp"),
    "samp_seq": (None, "samp_seq"),
    "SAMPSEQ": (None, "samp_seq"),
    "scan": (None, "scan"),
    "spatial_scan": (None, "scan"),
    "scan_speed": (None, "scan_speed_pix_s"),
    "sample_rate": (None, "sample_rate_s"),
    "x_ref": (None, "x_ref"),
    "y_ref": (None, "y_ref"),
    "num_orbits": (None, "n_orbits"),
    "n_orbits": (None, "n_orbits"),
    "exp_start_times": (None, "start_mjd"),    # list -> exp_start_mjd_list
    "exposure_start_mjd_list": (None, "exp_start_mjd_list"),
    "exp_start_mjd_list": (None, "exp_start_mjd_list"),
    "start_JD": (None, "start_mjd"),
    "start_mjd": (None, "start_mjd"),
    "seed": (None, "seed"),
    "sky_rate": (None, "sky_level"),
    "sky_level": (None, "sky_level"),
    "cosmic_rate": (None, "cosmic_rate"),
    "dead_pixel_frac": (None, "dead_pixel_frac"),
    "n_blobs": (None, "n_blobs"),
    "blob_attenuation": (None, "blob_attenuation"),
    "unstable_pixel_frac": (None, "unstable_pixel_frac"),
    "rts_amplitude": (None, "rts_amplitude"),
    "outdir": (None, "outdir"),
    "save_location": (None, "outdir"),
    # star block
    "star_temperature": ("star", "temperature_k"),
    "mag_J": ("star", "magnitude_j"),
    "stellar_spectrum_file": ("star", "spectrum_file"),
    "star_radius": ("star", "radius_rsun"),
    # planet block
    "planet_name": ("planet", "name"),
    "period": ("planet", "period_days"),
    "t0": ("planet", "t0_mjd"),
    "sma_over_rs": ("planet", "sma_over_rs"),
    "a_rs": ("planet", "sma_over_rs"),
    "inclination": ("planet", "inclination_deg"),
    "eccentricity": ("planet", "eccentricity"),
    "periastron": ("planet", "periastron_deg"),
    "rp_over_rs": ("planet", "rp_over_rs"),
    "planet_spectrum_file": ("planet", "spectrum_file"),
    "ld_coeffs": ("planet", "ld_coeffs"),
    "limb_darkening": ("planet", "ld_coeffs"),
    "ld_file": ("planet", "ld_file"),
    # trends block
    "ssv_amplitude": ("trends", "ssv_amplitude"),
    "ssv_period": ("trends", "ssv_period_s"),
    "ssv_rw_amplitude": ("trends", "ssv_rw_amplitude"),
    "visit_slope": ("trends", "visit_slope_per_day"),
    "hook_amplitude": ("trends", "hook_amplitude"),
    "hook_timescale": ("trends", "hook_timescale_s"),
    "x_shifts": ("trends", "drift_x_per_exp"),
    "y_shifts": ("trends", "drift_y_per_exp"),
}

_NOISE_KEY_ALIASES: dict[str, str] = {
    "noise": "poisson",
    "stellar_noise": "poisson",
    "add_read_noise": "read_noise",
    "read_noise": "read_noise",
    "add_dark": "dark",
    "dark": "dark",
    "sky_background": "sky",
    "sky": "sky",
    "add_flat": "flat",
    "flat": "flat",
    "add_non_linear": "non_linearity",
    "non_linearity": "non_linearity",
    "cosmic_rays": "cosmic_rays",
    "add_gain_variations": "gain_variations",
    "gain_variations": "gain_variations",
    "bias": "bias",
    "add_initial_bias": "bias",
    "ssv": "ssv",
    "scan_speed_var": "ssv",
    "visit_trend": "visit_trend",
    "x_shifts_on": "pointing_drift",
    "pointing_drift": "pointing_drift",
    "ipc": "ipc",
    "inter_pixel_capacitance": "ipc",
}


def _coerce(value: Any, target: Any) -> Any:
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        return tuple(float(v) for v in value)
    return value


# Catalog-entry field -> (section, field) targets for name resolution
# (exodata's role: resolve a named system to its parameters, SURVEY.md:112).
_CATALOG_FIELD_MAP: dict[str, tuple[str, str]] = {
    "period_days": ("planet", "period_days"),
    "t0_mjd": ("planet", "t0_mjd"),
    "sma_over_rs": ("planet", "sma_over_rs"),
    "inclination_deg": ("planet", "inclination_deg"),
    "eccentricity": ("planet", "eccentricity"),
    "periastron_deg": ("planet", "periastron_deg"),
    "rp_over_rs": ("planet", "rp_over_rs"),
    "eclipse_depth": ("planet", "eclipse_depth"),
    "star_teff": ("star", "temperature_k"),
    "star_j": ("star", "magnitude_j"),
    "star_radius_rsun": ("star", "radius_rsun"),
}

# Explicit keys that prove the user supplied their own orbit, letting an
# unresolvable planet_name pass as a mere label.
_ORBIT_BASICS = {("planet", "period_days"), ("planet", "sma_over_rs"),
                 ("planet", "inclination_deg"), ("planet", "rp_over_rs")}


def _resolve_planet_name(cfg: ObservationConfig,
                         explicit: set[tuple[str | None, str]],
                         catalog: dict | None = None) -> None:
    """Fill planet/star parameters from the catalog for a named system.

    Explicitly provided keys always win; the catalog only fills the rest.
    An unknown name raises unless the user supplied the orbit themselves
    (then the name is just a label).
    """
    from wayne_tpu_torch.models.planet import resolve_system

    try:
        sys_params = resolve_system(cfg.planet.name, catalog)
    except KeyError:
        if _ORBIT_BASICS & explicit:
            return   # user-specified orbit; name is a label
        raise
    for key, (section, name) in _CATALOG_FIELD_MAP.items():
        if key in sys_params and (section, name) not in explicit:
            obj = getattr(cfg, section)
            setattr(obj, name, _coerce(sys_params[key], getattr(obj, name)))


def config_from_dict(params: Mapping[str, Any]) -> ObservationConfig:
    """Build an ObservationConfig from a (possibly reference-style) dict.

    Accepts either nested sections (observation/star/planet/trends/noise)
    or the reference's flat key layout. A ``planet_name`` naming a known
    system (built-in table or a ``catalog_file``) resolves its orbital and
    stellar parameters, with explicit keys taking precedence — the
    exodata-equivalent path (reference: wayne resolves named systems from
    the Open Exoplanet Catalogue at Observation construction).
    """
    cfg = ObservationConfig()
    flat: dict[str, Any] = {}
    sectioned: list[tuple[str, str, Any]] = []
    noise_kv: dict[str, Any] = {}
    calib_kv: dict[str, Any] = {}
    section_of = {"star": "star", "target": "star", "planet": "planet",
                  "trends": "trends", "systematics": "trends"}
    for key, value in params.items():
        if key == "observation" and isinstance(value, Mapping):
            flat.update(value)
        elif key in section_of and isinstance(value, Mapping):
            # keep the section origin: star: and planet: share field
            # names ('name', 'spectrum_file') that must never
            # cross-route — flattening them into one dict sent a
            # planet's name/spectrum to the star
            sectioned.extend(
                (section_of[key], k, v) for k, v in value.items())
        elif key == "noise" and isinstance(value, Mapping):
            noise_kv.update(value)
        elif key == "calibration" and isinstance(value, Mapping):
            calib_kv.update(value)
        else:
            flat[key] = value

    # Section blocks nested under observation: are equally valid — route
    # them exactly like their top-level forms. Without this the raw
    # mapping lands on the same-named CONFIG FIELD (cfg.noise became the
    # dict itself and the first flag access crashed downstream).
    # (a scalar `noise: true/false` is the reference-style master
    # shot-noise toggle — the _NOISE_KEY_ALIASES loop below handles it)
    if isinstance(flat.get("noise"), Mapping):
        noise_kv.update(flat.pop("noise"))
    for sec_key in ("star", "target", "planet", "trends", "systematics"):
        nested = flat.pop(sec_key, None)
        if nested is None:
            continue
        if not isinstance(nested, Mapping):
            raise ValueError(f"'{sec_key}' must be a mapping, got "
                             f"{type(nested).__name__}")
        sectioned.extend(
            (section_of[sec_key], k, v) for k, v in nested.items())

    # a calibration: block nested under observation: is equally valid
    nested_cal = flat.pop("calibration", None)
    if nested_cal is not None:
        if not isinstance(nested_cal, Mapping):
            raise ValueError(
                "'calibration' must be a mapping of product paths, got "
                f"{type(nested_cal).__name__}")
        calib_kv.update(nested_cal)

    # persistence: true/false, or a mapping of PersistenceConfig fields
    # (a mapping implies enabled unless it says otherwise).
    pers = flat.pop("persistence", None)
    if pers is not None:
        pers_fields = {f.name for f in dataclasses.fields(PersistenceConfig)}
        if isinstance(pers, Mapping):
            unknown = set(pers) - pers_fields
            if unknown:
                raise ValueError(
                    f"unknown persistence keys {sorted(unknown)}; "
                    f"allowed: {sorted(pers_fields)}")
            kv = {k: _coerce(v, getattr(cfg.persistence, k))
                  for k, v in pers.items()}
            kv.setdefault("enabled", True)
            cfg.persistence = dataclasses.replace(cfg.persistence, **kv)
        else:
            cfg.persistence = dataclasses.replace(
                cfg.persistence, enabled=_coerce(pers, True))

    # recte: true/false, or a mapping of RecteConfig fields (a mapping
    # implies enabled unless it says otherwise).
    rec = flat.pop("recte", None)
    if rec is not None:
        rec_fields = {f.name for f in dataclasses.fields(RecteConfig)}
        if isinstance(rec, Mapping):
            unknown = set(rec) - rec_fields
            if unknown:
                raise ValueError(
                    f"unknown recte keys {sorted(unknown)}; "
                    f"allowed: {sorted(rec_fields)}")
            kv = {k: _coerce(v, getattr(cfg.recte, k))
                  for k, v in rec.items()}
            kv.setdefault("enabled", True)
            cfg.recte = dataclasses.replace(cfg.recte, **kv)
        else:
            cfg.recte = dataclasses.replace(
                cfg.recte, enabled=_coerce(rec, True))

    # program: a mapping of ProgramConfig fields (multi-visit runs;
    # run_program consumes it, run_visit simulates visit 0 only)
    prog = flat.pop("program", None)
    if prog is not None:
        if not isinstance(prog, Mapping):
            raise ValueError("'program' must be a mapping of "
                             "ProgramConfig fields")
        prog_fields = {f.name for f in dataclasses.fields(ProgramConfig)}
        unknown = set(prog) - prog_fields
        if unknown:
            raise ValueError(
                f"unknown program keys {sorted(unknown)}; "
                f"allowed: {sorted(prog_fields)}")
        kv = {}
        for k, v in prog.items():
            if k == "visit_start_mjds":
                kv[k] = None if v is None else tuple(float(x) for x in v)
            else:
                kv[k] = _coerce(v, getattr(cfg.program, k))
        cfg.program = dataclasses.replace(cfg.program, **kv)

    calib_fields = {f.name for f in dataclasses.fields(CalibrationConfig)}
    unknown_cal = set(calib_kv) - calib_fields
    if unknown_cal:
        # Unlike the reference's ignore-unknown-keys convention, a typo
        # here silently reverts a "real products" run to synthetic
        # calibration — fail loudly instead.
        raise ValueError(
            f"unknown calibration keys {sorted(unknown_cal)}; "
            f"allowed: {sorted(calib_fields)}")
    for key, value in calib_kv.items():
        if value in (None, ""):   # commented-out / empty entry: keep default
            continue
        setattr(cfg.calibration, key, str(value))

    catalog_file = flat.pop("catalog_file", None) or flat.pop(
        "exodata_location", None)
    catalog = None
    if catalog_file:
        from wayne_tpu_torch.models.planet import load_catalog

        catalog = load_catalog(str(catalog_file))

    noise_fields = {f.name for f in dataclasses.fields(NoiseFlags)}
    noise_updates: dict[str, bool] = {}
    for key, value in list(flat.items()):
        if key in _NOISE_KEY_ALIASES:
            if isinstance(value, bool) or value in (0, 1):
                noise_updates[_NOISE_KEY_ALIASES[key]] = bool(value)
                del flat[key]
            else:
                # A non-boolean here silently simulates the WRONG noise
                # chain (the ignore-unknown-keys fallthrough would drop
                # it) — fail loudly like the nested noise: block does.
                raise ValueError(
                    f"noise flag {key!r} must be a boolean or a mapping "
                    f"of flag names, got {value!r}")
    # noise: {preset: none|all} rebases the flags before per-key
    # overrides (a clean way to say "only these effects" in YAML)
    preset = noise_kv.pop("preset", None)
    base_noise = cfg.noise
    if preset is not None:
        if str(preset) == "none":
            base_noise = NoiseFlags.none()
        elif str(preset) == "all":
            base_noise = NoiseFlags.all()
        else:
            raise ValueError(f"unknown noise preset {preset!r}; "
                             "allowed: 'none', 'all'")
    unknown_noise = {k for k in noise_kv
                     if _NOISE_KEY_ALIASES.get(k, k) not in noise_fields}
    if unknown_noise:
        # A typo here silently simulates the WRONG noise chain — fail
        # loudly (same convention as the calibration: block).
        raise ValueError(
            f"unknown noise keys {sorted(unknown_noise)}; allowed: "
            f"{sorted(noise_fields)} (+ 'preset')")
    for key, value in noise_kv.items():
        noise_updates[_NOISE_KEY_ALIASES.get(key, key)] = bool(value)
    if noise_updates or preset is not None:
        cfg.noise = dataclasses.replace(base_noise, **noise_updates)

    explicit: set[tuple[str | None, str]] = set()

    def assign(section: str | None, name: str, value) -> None:
        if section == "calibration":
            # same semantics as the calibration: block — a commented-out
            # (None/empty) entry keeps the synthetic default, and paths
            # are always strings
            if value in (None, ""):
                return
            value = str(value)
        # Reference x_shifts/y_shifts accept either a drift rate (scalar)
        # or an explicit per-exposure offset list.
        if (name in ("drift_x_per_exp", "drift_y_per_exp")
                and isinstance(value, (list, tuple))):
            name = ("x_shift_list" if name == "drift_x_per_exp"
                    else "y_shift_list")
            value = tuple(float(v) for v in value)
        # Reference exp_start_times: a scalar is the visit start; a LIST
        # is the per-exposure schedule, taken verbatim by the planner.
        if name == "start_mjd" and isinstance(value, (list, tuple)):
            name = "exp_start_mjd_list"
        if name == "exp_start_mjd_list" and value is not None:
            value = tuple(float(v) for v in value)
        obj = cfg if section is None else getattr(cfg, section)
        setattr(obj, name, _coerce(value, getattr(obj, name)))
        explicit.add((section, name))

    # section-scoped keys first: the block they came from wins
    for sec, key, value in sectioned:
        if hasattr(getattr(cfg, sec), key):
            assign(sec, key, value)
            continue
        alias = _REF_KEY_ALIASES.get(key)
        if alias is not None and alias[0] == sec:
            assign(sec, alias[1], value)
            continue
        # not a field of this section — generic routing below (explicit
        # top-level keys still take precedence over leaked ones)
        flat.setdefault(key, value)

    for key, value in flat.items():
        if (key == "start_JD" and isinstance(value, (int, float))
                and value > 2400000.0):
            # a true Julian Date: convert to the MJD the planner uses
            # (EXPSTART headers and catalog t0 are MJD)
            value = float(value) - 2400000.5
        section_field = _REF_KEY_ALIASES.get(key)
        if section_field is None:
            # Accept canonical field names directly on any section.
            if hasattr(cfg, key):
                section_field = (None, key)
            elif hasattr(cfg.star, key):
                section_field = ("star", key)
            elif hasattr(cfg.planet, key):
                section_field = ("planet", key)
            elif hasattr(cfg.trends, key):
                section_field = ("trends", key)
            elif key in calib_fields:
                section_field = ("calibration", key)
            else:
                continue  # unknown keys are ignored, like the reference
        assign(*section_field, value)

    if ("planet", "name") in explicit:
        _resolve_planet_name(cfg, explicit, catalog)
    return cfg


def load_yaml(path: str) -> ObservationConfig:
    """Load a parameter file (reference: ``wayne -p parfile.yml``)."""
    import yaml

    with open(path) as fh:
        params = yaml.safe_load(fh) or {}
    if not isinstance(params, Mapping):
        raise ValueError(f"parameter file {path!r} must contain a mapping")
    return config_from_dict(params)

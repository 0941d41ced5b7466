"""Calibration tables for the WFC3 IR grisms and detector (torch port).

A copy of the JAX package's ``calibration`` module: the synthetic tables are
built by the same fixed-seed NumPy code (``RandomState``), so every leaf
equals the JAX package's to float32 rounding, and then handed to torch as
float32 tensors on the requested device. The loaders of real STScI products
(aXe conf, sensitivity table, flat cube, master and helium sky,
non-linearity cube, QE or DQ-bit plane) follow the JAX package's.

Unit conventions: see :mod:`wayne_tpu_torch.config`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

FULL_FRAME = 1024          # WFC3 IR detector edge (incl. 5-px reference border)
PIXEL_AREA_CM2 = (18e-4) ** 2  # 18 um HgCdTe pixels
J_ZERO_POINT_FLAM_UM = 3.13e-6  # erg/s/cm^2/um at 1.25 um for m_J = 0


# ---------------------------------------------------------------------------
# Grism geometry: aXe-style field-dependent 2D polynomials
# ---------------------------------------------------------------------------
#
# aXe convention (reference: wayne/grism.py trace construction): for a source
# at direct-image position (x_ref, y_ref) in full-frame pixels, the +1st order
# spectrum follows
#     dy(x)   = DYDX_A_0(x_ref, y_ref) + DYDX_A_1(x_ref, y_ref) * (x - x_ref)
#     lambda  = DLDP_A_0(x_ref, y_ref) + DLDP_A_1(x_ref, y_ref) * d
# with d the path length along the trace from the reference point, and each
# coefficient a 2D polynomial in (x_ref, y_ref):
#     c(x, y) = a0 + a1*x + a2*y + a3*x^2 + a4*x*y + a5*y^2
# We carry all coefficients as 6-vectors in that ordering.

_POLY2D_NTERMS = 6


def eval_field_poly(coeffs: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Evaluate an aXe field-dependent coefficient at (x, y) [full-frame px]."""
    return (coeffs[0] + coeffs[1] * x + coeffs[2] * y
            + coeffs[3] * x * x + coeffs[4] * x * y + coeffs[5] * y * y)


# Synthetic defaults approximating the public aXe WFC3 IR calibration
# (G141: WFC3.IR.G141.V2.5.conf; G102: WFC3.IR.G102.V2.0.conf). Wavelengths
# here are in MICRON (aXe files use Angstrom; loaders convert).
_GRISM_DEFAULTS: dict[str, dict[str, Any]] = {
    "G141": dict(
        wl_min=1.075, wl_max=1.70,
        dydx0=[1.96882, 9.09159e-5, -1.93260e-3, 0.0, 0.0, 0.0],
        dydx1=[1.04275e-2, -7.96978e-6, -2.49607e-6, 0.0, 0.0, 0.0],
        dldp0=[0.8949513, 8.6331e-8, 2.17086e-6, 0.0, 0.0, 0.0],
        dldp1=[4.466487e-3, 4.4568e-10, -9.3373e-8, 0.0, 0.0, 0.0],
        sens_peak=1.45e16,      # (e-/s) per (erg/s/cm^2/A); first-principles
        sens_center=1.39, sens_width=0.29,
        psf_fwhm_lo=1.00, psf_fwhm_hi=1.40,   # px across the bandpass
        # Optional contaminating beams (aXe BEAM B/C): 0th-order spot
        # offset from the direct-image position and relative throughputs.
        # Synthetic-calibration approximations (docs/CALIBRATION.md) — the
        # reference models the +1st order only.
        beam0_dx=-207.0, beam0_rel=0.008, beam2_rel=0.010,
    ),
    "G102": dict(
        wl_min=0.80, wl_max=1.15,
        dydx0=[-3.55018e-1, 3.28722e-5, -1.44571e-3, 0.0, 0.0, 0.0],
        dydx1=[1.17012e-2, -2.53734e-6, -6.34263e-7, 0.0, 0.0, 0.0],
        dldp0=[0.6344081, 2.9426e-7, 1.2513e-6, 0.0, 0.0, 0.0],
        dldp1=[2.382368e-3, 5.2037e-10, -5.8282e-8, 0.0, 0.0, 0.0],
        sens_peak=1.15e16,
        sens_center=0.98, sens_width=0.16,
        psf_fwhm_lo=0.95, psf_fwhm_hi=1.20,
        beam0_dx=-252.0, beam0_rel=0.006, beam2_rel=0.012,
    ),
}

GRISM_NAMES = tuple(_GRISM_DEFAULTS)


# ---------------------------------------------------------------------------
# Detector: sample sequences
# ---------------------------------------------------------------------------

# Minimum (RAPID) frame time per subarray, seconds (WFC3 IR handbook §7.7).
RAPID_FRAME_TIME = {1024: 2.932, 512: 0.853, 256: 0.278, 128: 0.113, 64: 0.061}

_SPARS_DT = {"SPARS5": 5.0, "SPARS10": 10.0, "SPARS25": 25.0,
             "SPARS50": 50.0, "SPARS100": 100.0, "SPARS200": 200.0}
_STEP_MAX = {"STEP25": 25.0, "STEP50": 50.0, "STEP100": 100.0,
             "STEP200": 200.0, "STEP400": 400.0}
# STEP sequences take 4 frame-time reads, then one 12.5 s interval doubling
# up to the sequence's cap, then constant-cap intervals (full-frame timing,
# WFC3 IR Instrument Handbook appendix D sequence tables).
_STEP_RAMP = (12.5, 25.0, 50.0, 100.0, 200.0, 400.0)
_STEP_NRAPID = 4

# Override registry populated by load_sequence_table(): maps
# (SEQ, subarray) -> cumulative sample times for reads 0..15.
_SEQUENCE_OVERRIDES: dict[tuple[str, int], np.ndarray] = {}


def _full_frame_intervals(seq: str, nsamp: int) -> list[float]:
    """Read-to-read intervals at FULL FRAME for reads 1..nsamp (seconds).

    These reproduce the published WFC3 IR Instrument Handbook sequence
    tables (§7.7 / appendix D): RAPID is uniform frame-time spacing;
    SPARSn is one frame time then exactly n-second spacing; STEPn is four
    frame-time reads, then 12.5 s doubling up to n, then constant n.
    """
    t_ff = RAPID_FRAME_TIME[FULL_FRAME]
    if seq == "RAPID":
        return [t_ff] * nsamp
    if seq in _SPARS_DT:
        return [t_ff] + [_SPARS_DT[seq]] * (nsamp - 1)
    if seq in _STEP_MAX:
        cap = _STEP_MAX[seq]
        ramp = [min(r, cap) for r in _STEP_RAMP if r <= cap] or [cap]
        out = [t_ff] * min(_STEP_NRAPID, nsamp)
        k = 0
        while len(out) < nsamp:
            out.append(ramp[min(k, len(ramp) - 1)])
            k += 1
        return out
    raise ValueError(f"unknown sample sequence {seq!r}")


def sample_sequence_times(samp_seq: str, nsamp: int, subarray: int) -> np.ndarray:
    """Times of reads 0..NSAMP (s after exposure start), read 0 at t=0.

    Sequence timing follows the published WFC3 IR handbook structure
    (reference: wayne/detector.py tabulated read times, SURVEY.md §8):
    the sequences are DEFINED at full frame (SPARS10 = exactly 10 s
    between full-frame reads), and the inter-read *wait* is what the
    sequencer holds fixed — so a subarray interval is
    ``wait + subarray_frame_time`` with ``wait = interval - 2.932``.
    This reproduces the published anchor values to ~10 ms — e.g.
    GRISM256 SPARS10 NSAMP=15 EXPTIME = 103.122 s here vs the published
    103.129 s (the handbook frame times are quoted to the ms, so the
    per-read wait carries sub-ms truncation). The STRUCTURE (uniform
    RAPID, SPARS first-frame+n-second, STEP ramp) is exact; for
    per-microsecond parity with real ima SAMPTIME/DELTATIM load the
    exact STScI tables over this seam with :func:`load_sequence_table`
    — loaded tables take precedence.
    """
    if subarray not in RAPID_FRAME_TIME:
        raise ValueError(f"unknown subarray {subarray}")
    if not 1 <= nsamp <= 15:
        raise ValueError("NSAMP must be 1..15")
    seq = samp_seq.upper()
    override = _SEQUENCE_OVERRIDES.get((seq, subarray))
    if override is not None:
        if len(override) < nsamp + 1:
            raise ValueError(
                f"loaded table for {seq}/{subarray} has only "
                f"{len(override) - 1} reads; NSAMP={nsamp} requested")
        return np.asarray(override[: nsamp + 1], dtype=np.float64)
    t_frame = RAPID_FRAME_TIME[subarray]
    t_ff = RAPID_FRAME_TIME[FULL_FRAME]
    intervals = _full_frame_intervals(seq, nsamp)
    # Convert full-frame intervals to this subarray: keep the wait, swap
    # the frame-read time. (At full frame this is the identity.)
    times = [0.0]
    for dt_ff in intervals:
        times.append(times[-1] + (dt_ff - t_ff) + t_frame)
    return np.asarray(times, dtype=np.float64)


def exptime(samp_seq: str, nsamp: int, subarray: int) -> float:
    """Total exposure time (reference: wayne/detector.py :: exptime)."""
    return float(sample_sequence_times(samp_seq, nsamp, subarray)[-1])


def load_sequence_table(path: str) -> None:
    """Load exact STScI sample-sequence timing tables from a JSON file.

    Format: ``{"SPARS10/256": [0.0, 0.278649, 7.625587, ...], ...}`` —
    keys are ``SEQ/subarray``, values cumulative sample times (seconds)
    for reads 0..N. Loaded tables override the built-in handbook model
    in :func:`sample_sequence_times` for exact per-microsecond parity
    with real ima headers (SAMPTIME/DELTATIM).
    """
    import json

    with open(path) as fh:
        raw = json.load(fh)
    # Validate EVERYTHING before touching the process-global registry:
    # raising mid-loop would leave a half-loaded registry that silently
    # changes timing for later visits in the process.
    staged: dict[tuple[str, int], np.ndarray] = {}
    for key, vals in raw.items():
        seq, sep, sub = key.partition("/")
        if not sep or not sub.isdigit():
            raise ValueError(
                f"bad sequence-table key {key!r}: expected 'SEQ/subarray' "
                "(e.g. 'SPARS10/256')")
        arr = np.asarray(vals, dtype=np.float64)
        if arr.ndim != 1 or len(arr) < 2 or arr[0] != 0.0 or np.any(np.diff(arr) <= 0):
            raise ValueError(f"bad sequence table for {key!r}: need "
                             "strictly increasing cumulative times from 0.0")
        staged[(seq.upper(), int(sub))] = arr
    _SEQUENCE_OVERRIDES.update(staged)


@contextlib.contextmanager
def sequence_tables_scope(path: str | None):
    """Scope loaded sequence tables to a ``with`` block.

    :func:`load_sequence_table` writes a process-global registry; this
    context manager loads ``path`` (no-op if empty) and restores the
    registry's previous state on exit, so one visit's custom timing can
    never leak into an unrelated later visit in the same process. Every
    timing-dependent derivation (grism read_times, exposure_static auto
    sizing, the visit plan) must happen inside the block.
    """
    if not path:
        yield
        return
    saved = dict(_SEQUENCE_OVERRIDES)
    try:
        # inside the try: a malformed file can raise after registering
        # its first entries — the restore must still run
        load_sequence_table(path)
        yield
    finally:
        _SEQUENCE_OVERRIDES.clear()
        _SEQUENCE_OVERRIDES.update(saved)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@dataclass
class Tables:
    """Every tensor the exposure simulation needs, on one device.

    Shapes: S = subarray edge, NL = spectral bins, NR = nsamp + 1. Scalars
    are 0-dim tensors. Field meanings follow the JAX package's ``Tables``.
    """

    wl_edges: torch.Tensor      # (NL+1,) bin edges, micron
    wl_centers: torch.Tensor    # (NL,)
    sensitivity: torch.Tensor   # (NL,) (e-/s) per (erg/s/cm^2/A)
    psf_sigma: torch.Tensor     # (NL,) cross-dispersion Gaussian sigma, px
    dydx0: torch.Tensor         # (6,) field poly -> trace intercept offset
    dydx1: torch.Tensor         # (6,) field poly -> trace slope
    dldp0: torch.Tensor         # (6,) field poly -> wavelength zero point (um)
    dldp1: torch.Tensor         # (6,) field poly -> dispersion (um / px)
    flat_coeffs: torch.Tensor   # (4, S, S) wavelength-dependent flat cube
    sky_frame: torch.Tensor     # (S, S) master sky, mean 1
    active_mask: torch.Tensor   # (S, S) 1 = photosensitive; 0 = reference px
    gain_map: torch.Tensor      # (S, S) e-/DN
    dark_map: torch.Tensor      # (S, S) e-/s
    bias_map: torch.Tensor      # (S, S) zeroth-read pedestal, e-
    qe_map: torch.Tensor        # (S, S) relative QE (source response only)
    nonlin_coeffs: torch.Tensor  # (3, S, S) per-pixel cubic planes
    beam0_dx: torch.Tensor      # 0th-order spot offset from x_ref (px)
    beam0_rel: torch.Tensor     # 0th-order relative throughput
    beam2_rel: torch.Tensor     # 2nd-order relative throughput
    read_times: torch.Tensor    # (NR,) s from exposure start
    gain: torch.Tensor          # nominal e-/DN
    read_noise_e: torch.Tensor  # CDS-equivalent per-read noise, e-
    bias_drift_e: torch.Tensor  # RMS per-read per-amplifier bias drift, e-
    full_well_e: torch.Tensor   # saturation, e-
    cr_rate_px_s: torch.Tensor  # cosmic-ray events / px / s
    cr_mean_e: torch.Tensor     # mean CR deposit, e-
    ipc_alpha: torch.Tensor     # nearest-neighbour IPC coupling fraction
    subarray_corner: torch.Tensor  # (2,) (x0, y0) of subarray in full frame
    sky_he_frame: torch.Tensor | None = None  # (S, S) He 1.083 um airglow
    rts_amp: torch.Tensor | None = None  # (S, S) unstable-pixel amplitude

    @property
    def device(self) -> torch.device:
        return self.wl_edges.device

    @functools.cached_property
    def readout_consts(self) -> tuple[float, float, float, float]:
        """(read_noise_e, full_well_e, gain, ipc_alpha) as host floats, read
        back from the device once per Tables, so that the readout's launches
        never wait on the card."""
        return tuple(torch.stack([self.read_noise_e, self.full_well_e,
                                  self.gain, self.ipc_alpha]).tolist())


def subarray_corner(subarray: int) -> tuple[int, int]:
    """Centered subarray placement in the 1024^2 full frame."""
    c = (FULL_FRAME - subarray) // 2
    return (c, c)


def quadrant_map(subarray: int, corner=None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """(S, S) int64 amplifier-quadrant index (0..3) of each subarray pixel:
    quad = 2*(global_y >= 512) + (global_x >= 512), as in the JAX
    package. ``corner``: (x0, y0) of the subarray (a tuple or a (2,)
    tensor); None = centered placement."""
    if corner is None:
        corner = subarray_corner(subarray)
    half = FULL_FRAME // 2
    ar = torch.arange(subarray, dtype=torch.float32, device=device)
    gx = corner[0] + ar
    gy = corner[1] + ar
    return ((gy[:, None] >= half).long() * 2 + (gx[None, :] >= half).long())


def synthetic_tables(
    grism: str = "G141",
    subarray: int = 512,
    n_lambda: int = 512,
    samp_seq: str = "SPARS10",
    nsamp: int = 15,
    *,
    calib_seed: int = 1234,
    read_noise_e: float = 20.0,
    dark_e_s: float = 0.048,
    full_well_e: float = 78000.0,
    gain: float = 2.5,
    nonlin_frac: float = 0.04,
    cr_rate_cm2_s: float = 11.0,
    cr_mean_e: float = 1000.0,
    ipc_alpha: float = 0.015,
    bias_drift_e: float = 3.0,
    dead_frac: float = 0.0,
    n_blobs: int = 0,
    blob_atten: float = 0.12,
    rts_frac: float = 0.0,
    rts_amplitude: float = 0.08,
    dtype=torch.float32,
    device: torch.device | str = "cpu",
) -> Tables:
    """A complete synthetic Tables, built by the JAX package's NumPy code
    (same fixed seeds, same streams), of ``dtype`` (a torch or NumPy
    dtype) on ``device``."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    if grism not in _GRISM_DEFAULTS:
        raise ValueError(f"unknown grism {grism!r}; have {GRISM_NAMES}")
    g = _GRISM_DEFAULTS[grism]
    rng = np.random.RandomState(calib_seed)
    S = subarray

    # Wavelength grid spanning the bandpass.
    wl_edges = np.linspace(g["wl_min"], g["wl_max"], n_lambda + 1)
    wl = 0.5 * (wl_edges[:-1] + wl_edges[1:])

    # Sensitivity: smooth super-Gaussian bell with softened blue/red cutoffs —
    # shape mimics the STScI first-order sensitivity curves.
    x = (wl - g["sens_center"]) / g["sens_width"]
    sens = g["sens_peak"] * np.exp(-0.5 * x ** 4)
    edge = 0.02 * (g["wl_max"] - g["wl_min"])
    sens *= 0.5 * (1 + np.tanh((wl - g["wl_min"] - 2 * edge) / edge))
    sens *= 0.5 * (1 + np.tanh((g["wl_max"] - 2 * edge - wl) / edge))

    # PSF width: linear FWHM growth across the bandpass (WFC3 ISR values).
    frac = (wl - g["wl_min"]) / (g["wl_max"] - g["wl_min"])
    fwhm = g["psf_fwhm_lo"] + (g["psf_fwhm_hi"] - g["psf_fwhm_lo"]) * frac
    psf_sigma = fwhm / 2.35482

    # Wavelength-dependent flat cube: smooth low-order structure + ~0.8% px RMS.
    yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    u, v = xx / S - 0.5, yy / S - 0.5
    c0 = (1.0 + 0.02 * np.sin(2 * np.pi * u) * np.cos(np.pi * v)
          - 0.015 * (u ** 2 + v ** 2) + 0.008 * rng.standard_normal((S, S)))
    c1 = 0.01 * np.cos(2 * np.pi * v) + 0.002 * rng.standard_normal((S, S))
    c2 = 0.003 * np.sin(3 * np.pi * u * v) + 5e-4 * rng.standard_normal((S, S))
    c3 = 2e-4 * rng.standard_normal((S, S))
    flat_coeffs = np.stack([c0, c1, c2, c3])

    # Master sky: smooth gradient + faint structure, normalised to mean 1.
    sky = 1.0 + 0.08 * u + 0.05 * v + 0.02 * np.sin(4 * np.pi * u) * np.sin(3 * np.pi * v)
    sky /= sky.mean()

    # He 1.083 um airglow pattern: the dispersed airglow line maps to a
    # different detector footprint than the zodi/earthshine continuum
    # (in real G102/G141 sky products the helium image has its own
    # spatial structure — STScI distributes it as a separate frame).
    # Synthetic stand-in: a smooth pattern distinct from the master sky,
    # normalised to mean 1.
    sky_he = 1.0 + 0.15 * np.cos(np.pi * u) - 0.10 * v
    sky_he /= sky_he.mean()

    # Gain map: quadrant offsets + 0.3% pixel RMS around the nominal gain.
    quad = (0.01 * ((xx >= S // 2).astype(float) - 0.5)
            + 0.008 * ((yy >= S // 2).astype(float) - 0.5))
    gain_map = gain * (1.0 + quad + 0.003 * rng.standard_normal((S, S)))

    # Dark map: log-normal-ish pixel distribution around the nominal rate,
    # with a sparse population of hot pixels.
    dark_map = dark_e_s * np.exp(0.25 * rng.standard_normal((S, S)))
    hot = rng.rand(S, S) < 3e-4
    dark_map = np.where(hot, dark_map * rng.uniform(20, 200, (S, S)), dark_map)

    # Bias / zeroth-read pedestal (e-): smooth plus pixel offsets.
    bias_map = 2500.0 + 40.0 * np.sin(2 * np.pi * u) + 12.0 * rng.standard_normal((S, S))

    # Per-pixel cubic non-linearity planes (c1, c2, c3): the measured
    # charge is Q * (1 - (c1 q + c2 q^2 + c3 q^3)), q = min(Q, fw)/fw —
    # the forward model of the cubic-per-pixel correction calwf3 applies
    # (reference: wayne/detector.py :: apply_non_linearity; SURVEY.md §8
    # "non-linearity ~ few % near saturation, corrected by cubic
    # polynomial per pixel"). Coefficients sum to ~nonlin_frac at full
    # well with a few-% pixel-to-pixel spread.
    base = np.array([0.30, 0.30, 0.40]) * nonlin_frac
    nonlin_coeffs = base[:, None, None] * (
        1.0 + 0.03 * rng.standard_normal((3, S, S)))

    # Reference-pixel border: the outer 5 px of the 1024^2 detector are
    # photo-insensitive (bias/read-noise only). Centered subarrays sit in
    # the detector interior, so the border appears only in full frame.
    active = np.ones((S, S), np.float64)
    if subarray == FULL_FRAME:
        b = 5
        active[:b, :] = 0.0
        active[-b:, :] = 0.0
        active[:, :b] = 0.0
        active[:, -b:] = 0.0

    # Relative-QE defect plane: dead pixels + IR blobs (docstring above).
    # Separate fixed-seed stream: toggling defects must not re-deal the
    # flat/gain/dark draws that the oracle-diff tests pin.
    qe = np.ones((S, S), np.float64)
    if dead_frac > 0.0 or n_blobs > 0:
        rng_qe = np.random.RandomState(calib_seed + 101)
        if dead_frac > 0.0:
            qe[rng_qe.rand(S, S) < dead_frac] = 0.0
        for _ in range(int(n_blobs)):
            cx, cy = rng_qe.uniform(0.08 * S, 0.92 * S, 2)
            radius = rng_qe.uniform(3.0, max(6.0, S / 30.0))
            depth = blob_atten * rng_qe.uniform(0.6, 1.0)
            r2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / radius ** 2
            # Flat-cored, sharp-edged dip (real blobs are round with
            # fairly uniform cores and soft ~few-px edges).
            qe *= 1.0 - depth * np.exp(-r2 ** 2)
        qe = np.clip(qe, 0.0, None)

    # Unstable (RTS) pixel population: per-pixel toggle amplitudes, own
    # fixed-seed stream (same independence rule as the QE defects).
    rts = None
    if rts_frac > 0.0:
        rng_rts = np.random.RandomState(calib_seed + 211)
        rts = np.where(rng_rts.rand(S, S) < rts_frac,
                       rts_amplitude * rng_rts.uniform(0.25, 1.0, (S, S)),
                       0.0)

    read_times = sample_sequence_times(samp_seq, nsamp, subarray)

    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    return Tables(
        wl_edges=f(wl_edges), wl_centers=f(wl), sensitivity=f(sens),
        psf_sigma=f(psf_sigma),
        dydx0=f(g["dydx0"]), dydx1=f(g["dydx1"]),
        dldp0=f(g["dldp0"]), dldp1=f(g["dldp1"]),
        flat_coeffs=f(flat_coeffs), sky_frame=f(sky),
        sky_he_frame=f(sky_he), active_mask=f(active),
        gain_map=f(gain_map), dark_map=f(dark_map), bias_map=f(bias_map),
        qe_map=f(qe), nonlin_coeffs=f(nonlin_coeffs),
        beam0_dx=f(g["beam0_dx"]), beam0_rel=f(g["beam0_rel"]),
        beam2_rel=f(g["beam2_rel"]),
        read_times=f(read_times), gain=f(gain),
        read_noise_e=f(read_noise_e),
        bias_drift_e=f(bias_drift_e), full_well_e=f(full_well_e),
        cr_rate_px_s=f(cr_rate_cm2_s * PIXEL_AREA_CM2),
        cr_mean_e=f(cr_mean_e), ipc_alpha=f(ipc_alpha),
        rts_amp=None if rts is None else f(rts),
        subarray_corner=f(subarray_corner(subarray)),
    )


# ---------------------------------------------------------------------------
# Imaging-filter tables (direct image)
# ---------------------------------------------------------------------------

IMAGING_FILTERS: dict[str, tuple[float, float, float]] = {
    "F140W": (1.31, 1.61, 1.15),
    "F139M": (1.35, 1.43, 1.05),
    "F130N": (1.296, 1.310, 0.95),
    "F126N": (1.258, 1.266, 0.95),
    "F105W": (0.90, 1.21, 1.10),
}


def imaging_tables(tables: Tables, filter_name: str = "F140W",
                   nsamp: int = 4, samp_seq: str = "RAPID") -> Tables:
    """Direct-image (undispersed imaging filter) tables derived from grism
    tables, so the direct image runs through the same detector chain as
    the spectra: trace flattened and dispersion collapsed onto
    (x_ref, y_ref), sensitivity replaced by the filter's smooth-edged
    bandpass, the flat collapsed at the filter pivot, and a short imaging
    sample sequence (the JAX package's recipe, in float64 NumPy)."""
    if filter_name not in IMAGING_FILTERS:
        raise ValueError(f"unknown imaging filter {filter_name!r}; "
                         f"have {sorted(IMAGING_FILTERS)}")
    wl_lo, wl_hi, rel_peak = IMAGING_FILTERS[filter_name]
    host = lambda t: t.detach().cpu().numpy().astype(np.float64)
    wl = host(tables.wl_centers)

    edge = max(0.15 * (wl_hi - wl_lo), float(wl[1] - wl[0]))
    window = (0.5 * (1 + np.tanh((wl - wl_lo) / edge))
              * 0.5 * (1 + np.tanh((wl_hi - wl) / edge)))
    sens = rel_peak * float(host(tables.sensitivity).max()) * window

    wl_edges = host(tables.wl_edges)
    wl_min, wl_max = float(wl_edges[0]), float(wl_edges[-1])
    l_piv = np.clip((0.5 * (wl_lo + wl_hi) - wl_min) / (wl_max - wl_min),
                    0.0, 1.0)
    c = host(tables.flat_coeffs)
    flat0 = c[0] + l_piv * (c[1] + l_piv * (c[2] + l_piv * c[3]))
    flat_collapsed = np.stack([flat0] + [np.zeros_like(flat0)] * 3)

    dev = tables.device
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                  dtype=torch.float32, device=dev)
    pivot = 0.5 * (wl_lo + wl_hi)
    subarray = tables.flat_coeffs.shape[-1]
    zeros6 = np.zeros(_POLY2D_NTERMS)
    # 1000 micron/px: the whole bandpass spans <1e-3 px -> undispersed.
    return dataclasses.replace(
        tables,
        sensitivity=f(sens),
        dydx0=f(zeros6), dydx1=f(zeros6),
        dldp0=f(np.r_[pivot, zeros6[1:]]),
        dldp1=f(np.r_[1000.0, zeros6[1:]]),
        flat_coeffs=f(flat_collapsed),
        read_times=f(sample_sequence_times(samp_seq, nsamp, subarray)),
    )


def nonlin_fw_deficit(tables: Tables) -> float:
    """Mean fractional charge deficit at full well (scalar summary), for
    the host-side DQ saturation ceiling."""
    return float(tables.nonlin_coeffs.double().sum(0).mean())


# ---------------------------------------------------------------------------
# Loader seams for real STScI products (the JAX package's recipes, read
# through this package's own FITS layer; tensors land on the Tables' device)
# ---------------------------------------------------------------------------


def load_axe_conf(path: str) -> dict[str, np.ndarray]:
    """Parse an aXe grism ``.conf`` file into field-poly coefficient vectors.

    Returns DYDX_A_0/1 and DLDP_A_0/1 as 6-vectors (wavelengths converted
    Angstrom -> micron). Only the +1st order (BEAM A) keys are read.
    """
    keys = ("DYDX_A_0", "DYDX_A_1", "DLDP_A_0", "DLDP_A_1")
    out: dict[str, np.ndarray] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split(";")[0].strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] in keys:
                vals = np.zeros(_POLY2D_NTERMS)
                given = np.asarray([float(v) for v in parts[1:]])
                vals[: len(given)] = given[:_POLY2D_NTERMS]
                if parts[0].startswith("DLDP"):
                    vals *= 1e-4  # Angstrom -> micron
                out[parts[0]] = vals
    missing = set(keys) - set(out)
    if missing:
        raise ValueError(f"aXe conf {path!r} missing keys: {sorted(missing)}")
    return out


def load_sensitivity_ascii(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load a two-column (wavelength[um or A], sensitivity) ASCII table."""
    data = np.loadtxt(path)
    wl, sens = data[:, 0], data[:, 1]
    if wl.max() > 100.0:  # heuristically Angstrom
        wl = wl * 1e-4
    return wl, sens


def _subarray_cutout(plane: np.ndarray, subarray: int) -> np.ndarray:
    """Centered subarray cutout of a full-frame calibration plane."""
    if plane.shape[0] == subarray:
        return plane
    if plane.shape[0] < subarray:
        raise ValueError(
            f"calibration plane {plane.shape} smaller than subarray {subarray}")
    c0 = (plane.shape[0] - subarray) // 2
    return plane[c0: c0 + subarray, c0: c0 + subarray]


def _fits_planes(path: str) -> list[np.ndarray]:
    """The image planes of a FITS file: the slices of a single 3-D array,
    else every HDU's array in order."""
    from wayne_tpu_torch.io.fits import read_fits

    arrays = [d for _, d in read_fits(path) if d is not None]
    if len(arrays) == 1 and arrays[0].ndim == 3:
        return list(arrays[0])
    return arrays


def _first_plane(path: str) -> np.ndarray:
    """The first 2-D image of a FITS file."""
    from wayne_tpu_torch.io.fits import read_fits

    return next(d for _, d in read_fits(path)
                if d is not None and d.ndim == 2)


def load_flat_cube_fits(path: str, subarray: int) -> np.ndarray:
    """Load a wavelength-dependent flat-field cube FITS (4 coefficient
    planes, as WFC3.IR.G141.flat.2.fits): one 3-D (4, N, N) primary array
    or 4 image HDUs; missing planes are zero."""
    planes = _fits_planes(path)
    planes = (planes + [np.zeros_like(planes[0])] * 4)[:4]
    return np.stack([_subarray_cutout(np.asarray(p, np.float64), subarray)
                     for p in planes])


def load_master_sky_fits(path: str, subarray: int) -> np.ndarray:
    """Load a master-sky frame FITS, normalised to mean 1."""
    sky = _subarray_cutout(np.asarray(_first_plane(path), np.float64),
                           subarray)
    return sky / sky.mean()


def load_nonlin_cube_fits(path: str, subarray: int) -> np.ndarray:
    """Load per-pixel non-linearity coefficient planes from a FITS cube: a
    (3, N, N) primary array or 3 image HDUs, the (c1, c2, c3) planes of the
    forward cubic deficit in normalised charge."""
    planes = _fits_planes(path)
    if len(planes) != 3:
        raise ValueError(
            f"non-linearity cube {path!r} must carry 3 coefficient planes "
            f"(c1, c2, c3); found {len(planes)}")
    return np.stack([_subarray_cutout(np.asarray(p, np.float64), subarray)
                     for p in planes])


def _on(tables: Tables, a: np.ndarray) -> torch.Tensor:
    """A float32 tensor of ``a`` on the Tables' device."""
    return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                           device=tables.device)


def with_loaded_nonlin(tables: Tables, path: str) -> Tables:
    """Override the synthetic non-linearity planes with a real cube."""
    subarray = tables.flat_coeffs.shape[-1]
    return dataclasses.replace(
        tables, nonlin_coeffs=_on(tables, load_nonlin_cube_fits(path,
                                                                subarray)))


def with_loaded_qe(tables: Tables, path: str) -> Tables:
    """Override the synthetic relative-QE defect plane with a real one.

    Accepts a float plane (relative QE: 1 nominal, 0 dead, fractional in
    blobs) or an integer DQ-bit plane like the STScI bad-pixel tables (bit
    4 = dead -> QE 0; bit 512 = blob -> QE 0.88). Float planes must be
    RELATIVE QE (the DQ planes flag blob at QE < 0.98, dead at < 0.05): a
    median off 1 by more than 5% is renormalised by the median with a
    warning, and a plane that still flags more than 5% of the pixels
    warns. Full-frame planes are cut to the subarray.
    """
    plane = np.asarray(_first_plane(path))
    if np.issubdtype(plane.dtype, np.integer):
        bits = plane.astype(np.int64)
        qe = np.ones(plane.shape, np.float64)
        qe[(bits & 512) != 0] = 0.88
        qe[(bits & 4) != 0] = 0.0
    else:
        qe = np.clip(np.asarray(plane, np.float64), 0.0, None)
        med = float(np.median(qe))
        if med <= 0.0:
            raise ValueError(
                f"QE plane {path!r} has non-positive median ({med:g}) — "
                "not a usable relative-QE or DQ-bit plane")
        if not 0.95 <= med <= 1.05:
            warnings.warn(
                f"QE plane {path!r} has median {med:.3f}; treating it as "
                "an absolute plane and renormalising by the median so "
                "nominal pixels sit at ~1 (static_dq_plane flags "
                "QE < 0.98 as blob)", stacklevel=2)
            qe = qe / med
        frac_flagged = float((qe < 0.98).mean())
        if frac_flagged > 0.05:
            warnings.warn(
                f"QE plane {path!r}: {frac_flagged:.1%} of pixels sit "
                "below the 0.98 blob-flag threshold — the DQ-aware "
                "reduction will mask all of them; check the plane is "
                "relative QE (1 = nominal)", stacklevel=2)
    qe = _subarray_cutout(qe, tables.flat_coeffs.shape[-1])
    return dataclasses.replace(tables, qe_map=_on(tables, qe))


def with_loaded_grism(tables: Tables, conf_path: str | None = None,
                      sens_path: str | None = None,
                      flat_path: str | None = None,
                      sky_path: str | None = None,
                      sky_he_path: str | None = None) -> Tables:
    """Override synthetic grism calibration with real STScI products: the
    aXe trace and dispersion, the sensitivity (interpolated onto the
    wavelength grid in float64, zero outside the table), the flat cube and
    the master and helium sky frames."""
    updates: dict[str, torch.Tensor] = {}
    subarray = tables.flat_coeffs.shape[-1]
    if conf_path is not None:
        conf = load_axe_conf(conf_path)
        updates.update(dydx0=_on(tables, conf["DYDX_A_0"]),
                       dydx1=_on(tables, conf["DYDX_A_1"]),
                       dldp0=_on(tables, conf["DLDP_A_0"]),
                       dldp1=_on(tables, conf["DLDP_A_1"]))
    if sens_path is not None:
        wl, sens = load_sensitivity_ascii(sens_path)
        wl_c = tables.wl_centers.cpu().numpy()
        updates["sensitivity"] = _on(
            tables, np.interp(wl_c, wl, sens, left=0.0, right=0.0))
    if flat_path is not None:
        updates["flat_coeffs"] = _on(tables,
                                     load_flat_cube_fits(flat_path, subarray))
    if sky_path is not None:
        updates["sky_frame"] = _on(tables,
                                   load_master_sky_fits(sky_path, subarray))
    if sky_he_path is not None:
        # STScI distributes the helium airglow image as its own sky
        # component (same FITS layout as the master sky)
        updates["sky_he_frame"] = _on(
            tables, load_master_sky_fits(sky_he_path, subarray))
    return dataclasses.replace(tables, **updates)

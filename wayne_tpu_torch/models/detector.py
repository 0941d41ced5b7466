"""WFC3 IR detector model (port of the JAX package's ``models/detector``;
reference: wayne/detector.py :: WFC3_IRDetector).

Host-side handle for detector geometry, sample-sequence timing and noise
constants. The per-pixel maps live in the Tables (built by
calibration.synthetic_tables); this class exposes the reference-style
query API (exptime, get_read_times, subarray geometry).
"""

from __future__ import annotations

import numpy as np

from wayne_tpu_torch import calibration as cal


class WFC3IRDetector:
    """Geometry + timing of the WFC3 IR channel (HgCdTe 1024^2)."""

    full_frame = cal.FULL_FRAME
    reference_border_px = 5
    plate_scale_arcsec = 0.121
    pixel_area_cm2 = cal.PIXEL_AREA_CM2

    def __init__(self, subarray: int = 512, gain: float = 2.5,
                 read_noise_e: float = 20.0, dark_e_s: float = 0.048,
                 full_well_e: float = 78000.0):
        if subarray not in cal.RAPID_FRAME_TIME:
            raise ValueError(f"invalid subarray {subarray}")
        self.subarray = subarray
        self.gain = gain
        self.read_noise_e = read_noise_e
        self.dark_e_s = dark_e_s
        self.full_well_e = full_well_e

    # -- timing (reference: Detector.exptime / get_read_times) -----------

    def get_read_times(self, nsamp: int, samp_seq: str) -> np.ndarray:
        return cal.sample_sequence_times(samp_seq, nsamp, self.subarray)

    def exptime(self, nsamp: int, samp_seq: str) -> float:
        return cal.exptime(samp_seq, nsamp, self.subarray)

    def min_frame_time(self) -> float:
        return cal.RAPID_FRAME_TIME[self.subarray]

    # -- geometry ---------------------------------------------------------

    def subarray_corner(self) -> tuple[int, int]:
        return cal.subarray_corner(self.subarray)

    def arcsec_to_pix(self, arcsec: float) -> float:
        return arcsec / self.plate_scale_arcsec

    def pix_to_arcsec(self, pix: float) -> float:
        return pix * self.plate_scale_arcsec

    # -- scan helpers -------------------------------------------------------

    def scan_length_px(self, scan_speed_pix_s: float, nsamp: int,
                       samp_seq: str) -> float:
        """Rows swept during one exposure at the given scan rate."""
        return abs(scan_speed_pix_s) * self.exptime(nsamp, samp_seq)

"""WFC3 ``ima``-style multi-read FITS product (reference: wayne/exposure.py
:: Exposure.add_read / generate_fits).

Layout matches the real instrument product so standard WFC3 reduction
pipelines (Iraclis et al.) accept the files:

  - Primary HDU: no data, full WFC3 keyword block (TARGNAME, EXPSTART,
    NSAMP, SAMP_SEQ, SUBTYPE, APERTURE, FILTER, SCAN_RAT, ...).
  - Per read, stored in REVERSE time order (last read first, EXTVER 1 =
    final read): SCI, ERR, DQ, SAMP, TIME image extensions.

Units: SCI planes are detector DN (the simulator's raw output). ERR is the
propagated shot+read-noise estimate (the shot term covers source + sky +
dark — everything Poissonian in the measured signal above the bias
pedestal). DQ carries WFC3 flag bits: cosmic rays (8192, cumulative from
the hit read onward), saturation (256), hot pixels (16) and full-frame
reference pixels (128). SAMP holds the read index, TIME the sample time.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from wayne_tpu_torch.io.fits import FitsHDU, read_fits, write_fits


def default_primary_header(
    *, targname: str, grism: str, nsamp: int, samp_seq: str, subarray: int,
    expstart_mjd: float, exptime_s: float, scan: bool, scan_rate_pix_s: float,
    plate_scale: float = 0.121, extra: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """The WFC3 keyword block downstream pipelines key off."""
    scan_rate_arcsec = abs(scan_rate_pix_s) * plate_scale
    mjd0 = int(expstart_mjd)
    frac = expstart_mjd - mjd0
    # MJD -> calendar date (Fliegel-Van Flandern), for DATE-OBS realism
    jd = mjd0 + 2400001
    l = jd + 68569
    n = 4 * l // 146097
    l -= (146097 * n + 3) // 4
    i = 4000 * (l + 1) // 1461001
    l -= 1461 * i // 4 - 31
    j = 80 * l // 2447
    day = l - 2447 * j // 80
    l = j // 11
    month = j + 2 - 12 * l
    year = 100 * (n - 49) + i + l
    # round to the displayed ms BEFORE splitting, so 59.9999 s carries
    # into the minute instead of formatting as an invalid ':60.000';
    # clamp the midnight edge rather than recomputing the date
    sec = min(round(frac * 86400.0, 3), 86399.999)
    hh, mm, ss = int(sec // 3600), int(sec % 3600 // 60), sec % 60
    hdr: dict[str, Any] = {
        "TELESCOP": "HST", "INSTRUME": "WFC3", "DETECTOR": "IR",
        "FILTER": grism, "TARGNAME": targname,
        "RA_TARG": 0.0, "DEC_TARG": 0.0,
        "DATE-OBS": f"{year:04d}-{month:02d}-{day:02d}",
        "TIME-OBS": f"{hh:02d}:{mm:02d}:{ss:06.3f}",
        "ROOTNAME": targname.lower().replace(" ", ""),
        "IMAGETYP": "EXT",
        "OBSTYPE": "SPECTROSCOPIC", "OBSMODE": "MULTIACCUM",
        "EXPSTART": expstart_mjd,
        "EXPEND": expstart_mjd + exptime_s / 86400.0,
        "EXPTIME": exptime_s,
        "NSAMP": nsamp + 1,                 # WFC3 counts the zeroth read
        "SAMP_SEQ": samp_seq,
        "SUBARRAY": subarray != 1024,
        "SUBTYPE": f"SQ{subarray}SUB" if subarray != 1024 else "FULLIMAG",
        "APERTURE": f"IRSUB{subarray}" if subarray != 1024 else "IR",
        "SCAN_TYP": "C" if scan else "N",
        "SCAN_RAT": scan_rate_arcsec,
        "SCAN_LEN": scan_rate_arcsec * exptime_s,
        # Scan direction rides the position angle, as in real forward/
        # reverse visits (the two directions' SCAN_ANG differ by 180 deg;
        # reducers split the time series on it).
        "SCAN_ANG": 180.0 if scan_rate_pix_s < 0 else 0.0,
        "POSTARG1": 0.0, "POSTARG2": 0.0,
        "PROPOSID": 0, "UNITCORR": "OMIT",
        "BUNIT": "COUNTS",
        "ORIGIN": "wayne_tpu simulator",
    }
    if extra:
        hdr.update(extra)
    return hdr


def write_ima(path: str, reads_dn: np.ndarray, read_times: np.ndarray,
              primary: dict[str, Any], *, err: np.ndarray | None = None,
              dq: np.ndarray | None = None, gain: float = 2.5,
              read_noise_e: float = 20.0, bias_pedestal_e: float = 0.0,
              units: str = "counts",
              gain_map: np.ndarray | None = None,
              bias_e_map: np.ndarray | None = None) -> None:
    """Write one exposure as an ima-style FITS file.

    Pure-Python writer; the byte layout matches the JAX package's.

    Args:
      reads_dn: (NR, S, S) sampled reads in TIME order (read 0 first).
      read_times: (NR,) seconds from exposure start.
      err: optional (NR, S, S); default propagates the Poisson charge in
        the measured signal (source + sky + dark, i.e. everything above
        the non-Poissonian bias pedestal) plus read noise:
        sqrt(max(sci*g - bias_e, 0) + rn^2)/g per pixel.
      bias_pedestal_e: mean zeroth-read pedestal (electrons) excluded
        from the default ERR's shot-noise term.
      gain_map: optional (S, S) per-pixel gain (e-/DN). A SCI written
        with gain_variations carries quadrant/pixel gain structure; ERR
        must propagate through the SAME map or that structure leaks
        into the shot term. None -> the scalar ``gain``.
      bias_e_map: optional (S, S) per-pixel bias pedestal (electrons);
        None -> the scalar ``bias_pedestal_e``.
      units: 'counts' (raw DN, the simulator's native product) or
        'e_per_s' (calwf3-style count-rate ima: SCI = DN*gain/SAMPTIME;
        the unit conversion uses the SCALAR gain by convention — the
        per-pixel maps affect only ERR's shot term).
    """
    reads_dn = np.asarray(reads_dn, np.float32)

    def default_err(sci):
        g = gain if gain_map is None else np.asarray(gain_map, np.float32)
        be = (bias_pedestal_e if bias_e_map is None
              else np.asarray(bias_e_map, np.float32))
        sig_e = np.maximum(sci * g - be, 0.0)
        return (np.sqrt(sig_e + read_noise_e**2) / g).astype(np.float32)

    sci_bunit = "COUNTS"
    if units == "e_per_s":
        if err is None:   # propagate in DN, then convert with the rate
            err = default_err(reads_dn)
        t = np.asarray(read_times, np.float64)
        scale = np.where(t > 0, gain / np.maximum(t, 1e-9), 0.0)
        scale = scale[:, None, None].astype(np.float32)
        reads_dn = reads_dn * scale
        err = np.asarray(err, np.float32) * scale
        primary = dict(primary, BUNIT="ELECTRONS/S", UNITCORR="COMPLETE")
        # real ima files declare units on EVERY SCI extension — a
        # consumer reading the per-extension BUNIT must not mistake
        # rate planes for raw DN
        sci_bunit = "ELECTRONS/S"
    elif units != "counts":
        raise ValueError(f"unknown units {units!r}")
    nr = reads_dn.shape[0]
    hdus = [FitsHDU(name="", data=None, header=primary)]
    for ver, k in enumerate(range(nr - 1, -1, -1), start=1):
        sci = reads_dn[k]
        if err is not None:
            e = np.asarray(err[k], np.float32)
        else:
            e = default_err(sci)
        d = (np.zeros_like(sci, np.int16) if dq is None
             else np.asarray(dq[k], np.int16))
        samp = np.full_like(d, k, dtype=np.int16)
        t = np.full_like(sci, np.float32(read_times[k]), dtype=np.float32)
        meta = {"SAMPNUM": k, "SAMPTIME": float(read_times[k]),
                "DELTATIM": float(read_times[k] - read_times[k - 1]) if k else 0.0}
        hdus.append(FitsHDU("SCI", ver, sci, dict(meta, BUNIT=sci_bunit)))
        hdus.append(FitsHDU("ERR", ver, e, dict(meta)))
        hdus.append(FitsHDU("DQ", ver, d, dict(meta)))
        hdus.append(FitsHDU("SAMP", ver, samp, dict(meta)))
        hdus.append(FitsHDU("TIME", ver, t, dict(meta)))
    write_fits(path, hdus)


DQ_COSMIC_RAY = 8192   # WFC3 DQ bit for cosmic-ray hits
DQ_SATURATED = 256     # WFC3 DQ bit for full-well saturation
DQ_HOT_PIXEL = 16      # WFC3 DQ bit for hot pixels
DQ_REF_PIXEL = 128     # WFC3 IR DQ bit for (bad) reference pixels
DQ_DEAD = 4            # WFC3 DQ bit for dead / bad detector pixels
DQ_BLOB = 512          # WFC3 IR DQ bit for blobs (CSM-mirror particulates)
DQ_UNSTABLE = 32       # WFC3 IR DQ bit for unstable (RTS/popcorn) pixels


def static_dq_plane(dark_map: np.ndarray, active_mask: np.ndarray, *,
                    qe_map: np.ndarray | None = None,
                    hot_threshold_e_s: float = 0.4,
                    rts_amp: np.ndarray | None = None) -> np.ndarray:
    """Static detector DQ mask: hot pixels (bit 16), reference pixels
    (bit 128, full-frame border), dead pixels (bit 4), IR blobs
    (bit 512) from the relative-QE plane, and unstable RTS pixels
    (bit 32, from Tables.rts_amp). Applied to every read — these
    are calibration-known detector properties, like the bad-pixel
    tables calwf3 folds into real ima DQ planes.

    Everything after ``active_mask`` is KEYWORD-ONLY: ``qe_map`` was
    inserted ahead of ``hot_threshold_e_s`` in round 3, and a caller
    passing a threshold positionally would silently have it read as a
    QE plane (a scalar < 0.05 broadcasts to "every pixel dead").

    The synthetic calibration plants hot pixels at 20-200x the nominal
    dark rate (calibration.synthetic_tables); the 0.4 e-/s threshold
    sits an order of magnitude above the normal-pixel distribution.
    Dead = QE < 5%; blob = QE < 98% and not dead (nominal pixels sit at
    exactly 1 in both the synthetic and loaded QE planes). Blob SKIRT
    pixels with < 2% attenuation (QE in (0.98, 1), the Gaussian edge of
    the synthetic blobs) are attenuated but NOT flagged — the same
    flagging floor real bad-pixel tables have; static attenuation
    cancels in normalised light curves either way, and absolute-
    spectrum consumers carry the documented < 2% edge bias
    (docs/CALIBRATION.md).
    """
    dq = np.where(np.asarray(dark_map) > hot_threshold_e_s,
                  DQ_HOT_PIXEL, 0).astype(np.int16)
    active = np.asarray(active_mask) >= 0.5
    dq |= np.where(~active, DQ_REF_PIXEL, 0).astype(np.int16)
    if qe_map is not None:
        qe = np.asarray(qe_map)
        dead = active & (qe < 0.05)
        dq |= np.where(dead, DQ_DEAD, 0).astype(np.int16)
        dq |= np.where(active & (qe < 0.98) & ~dead, DQ_BLOB, 0
                       ).astype(np.int16)
    if rts_amp is not None:
        dq |= np.where(active & (np.asarray(rts_amp) > 0), DQ_UNSTABLE, 0
                       ).astype(np.int16)
    return dq


def saturation_dq(reads_dn: np.ndarray, gain: float, full_well_e: float,
                  nonlin_fw_deficit: float,
                  dq: np.ndarray | None = None) -> np.ndarray:
    """OR the saturation bit into DQ wherever a read sits at full well.

    The simulator's measured signal tops out near
    full_well*(1 - nonlin_fw_deficit) electrons (mean cubic deficit at
    full well); pixels within 2% of that ceiling are flagged (matching
    how calwf3 flags A-to-D saturation in real ima products).
    """
    reads_dn = np.asarray(reads_dn)
    if dq is None:
        dq = np.zeros(reads_dn.shape, np.int16)
    ceiling_dn = full_well_e * (1.0 - nonlin_fw_deficit) / gain
    dq = dq | np.where(reads_dn >= 0.98 * ceiling_dn, DQ_SATURATED, 0
                       ).astype(np.int16)
    return dq


def cr_dq_planes(cr_pos: np.ndarray, cr_count: np.ndarray, nr: int,
                 s: int) -> np.ndarray:
    """DQ planes (nr, S, S) flagging cosmic-ray hits cumulatively.

    A hit during interval k corrupts every subsequent read, so read j > k
    carries the flag (WFC3 convention: DQ bit 8192). Read 0 is clean.
    """
    dq = np.zeros((nr, s, s), np.int16)
    acc = np.zeros((s, s), np.int16)
    for k in range(nr - 1):
        n = int(cr_count[k])
        if n > 0:
            ys = np.asarray(cr_pos[k, 0, :n])
            xs = np.asarray(cr_pos[k, 1, :n])
            acc[ys, xs] |= DQ_COSMIC_RAY
        dq[k + 1] = acc
    return dq


def read_ima(path: str, with_dq: bool = False):
    """Read an ima file back: (primary_header, reads_dn time-ordered,
    times[, dq time-ordered]).

    ``with_dq=True`` also returns the (NR, S, S) int16 DQ planes in the
    same time order — the input to DQ-aware reduction
    (reduction.clean_masks_from_dq / repair_read_stack).
    """
    hdus = read_fits(path)
    primary = hdus[0][0]

    def planes(extname):
        sel = [(h, d) for h, d in hdus[1:] if h.get("EXTNAME") == extname]
        # stored reverse-time; sort by SAMPNUM ascending
        sel.sort(key=lambda hd: int(hd[0].get("SAMPNUM", 0)))
        return sel

    sci = planes("SCI")
    reads = np.stack([d for _, d in sci])
    times = np.asarray([float(h.get("SAMPTIME", 0.0)) for h, _ in sci])
    if not with_dq:
        return primary, reads, times
    dq = np.stack([d for _, d in planes("DQ")]).astype(np.int16)
    return primary, reads, times, dq

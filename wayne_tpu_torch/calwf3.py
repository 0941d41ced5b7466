"""calwf3-equivalent IR calibration in PyTorch (port of the JAX package's
``calwf3``): raw multiaccum ima -> FLT product.

The WF3IR steps in calwf3's order, on the device the calibration tables
live on:

  DQICORR   the ima DQ planes, consumed as written.
  BLEVCORR  per-read per-amplifier bias drift off the DQ-128 reference
            border (reduction.ref_pixel_correct; full-frame products).
  NLINCORR  per-pixel cubic non-linearity inversion
            (reduction.linearize_reads), gated by the product header's
            NLINCORR switch.
  DARKCORR  dark-reference subtraction per read (Tables.dark_map x t).
  CRCORR    DQ-flagged intervals rebuilt (reduction.repair_read_stack),
            then the rate: the up-the-ramp least-squares slope for staring
            exposures, the repaired last-minus-zeroth net for spatial scans
            (header SCAN_TYP 'C'), whose per-pixel ramps are not linear.
  FLATCORR  omitted for grism data, as real calwf3 does.
  UNITCORR  SCI/ERR in ELECTRONS/S.

Files are read through :func:`wayne_tpu_torch.io.ima.read_ima` and written
through :func:`wayne_tpu_torch.io.fits.write_fits`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from wayne_tpu_torch.calibration import Tables
from wayne_tpu_torch.io.fits import FitsHDU, read_fits, write_fits
from wayne_tpu_torch.io.ima import read_ima
from wayne_tpu_torch.reduction import (
    DQ_REF_PIXEL, good_diff_masks_from_dq, linearize_reads, prefix_sum,
    ramp_slope_frame, read_noise_var_e2, ref_pixel_correct,
    repair_read_stack,
)

__all__ = ["calibrate_ima", "write_flt", "read_flt", "FltProduct"]


@dataclasses.dataclass
class FltProduct:
    """One calibrated exposure (host-side NumPy)."""

    sci: np.ndarray      # (S, S) count rate, e-/s
    err: np.ndarray      # (S, S) 1-sigma rate error, e-/s
    dq: np.ndarray       # (S, S) int16, OR of all read DQ planes
    samp: np.ndarray     # (S, S) int16, clean samples used per pixel
    time: np.ndarray     # (S, S) f32, clean integration seconds per pixel
    header: dict[str, Any]


def _calibrate_reads(reads_dn: torch.Tensor, times: torch.Tensor,
                    dq: torch.Tensor, tables: Tables, *, nlincorr: bool,
                    darkcorr: bool, blevcorr: bool, use_gain_map: bool,
                    has_bias: bool, read_noise_e: float, ramp_fit: bool
                    ) -> tuple[torch.Tensor, ...]:
    """The ima -> flt chain on one exposure's tensors, on their device.

    Args:
      reads_dn: (NR, S, S) raw reads in time order; times: (NR,) seconds;
        dq: (NR, S, S) int16 DQ planes.
    Returns (rate, err, dq, samp, time), each (S, S).
    """
    gain = tables.gain_map if use_gain_map else tables.gain
    bias = tables.bias_map if has_bias else None
    reads = reads_dn.to(torch.float32)
    if blevcorr:
        reads = ref_pixel_correct(reads, (dq[0] & DQ_REF_PIXEL) != 0)[0]
    if nlincorr:
        reads_e = linearize_reads(reads, tables.nonlin_coeffs,
                                  tables.readout_consts[1], gain, bias_e=bias)
    else:
        reads_e = reads * gain
        if bias is not None:
            reads_e = reads_e - bias
    t = times.to(torch.float32)
    if darkcorr:
        reads_e = reads_e - tables.dark_map[None] * t[:, None, None]
    good = good_diff_masks_from_dq(dq)                     # (NR-1, S, S)
    reads_e = repair_read_stack(reads_e, good)
    T = t[-1] - t[0]
    if ramp_fit:
        net_e = ramp_slope_frame(reads_e, t)               # slope * T, e-
    else:
        net_e = reads_e[-1] - reads_e[0]                   # scan: CDS net
    rate = net_e / T
    rn_var = read_noise_var_e2(read_noise_e, reads.shape[0], ramp=ramp_fit)
    err = torch.sqrt(torch.clamp_min(net_e, 0.0) + rn_var) / T
    # the OR over reads, folded in int16 (jnp.bitwise_or.reduce's type)
    dq_flt = dq[0]
    for k in range(1, dq.shape[0]):
        dq_flt = torch.bitwise_or(dq_flt, dq[k])
    samp = (1 + good.sum(dim=0)).to(torch.int16)
    dt = (t[1:] - t[:-1])[:, None, None]
    # summed in read order, so that the card gives the CPU's bits
    time_px = prefix_sum(torch.where(good, dt, 0.0), dim=0)[-1]
    return rate, err, dq_flt.to(torch.int16), samp, time_px


def calibrate_ima(path: str, tables: Tables, noise_flags,
                  read_noise_e: float | None = None) -> FltProduct:
    """Calibrate one raw-DN ima file to an FLT product, on the device of
    ``tables`` (host I/O, then one tensor program; see the module
    docstring for the steps).

    ``noise_flags`` (config.NoiseFlags, normally from the YAML the visit
    was generated with) says which reference planes the product carries:
    the per-pixel gain map (``gain_variations``), the bias plane
    (``bias``) and the dark (``dark``). NLINCORR follows the product
    header (absent = PERFORM); BLEVCORR runs when the first read carries
    DQ-128 reference pixels.
    """
    hdr, reads, times, dq = read_ima(path, with_dq=True)
    if str(hdr.get("BUNIT", "COUNTS")).upper().startswith("ELECTRONS"):
        raise ValueError(
            f"{path!r} is already a count-rate product — calwf3-style "
            "calibration starts from raw-DN ima files "
            "(output_units: counts)")
    # spatial scans (SCAN_TYP 'C') get the CDS net: their per-pixel
    # ramps are nonlinear by construction
    ramp_fit = str(hdr.get("SCAN_TYP", "N")).strip() != "C"
    if ramp_fit and reads.shape[0] < 3:
        raise ValueError(
            f"{path!r} has NSAMP={reads.shape[0] - 1}: the up-the-ramp "
            "fit needs at least 2 sampled reads after the zeroth "
            "(scan-mode products use CDS and accept NSAMP=1)")
    if reads.shape[0] < 2:
        raise ValueError(
            f"{path!r} has NSAMP={reads.shape[0] - 1}: at least one "
            "sampled read after the zeroth is needed for a CDS net")
    if reads.shape[-1] != int(tables.dark_map.shape[-1]):
        raise ValueError(
            f"{reads.shape[-1]}^2 frames vs "
            f"{tables.dark_map.shape[-1]}^2 calibration "
            "planes — does the YAML subarray match the visit?")
    nlincorr = str(hdr.get("NLINCORR", "PERFORM")).upper() != "OMIT"
    blevcorr = bool((dq[0] & DQ_REF_PIXEL).any())
    rn = float(read_noise_e if read_noise_e is not None
               else tables.readout_consts[0])
    dev = tables.device
    rate, err, dq_flt, samp, time_px = (
        x.cpu().numpy() for x in _calibrate_reads(
            torch.from_numpy(np.ascontiguousarray(reads)).to(dev),
            torch.from_numpy(np.asarray(times, np.float64)).to(dev),
            torch.from_numpy(np.ascontiguousarray(dq)).to(dev), tables,
            nlincorr=nlincorr, darkcorr=noise_flags.dark,
            blevcorr=blevcorr, use_gain_map=noise_flags.gain_variations,
            has_bias=noise_flags.bias, read_noise_e=rn, ramp_fit=ramp_fit))
    out_hdr = dict(hdr)
    out_hdr.update({
        "FILETYPE": "SCI", "BUNIT": "ELECTRONS/S",
        "NLINCORR": "COMPLETE" if nlincorr else "OMIT",
        "BLEVCORR": "COMPLETE" if blevcorr else "OMIT",
        "DARKCORR": "COMPLETE" if noise_flags.dark else "OMIT",
        "CRCORR": "COMPLETE", "UNITCORR": "COMPLETE",
        "FLATCORR": "OMIT",   # grism: flats belong to spectral extraction
    })
    return FltProduct(sci=rate.astype(np.float32),
                      err=err.astype(np.float32), dq=dq_flt,
                      samp=samp, time=time_px.astype(np.float32),
                      header=out_hdr)


def write_flt(path: str, flt: FltProduct) -> None:
    """Write an flt-style FITS file: a primary header and one SCI / ERR /
    DQ / SAMP / TIME extension group, as the real product."""
    hdus = [FitsHDU(name="", data=None, header=flt.header)]
    for name, data in (("SCI", flt.sci), ("ERR", flt.err),
                       ("DQ", flt.dq), ("SAMP", flt.samp),
                       ("TIME", flt.time)):
        extra = {"BUNIT": "ELECTRONS/S"} if name in ("SCI", "ERR") else {}
        hdus.append(FitsHDU(name, 1, data, extra))
    write_fits(path, hdus)


def read_flt(path: str):
    """(primary_header, sci, err, dq) from an flt file."""
    hdus = read_fits(path)
    primary = hdus[0][0]
    by_name = {h.get("EXTNAME"): d for h, d in hdus[1:]}
    return primary, by_name["SCI"], by_name["ERR"], by_name["DQ"]

"""Grism models: G102 / G141 (port of the JAX package's ``models/grism``):
the host handle that builds a grism's calibration Tables on a device."""

from __future__ import annotations

import dataclasses

import torch

from wayne_tpu_torch import calibration as cal


class Grism:
    """Host handle for one WFC3 IR grism."""

    name: str = "G141"

    def __init__(self, subarray: int = 512, n_lambda: int = 512,
                 samp_seq: str = "SPARS10", nsamp: int = 15,
                 device: torch.device | str = "cpu", **detector_kwargs):
        self.tables = cal.synthetic_tables(
            self.name, subarray=subarray, n_lambda=n_lambda,
            samp_seq=samp_seq, nsamp=nsamp, device=device, **detector_kwargs)


class G141(Grism):
    name = "G141"


class G102(Grism):
    name = "G102"


def make_grism(name: str, **kwargs) -> Grism:
    try:
        return {"G141": G141, "G102": G102}[name.upper()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown grism {name!r}") from None


def make_calibrated_grism(cfg, device: torch.device | str = "cpu") -> Grism:
    """The visit's grism handle. Real STScI calibration products (the
    YAML ``calibration:`` block) are not ported yet and raise; a
    ``sequence_file`` is applied by the caller's sequence_tables_scope."""
    products = dataclasses.replace(cfg.calibration, sequence_file="")
    if products.any_set():
        raise NotImplementedError(
            "real calibration products (calibration: block) are not "
            "ported to wayne_tpu_torch yet (ROADMAP Queue A7)")
    return make_grism(cfg.grism, subarray=cfg.subarray,
                      n_lambda=cfg.n_lambda, samp_seq=cfg.samp_seq,
                      nsamp=cfg.nsamp, device=device,
                      dead_frac=cfg.dead_pixel_frac, n_blobs=cfg.n_blobs,
                      blob_atten=cfg.blob_attenuation,
                      rts_frac=cfg.unstable_pixel_frac,
                      rts_amplitude=cfg.rts_amplitude)

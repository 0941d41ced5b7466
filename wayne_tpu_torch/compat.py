"""Reference-style API shims (port of the JAX package's ``compat``;
reference: wayne's public entry points).

  - :func:`run` — ``wayne.run_visit.run(parameter_file)`` equivalent;
  - :class:`ExposureGenerator` — per-exposure ``staring_frame`` /
    ``scanning_frame`` calls (reference: wayne/exposure_generator.py),
    each one ``simulate_exposure`` of a one-exposure batch: on the card,
    one launch of the whole-exposure readout kernel.

``Observation`` / ``simulate_visit`` / ``Scene`` remain the recommended
surface; these shims let reference-shaped scripts port without rewrites.
Both run on the CUDA card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from wayne_tpu_torch.config import ExposureStatic, NoiseFlags
from wayne_tpu_torch.device import resolve_device
from wayne_tpu_torch.models.grism import Grism, make_grism
from wayne_tpu_torch.ops.exposure import ExposureResult, simulate_exposure
from wayne_tpu_torch.ops.kepler import OrbitParams
from wayne_tpu_torch.ops.random import seed_words
from wayne_tpu_torch.pytree import tree_map
from wayne_tpu_torch.scene import Scene
from wayne_tpu_torch.trends import TrendParams


def run(parameter_file: str, outdir: str | None = None, chunk: int = 8,
        device: torch.device | str | None = None) -> list[str]:
    """Reference CLI equivalent: load a YAML parameter file, generate the
    visit, write FITS products. Returns written paths."""
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation

    cfg = load_yaml(parameter_file)
    obs = Observation(cfg, device=device)
    return obs.generate(outdir or cfg.outdir, chunk=chunk)


class ExposureGenerator:
    """Per-exposure generator with the reference's frame methods.

    Each frame draws its noise from the seed words ``seed_words(seed,
    0)`` of an explicit ``seed``; a seedless call takes the generator's
    own seed at index 1, 2, ... (one more each call), so seedless calls
    differ from each other and from ``seed=<the generator's seed>``.
    """

    def __init__(self, grism: Grism | str = "G141", *, subarray: int = 512,
                 n_lambda: int = 512, nsamp: int = 15,
                 samp_seq: str = "SPARS10", n_sub: int = 8,
                 noise: NoiseFlags | None = None,
                 stellar_flux: np.ndarray | None = None,
                 rp_over_rs: np.ndarray | float = 0.0,
                 ld_coeffs=(0.65, -0.25, 0.45, -0.2),
                 orbit: OrbitParams | None = None,
                 sky_level: float = 1.2, seed: int = 0,
                 device: torch.device | str | None = None):
        if isinstance(grism, str):
            self.device = resolve_device(device)
            grism = make_grism(grism, subarray=subarray, n_lambda=n_lambda,
                               samp_seq=samp_seq, nsamp=nsamp,
                               device=self.device)
        else:
            # a pre-built Grism instance carries its own geometry and
            # device: the ExposureStatic must match its tables
            self.device = grism.tables.device
            subarray, n_lambda = grism.subarray, grism.n_lambda
            samp_seq, nsamp = grism.samp_seq, grism.nsamp
        self.grism = grism
        self.tables = grism.tables
        self.noise = noise if noise is not None else NoiseFlags()
        self.nsamp, self.samp_seq, self.n_sub = nsamp, samp_seq, n_sub
        self.subarray, self.n_lambda = subarray, n_lambda
        self.seed = seed
        self._n_calls = 0
        dev = self.device
        f32 = lambda v: torch.as_tensor(np.array(v, np.float64),
                                        dtype=torch.float32, device=dev)
        nl = self.tables.wl_centers.shape[0]
        if stellar_flux is None:
            stellar_flux = np.full(nl, 3.13e-10)
        if orbit is None:       # far from transit
            orbit = OrbitParams.create(86400.0, 1e7, 10.0, math.pi / 2,
                                       device=dev)
        self._template = Scene(
            x_ref=f32(subarray / 4), y_ref=f32(subarray / 4),
            exp_start_s=f32(0.0), orbit_start_s=f32(0.0),
            is_first_orbit=f32(1.0), scan_speed=f32(0.0),
            stellar_flux=f32(np.broadcast_to(stellar_flux, (nl,))),
            rp_over_rs=f32(np.broadcast_to(rp_over_rs, (nl,))),
            fp_over_fs=torch.zeros(nl, device=dev),
            phase_amp=f32(0.0), phase_offset=f32(0.0),
            ld=f32(np.asarray(ld_coeffs)), orbit=orbit,
            trends=TrendParams.create(device=dev), sky_level=f32(sky_level),
            seed=seed_words(seed, torch.tensor(0)).to(dev))

    def _config(self, scan: bool) -> ExposureStatic:
        return ExposureStatic(
            subarray=self.subarray, n_lambda=self.n_lambda, n_sub=self.n_sub,
            nsamp=self.nsamp, samp_seq=self.samp_seq, scan=scan,
            noise=self.noise)

    def _frame(self, scan: bool, x_ref, y_ref, scan_speed, exp_start_s,
               seed) -> ExposureResult:
        if seed is None:
            # reference semantics: each call advances the generator, so
            # seedless calls never repeat a noise realisation
            self._n_calls += 1
            seed, index = self.seed, self._n_calls
        else:
            index = 0
        f32 = lambda v: torch.tensor(float(v), dtype=torch.float32,
                                     device=self.device)
        scene = dataclasses.replace(
            self._template, x_ref=f32(x_ref), y_ref=f32(y_ref),
            scan_speed=f32(scan_speed), exp_start_s=f32(exp_start_s),
            seed=seed_words(seed, torch.tensor(index)).to(self.device))
        res = simulate_exposure(tree_map(lambda x: x[None], scene),
                                self.tables, self._config(scan))
        return tree_map(lambda x: x[0], res)

    def staring_frame(self, x_ref: float, y_ref: float,
                      exp_start_s: float = 0.0,
                      seed: int | None = None) -> ExposureResult:
        """Staring-mode exposure (reference: ExposureGenerator.staring_frame)."""
        return self._frame(False, x_ref, y_ref, 0.0, exp_start_s, seed)

    def scanning_frame(self, x_ref: float, y_ref: float,
                       scan_speed: float = 1.0, exp_start_s: float = 0.0,
                       seed: int | None = None) -> ExposureResult:
        """Spatial-scan exposure (reference: ExposureGenerator.scanning_frame)."""
        return self._frame(True, x_ref, y_ref, scan_speed, exp_start_s, seed)

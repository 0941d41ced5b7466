"""Monte-Carlo visit ensembles, on one device or sharded over an (mc, exp)
mesh (port of the JAX package's ``parallel/ensemble``).

Realisations of a visit differ in their seed words (and optionally in
scene parameters); frames are reduced to extracted column spectra on the
device, so an ensemble returns (n_mc, n_exp, S) numbers, not frames.

Each realisation's exposures run as :func:`ops.visit.simulate_visit` runs a
visit: batches of ``chunk`` exposures, one readout launch per batch, each
batch linearized and extracted before the next. A batch never spans two
realisations (the JAX package maps realisations one after another and
vmaps a realisation's exposures), so what realisation m computes does not
depend on how many realisations are asked for at once.

With a mesh (:func:`parallel.mesh.make_mesh`) every position runs that
loop on its own (mc/d_mc, exp/d_exp) block, on its own device, with no
communication; the blocks are assembled on the mesh's first device. The
charge-memory leaves (``MC_INVARIANT_FIELDS``: persistence, RECTE) stay one
(n_exp, S, S) buffer that every realisation views, one copy per exposure
block and device on a mesh.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from wayne_tpu_torch.calibration import Tables
from wayne_tpu_torch.config import ExposureStatic
from wayne_tpu_torch.ops.exposure import ExposureResult, simulate_exposure
from wayne_tpu_torch.ops.random import mc_seed_words
from wayne_tpu_torch.ops.visit import pad_scenes
from wayne_tpu_torch.parallel.mesh import on_mesh, run_on_mesh
from wayne_tpu_torch.pytree import tree_map
from wayne_tpu_torch.reduction import (
    extract_spectra_cr, linearize_reads, ramp_slope_frame, repair_read_stack,
)
from wayne_tpu_torch.scene import Scene


def mc_scenes(visit_scenes: Scene, n_mc: int, seed: int = 0,
              mc_offset: int = 0) -> Scene:
    """Stack a visit's Scene (exp axis) into an (mc, exp) ensemble.

    Every physics parameter is shared; only the seed words differ, derived
    per (GLOBAL realisation index, exposure) from one root seed
    (:func:`ops.random.mc_seed_words`). Local realisation m is keyed as
    ``mc_offset + m``, so a chunked run draws the same noise for
    realisation i however the chunks are cut. Every leaf is an ``expand``
    of the visit's (a view, no copy): the MC-invariant charge-memory maps
    stay the one (n_exp, S, S) buffer.
    """
    n_exp = visit_scenes.n
    dev = visit_scenes.x_ref.device
    m = torch.arange(n_mc) + mc_offset
    seeds = mc_seed_words(seed, m[:, None], torch.arange(n_exp)).to(dev)
    ens = tree_map(lambda a: a[None].expand((n_mc,) + a.shape),
                   visit_scenes)
    return dataclasses.replace(ens, seed=seeds)


def extract_spectra(reads_dn: torch.Tensor,
                    read_times: torch.Tensor | None = None,
                    good_diffs: torch.Tensor | None = None) -> torch.Tensor:
    """Box extraction on the device: net counts per column.

    CDS (last read minus read 0) summed over rows; with ``read_times`` the
    up-the-ramp least-squares slope instead
    (:func:`reduction.ramp_slope_frame`). ``good_diffs`` (..., NR-1, S, S)
    bool runs the interval repair (:func:`reduction.repair_read_stack`)
    first. reads_dn (..., NR, S, S) -> (..., S).
    """
    if good_diffs is not None:
        reads_dn = repair_read_stack(reads_dn, good_diffs)
    if read_times is not None:
        return ramp_slope_frame(reads_dn.movedim(-3, 0),
                                read_times).sum(dim=-2)
    return (reads_dn[..., -1, :, :] - reads_dn[..., 0, :, :]).sum(dim=-2)


def _reduce(res: ExposureResult, tables: Tables, cfg: ExposureStatic,
            read_times, dq_aware: bool, nlincorr: bool) -> torch.Tensor:
    """One batch's reads -> (B, S) spectra: NLINCORR, then the CR-aware or
    the plain extraction."""
    reads = res.reads_dn
    if nlincorr:
        # calwf3 NLINCORR before the flux estimators: the cubic compression
        # is flux-dependent, so it does not cancel in depth ratios
        g = (tables.gain_map if cfg.noise.gain_variations else tables.gain)
        bias = tables.bias_map if cfg.noise.bias else None
        reads = linearize_reads(reads, tables.nonlin_coeffs,
                                tables.readout_consts[1], g, bias_e=bias)
    # cosmic rays simulated: the simulator's own hit lists are the truth
    # the DQ planes would carry, repaired in column space
    if dq_aware and cfg.noise.cosmic_rays:
        return extract_spectra_cr(reads, res.cr_pos, res.cr_count,
                                  read_times)
    return extract_spectra(reads, read_times)


def _ensemble_block(scenes: Scene, tables: Tables, cfg: ExposureStatic,
                    read_times, dq_aware: bool, nlincorr: bool,
                    chunk: int) -> torch.Tensor:
    """(mc, exp, S) spectra of one device's (mc, exp) block: each
    realisation's exposures in batches of ``chunk``."""
    n_mc, n_exp = scenes.x_ref.shape[:2]
    spectra = []
    for m in range(n_mc):
        for c0 in range(0, n_exp, chunk):
            # views of the realisation's exposures; only a short last
            # batch is padded (a copy of that batch alone)
            batch, _ = pad_scenes(
                tree_map(lambda x: x[m, c0:c0 + chunk], scenes), chunk)
            res = simulate_exposure(batch, tables, cfg)
            spectra.append(_reduce(res, tables, cfg, read_times, dq_aware,
                                   nlincorr))
    return torch.cat(spectra).view(n_mc, -1, cfg.subarray)[:, :n_exp]


def simulate_ensemble_spectra(scenes, tables: Tables,
                              cfg: ExposureStatic, mesh=None, *,
                              ramp: bool = False, dq_aware: bool = True,
                              nlincorr: bool = True,
                              chunk: int = 8) -> torch.Tensor:
    """Extracted spectra of an (mc, exp)-batched Scene -> (mc, exp, S).

    ``mesh`` (:func:`parallel.mesh.make_mesh`) stands where the JAX
    package's does. With one, each mesh position computes its (mc/d_mc,
    exp/d_exp) block on its device (``scenes`` a batched Scene, or a
    ``ShardedScenes`` cut for this mesh) and the result is assembled on
    the mesh's first device; n_mc and n_exp must be multiples of the
    mesh's 'mc' and 'exp' sizes. A mesh that is not the port's (a JAX
    mesh) raises TypeError. The result equals the one-device run bit for
    bit when both cut the same batches (``chunk`` = n_exp / d_exp).

    ``ramp=True`` extracts with the up-the-ramp slope instead of CDS.
    ``dq_aware`` (default) repairs the simulated cosmic-ray hits at
    extraction (:func:`reduction.extract_spectra_cr`); False keeps the raw
    CR-contaminated spectra. ``nlincorr`` (default) inverts the per-pixel
    non-linearity before extraction when the run simulates it: spectra are
    then in linearized ELECTRONS instead of DN. ``chunk`` exposures of one
    realisation go through each readout launch; the result does not depend
    on it.

    Unstable (RTS) pixels do not cancel in normalised light curves (their
    state changes per exposure), and these column sums carry them
    unrepaired: a warning says so when ``tables.rts_amp`` is active.
    """
    if tables.rts_amp is not None and bool((tables.rts_amp > 0).any()):
        warnings.warn(
            "simulate_ensemble_spectra: Tables.rts_amp is active — RTS "
            "(unstable-pixel) corruption is time-varying and does NOT "
            "cancel in normalised light curves; these full-frame column "
            "sums carry it unrepaired (mask DQ-32 columns for unbiased "
            "depths)", stacklevel=2)
    nlincorr = nlincorr and cfg.noise.non_linearity
    read_times = tables.read_times if ramp else None
    if mesh is None:
        return _ensemble_block(scenes, tables, cfg, read_times, dq_aware,
                               nlincorr, chunk)
    sharded = on_mesh(scenes, mesh, n_batch_axes=2)
    blocks = run_on_mesh(
        lambda block, tab, dev: _ensemble_block(
            block, tab, cfg, None if read_times is None else tab.read_times,
            dq_aware, nlincorr, chunk), sharded, tables)
    home = sharded.mesh.devices.flat[0]
    d_exp = sharded.mesh.devices.shape[1]
    rows = [torch.cat([b.to(home) for b in blocks[i:i + d_exp]], dim=1)
            for i in range(0, len(blocks), d_exp)]
    return torch.cat(rows, dim=0)

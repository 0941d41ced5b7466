"""Whole-visit execution: chunks of a batched simulate_exposure (port of
the JAX package's ``ops/visit``).

The JAX package maps a vmapped exposure program over fixed-size chunks
inside one jit; here each chunk is one batched :func:`simulate_exposure`
call, so the readout kernel launches once per chunk.
:func:`simulate_visit_sharded` runs a visit's exposures over every device
of an (mc, exp) mesh (:mod:`wayne_tpu_torch.parallel.mesh`).
"""

from __future__ import annotations

import dataclasses

import torch

from wayne_tpu_torch.calibration import Tables
from wayne_tpu_torch.config import ExposureStatic, NoiseFlags
from wayne_tpu_torch.ops.exposure import ExposureResult, simulate_exposure
from wayne_tpu_torch.pytree import leaves, tree_map
from wayne_tpu_torch.scene import Scene


def pad_scenes(scenes: Scene, multiple: int) -> tuple[Scene, int]:
    """Pad a batched Scene along axis 0 to a multiple of ``multiple`` by
    repeating its last exposure; returns (padded, original count)."""
    n = scenes.n
    pad = (-n) % multiple
    if pad == 0:
        return scenes, n
    return tree_map(lambda x: torch.cat(
        [x, x[-1:].expand((pad,) + x.shape[1:])]), scenes), n


def simulate_visit(scenes: Scene, tables: Tables, cfg: ExposureStatic,
                   chunk: int = 8) -> ExposureResult:
    """Run every exposure of a visit, ``chunk`` exposures per call.

    ``scenes`` is batched along axis 0 with N a multiple of ``chunk``
    (:func:`pad_scenes`). Returns an ExposureResult with reads_dn
    (N, NR, S, S).
    """
    n = scenes.n
    if n % chunk != 0:
        raise ValueError(f"n_exposures {n} not a multiple of chunk {chunk}")
    outs = [simulate_exposure(tree_map(lambda x: x[c0:c0 + chunk], scenes),
                              tables, cfg) for c0 in range(0, n, chunk)]
    if len(outs) == 1:
        return outs[0]
    it = iter(zip(*(leaves(o) for o in outs)))
    return tree_map(lambda _: torch.cat(next(it)), outs[0])


def visit_shards(scenes, tables: Tables, cfg: ExposureStatic, mesh,
                 chunk: int = 8) -> list[ExposureResult]:
    """:func:`simulate_visit` of each block of a visit's exposures split
    over every device of ``mesh``, ``chunk`` exposures per launch; the
    blocks' results on their devices, in mesh order (the global exposure
    order). ``scenes``: a batched Scene or a ``ShardedScenes`` with one
    batch axis cut for ``mesh``."""
    from wayne_tpu_torch.parallel.mesh import on_mesh, run_on_mesh

    sharded = on_mesh(scenes, mesh, n_batch_axes=1)
    n, d = sharded.batch_shape[0], sharded.mesh.devices.size
    if n % (d * chunk) != 0:
        raise ValueError(f"n_exposures {n} not a multiple of devices*chunk "
                         f"= {d}*{chunk}")
    return run_on_mesh(
        lambda block, tab, dev: simulate_visit(block, tab, cfg, chunk),
        sharded, tables)


def simulate_visit_sharded(scenes, tables: Tables, cfg: ExposureStatic,
                           mesh, chunk: int = 8) -> ExposureResult:
    """Run a visit's exposures sharded over EVERY device of ``mesh``.

    Each device runs :func:`simulate_visit` on its contiguous block of
    exposures (one readout launch per ``chunk``), exactly the program it
    would run alone: every exposure's seed words travel with it, so the
    frames do not depend on where they were computed. The exposure count
    must be a multiple of D * chunk (:func:`pad_scenes`). Returns the
    ExposureResult gathered on the mesh's first device, exposures in
    global order."""
    outs = visit_shards(scenes, tables, cfg, mesh, chunk)
    home = mesh.devices.flat[0]
    it = iter(zip(*(leaves(o) for o in outs)))
    return tree_map(lambda _: torch.cat([x.to(home) for x in next(it)]),
                    outs[0])


def visit_fluence_stack(scenes: Scene, tables: Tables, cfg: ExposureStatic,
                        chunk: int = 8) -> torch.Tensor:
    """Noise-free end-of-exposure fluence maps (N, S, S): the ideal source
    accumulation plus the expectation of the background the run's noise
    flags enable (sky, dark). The stimulus shared by the persistence and
    RECTE models, from one pass of the visit through the same
    :func:`simulate_visit` with every noise flag off (on the card: the
    whole-exposure readout with its noise off)."""
    ideal_cfg = dataclasses.replace(cfg, noise=NoiseFlags.none(),
                                    compute_ideal=True)
    padded, n = pad_scenes(scenes, chunk)
    ideal = simulate_visit(padded, tables, ideal_cfg, chunk).ideal_e[:n]
    exptime = float(tables.read_times[-1])
    bg = None
    if cfg.noise.sky:
        bg = scenes.sky_level[:, None, None] * tables.sky_frame[None]
    if cfg.noise.dark:
        d = tables.dark_map[None].expand(ideal.shape)
        bg = d if bg is None else bg + d
    if bg is not None:
        ideal = ideal + bg * exptime * tables.active_mask[None]
    return ideal

"""Whole-visit execution: chunks of a batched simulate_exposure (port of
the JAX package's ``ops/visit``).

The JAX package maps a vmapped exposure program over fixed-size chunks
inside one jit; here each chunk is one batched :func:`simulate_exposure`
call, so the readout kernel launches once per chunk.
"""

from __future__ import annotations

import torch

from wayne_tpu_torch.calibration import Tables
from wayne_tpu_torch.config import ExposureStatic
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

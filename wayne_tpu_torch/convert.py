"""State carried across from the JAX package: its ``Tables`` and batched
``Scene``, passed as NumPy arrays, become the port's, so both packages can
compute on identical inputs.

Nothing here imports JAX: :func:`numpy_leaves` duck-types any dataclass
whose leaves ``np.asarray`` accepts (a JAX pytree dataclass included).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wayne_tpu_torch.calibration import Tables
from wayne_tpu_torch.ops.kepler import OrbitParams
from wayne_tpu_torch.scene import Scene
from wayne_tpu_torch.trends import TrendParams

# Optional JAX Scene leaves whose physics the port does not carry yet.
_UNPORTED_SCENE = ("persist_rate", "trap_mult", "spots", "companions")


def numpy_leaves(obj) -> dict:
    """{field: np.ndarray | None | nested dict} of a dataclass of arrays."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(v):
            out[f.name] = numpy_leaves(v)
        else:
            out[f.name] = np.asarray(v)
    return out


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def tables_from_numpy(leaves: dict[str, np.ndarray | None],
                      device: torch.device | str) -> Tables:
    """The port's Tables from the JAX package's Tables leaves."""
    names = {f.name for f in dataclasses.fields(Tables)}
    unknown = set(leaves) - names
    if unknown:
        raise ValueError(f"unknown Tables leaves {sorted(unknown)}")
    return Tables(**{k: None if v is None else _tensor(v, device)
                     for k, v in leaves.items()})


def seed_from_key(key: np.ndarray) -> np.ndarray:
    """(..., 2) raw JAX key words -> the port's (..., 2) int32 seed words,
    mapped as the Pallas path maps them (word0 = key[-1], word1 = key[0])."""
    key = np.asarray(key).astype(np.uint32)
    return np.stack([key[..., -1], key[..., 0]], axis=-1).view(np.int32)


def scenes_from_numpy(leaves: dict, device: torch.device | str) -> Scene:
    """The port's batched Scene from a JAX Scene's leaves (batched along
    axis 0; the ``key`` leaf holds raw key words (N, 2))."""
    for name in _UNPORTED_SCENE:
        if leaves.get(name) is not None:
            raise NotImplementedError(
                f"Scene.{name} is not ported to wayne_tpu_torch yet")
    kw = {k: v for k, v in leaves.items()
          if k not in _UNPORTED_SCENE and k != "key"}
    kw["orbit"] = OrbitParams(**{k: _tensor(v, device)
                                 for k, v in kw["orbit"].items()})
    kw["trends"] = TrendParams(**{k: _tensor(v, device)
                                  for k, v in kw["trends"].items()})
    for k, v in kw.items():
        if isinstance(v, np.ndarray):
            kw[k] = _tensor(v, device)
    kw["seed"] = _tensor(seed_from_key(leaves["key"]), device, torch.int32)
    return Scene(**kw)

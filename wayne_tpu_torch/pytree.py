"""Dataclasses of tensors: the port's counterpart of the JAX pytrees.

``Tables``, ``Scene``, ``OrbitParams``, ``TrendParams`` and
``ExposureResult`` are plain dataclasses whose fields are tensors, nested
such dataclasses, or ``None`` (an absent optional part). These helpers walk
them the way ``jax.tree_util`` walks a pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn: Callable[[torch.Tensor], Any], obj):
    """Apply ``fn`` to every tensor leaf; ``None`` fields stay ``None``."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return fn(obj)


def leaves(obj) -> list[torch.Tensor]:
    """Every tensor leaf, in field order."""
    out: list[torch.Tensor] = []
    tree_map(out.append, obj)
    return out


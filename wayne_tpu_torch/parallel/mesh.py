"""The (mc, exp) device mesh and the sharded runs over it (port of the JAX
package's ``parallel/mesh``).

JAX's mesh has one controller: one Python process calls the program and
every device computes its shard. Here too one process drives every device:
a :class:`Mesh` is a 2-D grid of ``torch.device``s, :func:`shard_scenes`
cuts a batched Scene into the block each mesh position owns (the block the
JAX ``NamedSharding`` would place there) and copies it to that position's
device, and :func:`run_on_mesh` runs a function on every block, one worker
thread per position, and returns the results in mesh order.

Monte-Carlo realisations shard on ``mc``, exposures on ``exp``; no
computation crosses blocks. A device may be listed more than once:
``make_mesh(["cpu"] * 8)`` is the counterpart of the JAX tests' eight
virtual CPU devices, and ``make_mesh(["cuda:0"] * 4)`` runs four positions
on one card. PyTorch's current stream is per thread, so workers that share
a card all use its default stream: their launches are ordered.

A sharded run equals the one-device run bit for bit when both cut the same
exposure batches (for example ``chunk = n_exp / d_exp``); with other
batches the splat's contractions may sum in another order.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, ClassVar

import numpy as np
import torch

from wayne_tpu_torch.pytree import tree_map
from wayne_tpu_torch.scene import MC_INVARIANT_FIELDS, Scene

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 2-D ('mc', 'exp') grid of devices, every CUDA entry indexed.

    ``devices`` is a read-only numpy object array of shape (mc, exp);
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    devices: np.ndarray
    axis_names: ClassVar[tuple[str, str]] = ("mc", "exp")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def indexed_device(device) -> torch.device:
    """``device`` as a torch.device, a CUDA one with its index; an index
    the machine does not have raises, never falls back."""
    d = torch.device(device)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"mesh device {d}: no CUDA device is present; a CPU mesh is "
            f"make_mesh(['cpu'] * n)")
    index = torch.cuda.current_device() if d.index is None else d.index
    if index >= torch.cuda.device_count():
        raise ValueError(
            f"mesh device {d}: this machine has "
            f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


def make_mesh(devices=None, mc_shards: int | None = None) -> Mesh:
    """A 2-D ('mc', 'exp') mesh over ``devices`` (torch devices or strings;
    None means every CUDA device, and raises without one).

    The factorisation is the JAX package's: both axes exist whenever more
    than one device is given (realisations shard on 'mc', a visit's
    exposures on 'exp'); on one device both axes are 1."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() spans every CUDA device and none is present; "
                "pass devices, e.g. make_mesh(['cpu'] * 8), for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    flat = list(np.asarray(devices, dtype=object).reshape(-1))
    n = len(flat)
    if mc_shards is None:
        mc_shards = n
        for cand in (int(np.sqrt(n)), 2):
            if n % cand == 0 and cand > 1 and n // cand > 1:
                mc_shards = n // cand
                break
    if mc_shards < 1:
        raise ValueError(f"mc_shards must be >= 1, got {mc_shards}")
    if n % mc_shards != 0:
        raise ValueError(f"{n} devices not divisible into mc_shards={mc_shards}")
    grid = np.empty(n, dtype=object)
    grid[:] = [indexed_device(d) for d in flat]
    grid = grid.reshape(mc_shards, n // mc_shards)
    grid.flags.writeable = False
    return Mesh(grid)


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is the port's :class:`Mesh`; a JAX mesh, or anything
    else, raises TypeError."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"expected a mesh from wayne_tpu_torch.parallel.make_mesh, got "
            f"{type(mesh).__module__}.{type(mesh).__qualname__}")
    return mesh


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedScenes:
    """A batched Scene cut into the blocks of a mesh: ``blocks[i, j]`` is
    the Scene that mesh position (i, j) owns, on that position's device.
    ``batch_shape`` is the global (n_mc, n_exp) or, with one batch axis,
    (n_exp,)."""

    mesh: Mesh
    blocks: np.ndarray
    n_batch_axes: int
    batch_shape: tuple[int, ...]


def _block_slices(n: int, parts: int, what: str) -> list[slice]:
    if n % parts != 0:
        raise ValueError(f"{what} {n} not a multiple of the mesh's {parts} "
                         f"shards")
    step = n // parts
    return [slice(k * step, (k + 1) * step) for k in range(parts)]


def shard_scenes(scenes: Scene, mesh: Mesh,
                 n_batch_axes: int = 2) -> ShardedScenes:
    """Cut a batched Scene into ``mesh``'s blocks and copy each to its
    position's device.

    With ``n_batch_axes=2`` the leaves lead with (mc, exp) and position
    (i, j) owns the contiguous block (mc/d_mc, exp/d_exp) number (i, j).
    MC-invariant fields (``scene.MC_INVARIANT_FIELDS``, the charge-memory
    maps) are cut on their exposure axis only: a map without an mc axis
    stays without one, and a map that ``mc_scenes`` expanded over the
    realisations is copied once per exposure block and device and viewed
    by the mc positions there. With
    ``n_batch_axes=1`` (a visit) the exposure axis is split over the
    whole flattened mesh, as :func:`ops.visit.simulate_visit_sharded`
    splits it. A count the mesh does not divide raises ValueError."""
    mesh = check_mesh(mesh)
    d_mc, d_exp = mesh.devices.shape
    flat = list(mesh.devices.flat)
    if n_batch_axes == 1:
        n_exp = scenes.n
        batch_shape = (n_exp,)
        cuts = [((), (s,)) for s in _block_slices(n_exp, len(flat),
                                                   "n_exposures")]
    elif n_batch_axes == 2:
        n_mc, n_exp = scenes.x_ref.shape[:2]
        batch_shape = (n_mc, n_exp)
        mcs = _block_slices(n_mc, d_mc, "n_mc")
        exps = _block_slices(n_exp, d_exp, "n_exp")
        cuts = [((m,), (e,)) for m in mcs for e in exps]
    else:
        raise ValueError(f"n_batch_axes must be 1 or 2, got {n_batch_axes}")
    shared: dict = {}

    def invariant(name, x, mc, exp, dev):
        """An MC-invariant map's block: its one copy per (exposure block,
        device), viewed over the block's realisations when the map came
        expanded over them."""
        if x.dim() == 3:                         # (n_exp, S, S), no mc axis
            return x[exp].to(dev)
        if x.stride(0) != 0:                     # distinct maps per mc
            return x[mc + exp].to(dev)
        key = (name, exp[0].start, dev)
        if key not in shared:
            shared[key] = x[0][exp].to(dev)
        one = shared[key]
        return one[None].expand((mc[0].stop - mc[0].start,) + one.shape)

    blocks = np.empty(len(flat), dtype=object)
    for k, ((mc, exp), dev) in enumerate(zip(cuts, flat)):
        fields = {}
        for f in dataclasses.fields(scenes):
            v = getattr(scenes, f.name)
            if v is not None and mc and f.name in MC_INVARIANT_FIELDS:
                fields[f.name] = invariant(f.name, v, mc, exp, dev)
            else:
                fields[f.name] = tree_map(lambda x: x[mc + exp].to(dev), v)
        blocks[k] = Scene(**fields)
    return ShardedScenes(mesh, blocks.reshape(mesh.devices.shape),
                         n_batch_axes, batch_shape)


def on_mesh(scenes, mesh, n_batch_axes: int) -> ShardedScenes:
    """``scenes`` as blocks of ``mesh``: a plain batched Scene is sharded
    (:func:`shard_scenes`), a ShardedScenes must have been cut for this
    mesh and this many batch axes."""
    mesh = check_mesh(mesh)
    if not isinstance(scenes, ShardedScenes):
        return shard_scenes(scenes, mesh, n_batch_axes)
    if scenes.n_batch_axes != n_batch_axes or not (
            scenes.mesh.devices.shape == mesh.devices.shape
            and all(a == b for a, b in zip(scenes.mesh.devices.flat,
                                           mesh.devices.flat))):
        raise ValueError(
            f"scenes were sharded over {scenes.mesh} with "
            f"{scenes.n_batch_axes} batch axes; this call needs {mesh} with "
            f"{n_batch_axes}")
    return scenes


def tables_on(tables, device: torch.device):
    """``tables`` on ``device`` (itself when already there); the host
    floats of ``readout_consts`` come along, so that no launch waits on a
    card to read them back."""
    if tables.device == device:
        return tables
    consts = tables.readout_consts
    moved = tree_map(lambda x: x.to(device), tables)
    moved.__dict__["readout_consts"] = consts
    return moved


def run_on_mesh(fn: Callable[[Scene, Any, torch.device], Any],
                sharded: ShardedScenes, tables) -> list:
    """``fn(block, tables, device)`` at every mesh position, one worker
    thread per position; the results in mesh order (row-major over
    (mc, exp)).

    ``tables`` is copied to each distinct device once (positions on one
    device share the copy). A worker on a CUDA device runs inside
    ``torch.cuda.device`` of it. The readout kernels are built and loaded
    here, before the workers start. An exception in any worker is raised
    here."""
    devices = list(sharded.mesh.devices.flat)
    distinct = list(dict.fromkeys(devices))
    if any(d.type == "cuda" for d in distinct):
        from wayne_tpu_torch.ops import readout

        readout._library()
    per_device = {d: tables_on(tables, d) for d in distinct}

    def work(block, device):
        if device.type != "cuda":
            return fn(block, per_device[device], device)
        with torch.cuda.device(device):
            return fn(block, per_device[device], device)

    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        futures = [pool.submit(work, block, device) for block, device
                   in zip(sharded.blocks.flat, devices)]
        return [f.result() for f in futures]


def gather_to_host(shards: list[tuple[torch.Tensor, ...]]):
    """Start copying every shard's tensors to the host without blocking:
    part p of the result holds part p of each shard, the shards one after
    another on axis 0, in pinned memory. Returns (parts, events): one
    event per CUDA device the shards are on, recorded on that device's
    current stream after its copies; wait on every one (:func:`wait`)
    before reading the parts. CPU shards are concatenated at once, with no
    event."""
    if shards[0][0].device.type != "cuda":
        if len(shards) == 1:
            return tuple(shards[0]), []
        return tuple(torch.cat(p) for p in zip(*shards)), []
    host = tuple(torch.empty((sum(t.shape[0] for t in part),)
                             + part[0].shape[1:], dtype=part[0].dtype,
                             pin_memory=True) for part in zip(*shards))
    events: dict = {}
    starts = [0] * len(host)
    for shard in shards:
        for p, t in enumerate(shard):
            host[p][starts[p]:starts[p] + t.shape[0]].copy_(
                t, non_blocking=True)
            starts[p] += t.shape[0]
        dev = shard[0].device
        # copies from one device run in its stream's order: the event
        # after its last shard covers them all
        events[dev] = torch.cuda.Event()
        events[dev].record(torch.cuda.current_stream(dev))
    return host, list(events.values())


def wait(events) -> None:
    """Block until every event of :func:`gather_to_host` has completed."""
    for e in events:
        e.synchronize()

"""Large-scale dataset generation: parameter sweeps and resumable chunks
(port of the JAX package's ``parallel/dataset``).

  - :func:`sweep_scenes` varies physics across the ensemble axis
    (transmission spectra, scan speeds, ...), not only the seed words;
  - :func:`generate_dataset` runs an (mc, exp) ensemble in chunks of
    realisations and writes each chunk's extracted spectra and labels to
    disk at once, so a crashed run resumes at the first missing chunk.

The files, keys and manifest are the JAX package's. The realisations are
not: the two packages key their noise differently, so the manifest names
the package whose keys made the chunks, and a directory that the other
package wrote does not resume here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile
from typing import Any, Mapping

import numpy as np
import torch

from wayne_tpu_torch.calibration import Tables
from wayne_tpu_torch.config import ExposureStatic
from wayne_tpu_torch.device import resolve_device
from wayne_tpu_torch.parallel.ensemble import (
    mc_scenes, simulate_ensemble_spectra,
)
from wayne_tpu_torch.parallel.mesh import (
    check_mesh, gather_to_host, indexed_device, wait,
)
from wayne_tpu_torch.pytree import tree_map
from wayne_tpu_torch.reduction import constrained_mask, spectra_to_depths
from wayne_tpu_torch.scene import Scene

# The manifest's "keys" entry: whose seed derivation made the chunks. A
# manifest without one was written by the JAX package.
KEYS = "wayne_tpu_torch"
_JAX_KEYS = "wayne_tpu"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(tree) -> list[np.ndarray]:
    """The array leaves of nested lists, tuples, dicts (by sorted key) and
    dataclasses (in field order), in the order
    ``jax.tree_util.tree_leaves`` walks them."""
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in _leaves(t)]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [a for f in dataclasses.fields(tree)
                for a in _leaves(getattr(tree, f.name))]
    return [_numpy(tree)]


def _fingerprint(tree) -> str:
    """Content hash of a tree of arrays (resume-safety checks): the JAX
    package's hash of the same NumPy arrays."""
    h = hashlib.sha256()
    for a in _leaves(tree):
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _chunk_input_fingerprints(n_mc: int, chunk_mc: int, overrides,
                              labels) -> list[str | None]:
    """Per-chunk content hash of the override/label slices that shaped it:
    growing a dataset (a larger n_mc whose inputs extend the old run's)
    still resumes, while edited inputs of a written chunk are rejected."""
    out: list[str | None] = []
    for c0 in range(0, n_mc, chunk_mc):
        parts = []
        if overrides:
            parts.append({k: _numpy(v)[c0: c0 + chunk_mc]
                          for k, v in sorted(overrides.items())})
        if labels:
            parts.append({k: _numpy(v)[c0: c0 + chunk_mc]
                          for k, v in sorted(labels.items())})
        out.append(_fingerprint(parts) if parts else None)
    return out


def sweep_scenes(visit_scenes: Scene, n_mc: int, seed: int = 0,
                 overrides: Mapping[str, Any] | None = None,
                 mc_offset: int = 0) -> Scene:
    """An (mc, exp) ensemble whose realisations differ in physics.

    Args:
      visit_scenes: Scene batched over exposures (exp axis).
      overrides: per-field arrays with leading axis n_mc. A field of shape
        (n_mc, ...) broadcasts over exposures; (n_mc, n_exp, ...) is taken
        verbatim. Example: ``{"rp_over_rs": rp_samples}`` with rp_samples
        (n_mc, NL).
      mc_offset: global index of the first realisation (see mc_scenes):
        seed words depend only on seed + global index, never on chunking.
    """
    ens = mc_scenes(visit_scenes, n_mc, seed, mc_offset=mc_offset)
    if not overrides:
        return ens
    n_exp = visit_scenes.n
    updates: dict[str, torch.Tensor] = {}
    for name, value in overrides.items():
        cur = getattr(ens, name)
        value = torch.as_tensor(_numpy(value), dtype=cur.dtype,
                                device=cur.device)
        if value.shape[0] != n_mc:
            raise ValueError(f"override {name!r} must lead with n_mc={n_mc}")
        if value.dim() == cur.dim():          # (mc, exp, ...) verbatim
            if value.shape[1] != n_exp:
                raise ValueError(
                    f"override {name!r} exposure axis is {value.shape[1]}, "
                    f"the visit has {n_exp} exposures")
            updates[name] = value
        elif value.dim() == cur.dim() - 1:    # (mc, ...) -> over exp
            try:
                updates[name] = value[:, None].expand(cur.shape)
            except RuntimeError as err:
                raise ValueError(
                    f"override {name!r} of shape {tuple(value.shape)} does "
                    f"not broadcast to {tuple(cur.shape)}") from err
        else:
            raise ValueError(f"override {name!r} has rank {value.dim()}, "
                             f"expected {cur.dim()} or {cur.dim() - 1}")
    return dataclasses.replace(ens, **updates)


def generate_dataset(visit_scenes: Scene, tables: Tables, cfg: ExposureStatic,
                     outdir: str, *, n_mc: int, chunk_mc: int = 16,
                     seed: int = 0,
                     overrides: Mapping[str, Any] | None = None,
                     labels: Mapping[str, np.ndarray] | None = None,
                     mesh=None, progress=None, dq_aware: bool = True,
                     recover: Mapping[str, Any] | None = None,
                     device: torch.device | str | None = None,
                     chunk: int = 8) -> dict[str, Any]:
    """Generate an n_mc-realisation spectral dataset, resumably.

    Writes ``chunk_XXXX.npz`` files holding the extracted spectra
    ``spectra_e`` (chunk_mc, n_exp, S) plus each per-realisation label's
    slice (``label_<name>``), and a ``manifest.json``. Chunks already on
    disk are skipped on a re-run, after checking that the settings and
    inputs that shaped them are this run's. ``dq_aware=False`` keeps the
    simulated cosmic rays IN the spectra.

    ``device``: None (the default) runs on the CUDA card and raises without
    one; ``"cpu"`` runs the plain PyTorch path. The scenes and tables are
    moved there. ``chunk``: exposures per readout launch.

    ``mesh`` (:func:`parallel.mesh.make_mesh`) shards each chunk's
    realisations over its 'mc' axis and the exposures over its 'exp' axis
    (:func:`parallel.ensemble.simulate_ensemble_spectra`); the spectra are
    gathered, and ``recover`` runs, on the mesh's first device, which
    ``device`` must then be (or None). chunk_mc must be a multiple of the
    'mc' size and the visit's exposures of the 'exp' size. The manifest
    records the mesh's shape; a resume under another mesh is allowed,
    since realisations are keyed by their global index.

    ``recover`` attaches RECOVERED depth labels: each chunk's spectra are
    also reduced on the device (reduction.spectra_to_depths, every
    realisation of the chunk in one call) and stored as ``recovered_rp``
    and ``recovered_rp_sigma`` (chunk_mc, n_chan), the sigma split
    ``recovered_rp_sigma_rel`` (chunk_mc, n_chan) and
    ``recovered_rp_sigma_common`` (chunk_mc,) (Cov = diag(rel^2) +
    common^2 ones), and ``recovered_constrained`` (chunk_mc, n_chan)
    (reduction.constrained_mask). Required keys: ``exp_mid_s`` (n_exp,),
    ``orbit`` (OrbitParams), ``ld`` (4,), ``rp0``, ``x_window`` (lo, hi).
    Optional: ``n_chan`` (8), ``divide_white`` (True), ``subtract_bg``
    (True: the ensemble's spectra are full-frame column sums, so the sky
    must go before the fit), ``scan_dir`` (n_exp,) reverse-scan mask.
    """
    if mesh is None:
        dev = resolve_device(device)
        mesh_shape = [1, 1]
    else:
        home = check_mesh(mesh).devices.flat[0]
        if device is not None and indexed_device(device) != home:
            raise ValueError(f"device={device!r} but the mesh's first "
                             f"device is {home}: pass device=None")
        dev = home
        mesh_shape = list(mesh.devices.shape)
    os.makedirs(outdir, exist_ok=True)
    say = progress or (lambda s: None)
    if n_mc % chunk_mc != 0:
        raise ValueError("n_mc must be a multiple of chunk_mc")
    d_mc, d_exp = mesh_shape
    if chunk_mc % d_mc != 0:
        raise ValueError(f"chunk_mc must be a multiple of mesh mc={d_mc}")
    if visit_scenes.n % d_exp != 0:
        raise ValueError(
            f"visit has {visit_scenes.n} exposures, not shardable over the "
            f"mesh exp={d_exp} axis — pad the visit or choose a mesh "
            f"whose exp axis divides it")
    if recover is not None and int(recover.get("n_chan", 8)) < 1:
        raise ValueError("recover n_chan must be >= 1")
    if labels:
        for k, v in labels.items():
            if len(_numpy(v)) != n_mc:
                raise ValueError(
                    f"label {k!r} has {len(_numpy(v))} rows, expected "
                    f"n_mc={n_mc} — a short label array would be silently "
                    f"truncated against the final chunks' spectra")
    visit_scenes = tree_map(lambda x: x.to(dev), visit_scenes)
    tables = tree_map(lambda x: x.to(dev), tables)
    n_exp = visit_scenes.n

    # Resume safety: skipped chunks and the settings that shaped them must
    # match this run, or the concatenated dataset silently mixes
    # incompatible rows. recover's arrays (mid-times, orbit, limb
    # darkening) are compared by content.
    recover_desc = None
    if recover is not None:
        recover_desc = {
            "n_chan": int(recover.get("n_chan", 8)),
            "x_window": [int(x) for x in recover["x_window"]],
            "rp0": float(recover["rp0"]),
            "divide_white": bool(recover.get("divide_white", True)),
            "subtract_bg": bool(recover.get("subtract_bg", True)),
            "scan_dir": recover.get("scan_dir") is not None,
            "inputs_sha": _fingerprint((recover["exp_mid_s"],
                                        recover["orbit"], recover["ld"])),
        }
    expected_keys = {"spectra_e"}
    if recover is not None:
        expected_keys |= {"recovered_rp", "recovered_rp_sigma",
                          "recovered_rp_sigma_rel",
                          "recovered_rp_sigma_common",
                          "recovered_constrained"}
    if labels:
        expected_keys |= {f"label_{k}" for k in labels}
    manifest_path = os.path.join(outdir, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as fh:
            prev = json.load(fh)
        checks = {"chunk_mc": chunk_mc, "seed": seed, "dq_aware": dq_aware,
                  "n_exp": n_exp, "subarray": cfg.subarray,
                  "labels": sorted(labels) if labels else [],
                  "recover": recover_desc,
                  # spectra convention: NLINCORR-linearized electrons vs
                  # raw DN sums
                  "nlincorr": bool(cfg.noise.non_linearity),
                  # the same seed makes other realisations in the other
                  # package
                  "keys": KEYS}
        # manifests from before NLINCORR hold raw-DN sums; manifests
        # without "keys" come from the JAX package
        prev.setdefault("nlincorr", False)
        prev.setdefault("keys", _JAX_KEYS)
        for key, cur in checks.items():
            if key in prev and prev[key] != cur:
                raise ValueError(
                    f"resume mismatch in {manifest_path}: {key} was "
                    f"{prev[key]!r}, this run uses {cur!r} — existing "
                    f"chunks would be inconsistent; delete {outdir} or "
                    f"match the original settings")
        # the override/label SLICES that shaped each existing chunk must be
        # byte-identical in this run (a prefix match: growing n_mc resumes)
        prev_shas = prev.get("chunk_inputs_sha") or []
        cur_shas = _chunk_input_fingerprints(n_mc, chunk_mc, overrides,
                                             labels)
        for i in range(min(len(prev_shas), len(cur_shas))):
            if prev_shas[i] != cur_shas[i]:
                raise ValueError(
                    f"resume mismatch in {manifest_path}: chunk {i}'s "
                    f"override/label content differs from the run that "
                    f"wrote it — regenerated samples or an edited label "
                    f"array would silently corrupt the concatenated "
                    f"dataset; delete {outdir} or restore the original "
                    f"inputs")

    written = []

    def on_device(x):
        return torch.as_tensor(_numpy(x) if not isinstance(x, torch.Tensor)
                               else x, device=dev)

    if recover is not None:
        scan_dir = recover.get("scan_dir")
        rec_args = (on_device(recover["exp_mid_s"]).to(torch.float32),
                    tree_map(on_device, recover["orbit"]),
                    on_device(recover["ld"]).to(torch.float32))
        rec_kw = dict(
            x_window=tuple(int(x) for x in recover["x_window"]),
            n_chan=int(recover.get("n_chan", 8)),
            divide_white=bool(recover.get("divide_white", True)),
            subtract_bg=bool(recover.get("subtract_bg", True)),
            scan_dir=None if scan_dir is None else on_device(scan_dir),
            sigma_components=True)

    # Two stages: while the device computes chunk i+1, the host writes
    # chunk i, whose arrays were copied to pinned memory without blocking
    # (gather_to_host: an event on the arrays' own device's stream).
    def flush(pending) -> None:
        path, (hosts, events), c0 = pending
        wait(events)
        spectra = hosts[0].numpy()
        payload = {"spectra_e": spectra}
        if recover is not None:
            rp, sig, sig_rel, sig_common = (h.numpy() for h in hosts[1:])
            payload["recovered_rp"] = rp
            payload["recovered_rp_sigma"] = sig
            payload["recovered_rp_sigma_rel"] = sig_rel
            payload["recovered_rp_sigma_common"] = np.broadcast_to(
                sig_common, (rp.shape[0],)).copy()
            payload["recovered_constrained"] = constrained_mask(rp, sig)
        if labels:
            for k, v in labels.items():
                payload[f"label_{k}"] = _numpy(v)[c0: c0 + chunk_mc]
        # atomic publish: a crash mid-write leaves no truncated chunk
        tmp = path[:-4] + ".tmp.npz"
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
        say(f"chunk {c0 // chunk_mc}: wrote {spectra.shape}")

    pending = None
    for c0 in range(0, n_mc, chunk_mc):
        path = os.path.join(outdir, f"chunk_{c0 // chunk_mc:04d}.npz")
        written.append(os.path.basename(path))
        if os.path.exists(path):
            try:
                with np.load(path) as z:
                    have = set(z.files)
            except (zipfile.BadZipFile, OSError, ValueError, EOFError):
                # a partial file from before the atomic write, or disk
                # corruption: regenerate instead of aborting the resume
                say(f"chunk {c0 // chunk_mc}: corrupt/partial, regenerating")
                os.remove(path)
            else:
                if have != expected_keys:
                    raise ValueError(
                        f"resume mismatch: {path} holds {sorted(have)}, this "
                        f"run expects {sorted(expected_keys)} — delete the "
                        f"stale chunks or use a fresh outdir")
                say(f"chunk {c0 // chunk_mc}: exists, skipping")
                continue
        over = None
        if overrides:
            over = {k: _numpy(v)[c0: c0 + chunk_mc]
                    for k, v in overrides.items()}
        # realisations are keyed by their GLOBAL index c0 + i: identical
        # noise however the run is chunked
        ens = sweep_scenes(visit_scenes, chunk_mc, seed=seed, overrides=over,
                           mc_offset=c0)
        spectra = simulate_ensemble_spectra(ens, tables, cfg, mesh,
                                            dq_aware=dq_aware, chunk=chunk)
        arrays = [spectra]
        if recover is not None:
            arrays += list(spectra_to_depths(spectra, *rec_args,
                                             float(recover["rp0"]),
                                             **rec_kw))
        fetched = gather_to_host([tuple(arrays)])
        if pending is not None:
            flush(pending)
        pending = (path, fetched, c0)
    if pending is not None:
        flush(pending)

    manifest = {
        "n_mc": n_mc, "chunk_mc": chunk_mc, "n_exp": n_exp,
        "subarray": cfg.subarray, "seed": seed, "dq_aware": dq_aware,
        "labels": sorted(labels) if labels else [],
        "chunk_inputs_sha": _chunk_input_fingerprints(n_mc, chunk_mc,
                                                      overrides, labels),
        "recovered": recover is not None,
        "recover": recover_desc,
        "nlincorr": bool(cfg.noise.non_linearity),
        "keys": KEYS,
        "mesh": mesh_shape,
        "chunks": written,
    }
    with open(manifest_path, "w") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest


def load_dataset(outdir: str) -> dict[str, np.ndarray]:
    """Concatenate all chunks of a generated dataset."""
    with open(os.path.join(outdir, "manifest.json")) as fh:
        manifest = json.load(fh)
    arrays: dict[str, list[np.ndarray]] = {}
    for name in manifest["chunks"]:
        with np.load(os.path.join(outdir, name)) as z:
            for k in z.files:
                arrays.setdefault(k, []).append(z[k])
    return {k: np.concatenate(v) for k, v in arrays.items()}

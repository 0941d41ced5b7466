"""A ``torch.utils.data`` view of generated datasets (the port's copy of
the JAX package's ``parallel/torch_data``).

Simulated ensembles are natural ML training sets (spectra -> atmospheric
labels). :class:`WayneSpectraDataset` is a chunk-file-backed map-style
dataset over the directories :func:`wayne_tpu_torch.parallel.dataset.
generate_dataset` writes, with lazy per-chunk loading and an LRU chunk
cache.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict

import numpy as np
import torch


class WayneSpectraDataset:
    """Map-style dataset over a generate_dataset() output directory.

    Each item is ``(spectra, labels_dict)`` for one Monte-Carlo
    realisation: spectra (n_exp, S) float32, labels scalar/array per key.
    Datasets generated with ``recover=`` (by the JAX package) also carry
    ``recovered_rp`` / ``recovered_rp_sigma`` (n_chan,) in the labels
    dict. Plugs into ``torch.utils.data.DataLoader``; ``as_torch=True``
    returns tensors.
    """

    def __init__(self, outdir: str, cache_chunks: int = 4,
                 as_torch: bool = False):
        with open(os.path.join(outdir, "manifest.json")) as fh:
            self.manifest = json.load(fh)
        self.outdir = outdir
        self.chunk_mc = int(self.manifest["chunk_mc"])
        self.n_mc = int(self.manifest["n_mc"])
        self.label_keys = list(self.manifest.get("labels", []))
        self.recovered = bool(self.manifest.get("recovered", False))
        self._cache: OrderedDict[int, dict] = OrderedDict()
        self._cache_max = cache_chunks
        self._as_torch = as_torch

    def __len__(self) -> int:
        return self.n_mc

    def _chunk(self, ci: int) -> dict:
        if ci in self._cache:
            self._cache.move_to_end(ci)
            return self._cache[ci]
        path = os.path.join(self.outdir, self.manifest["chunks"][ci])
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        self._cache[ci] = data
        if len(self._cache) > self._cache_max:
            self._cache.popitem(last=False)
        return data

    def __getitem__(self, idx: int):
        if not 0 <= idx < self.n_mc:
            raise IndexError(idx)
        ci, off = divmod(idx, self.chunk_mc)
        data = self._chunk(ci)
        spectra = data["spectra_e"][off].astype(np.float32)
        labels = {k: data[f"label_{k}"][off] for k in self.label_keys}
        if self.recovered:
            labels["recovered_rp"] = data["recovered_rp"][off]
            labels["recovered_rp_sigma"] = data["recovered_rp_sigma"][off]
        if self._as_torch:
            spectra = torch.from_numpy(np.ascontiguousarray(spectra))
            labels = {k: torch.as_tensor(v) for k, v in labels.items()}
        return spectra, labels

"""The port's ``wayne_tpu_torch.examples.run_ensemble`` on the CPU at 64^2,
4 exposures, 2 realisations in chunks of 1, against the JAX package's
``examples/run_ensemble.py`` at the same flags: the same chunk files and
manifest, the same array names and shapes, the same ``rp_scale`` labels;
``load_dataset`` reads the port's back. Without ``--cpu`` and without a
card it raises.

The file takes ~25 s on one core (the JAX example's compile dominates).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from wayne_tpu_torch.examples import run_ensemble
from wayne_tpu_torch.parallel.dataset import load_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--subarray", "64", "--n-exp", "4", "--n-mc", "2", "--chunk-mc", "1"]


def _run_jax_example(outdir, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_run_ensemble", os.path.join(REPO, "examples", "run_ensemble.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["run_ensemble.py", *FLAGS, "--cpu",
                                      "--outdir", outdir])
    mod.main()


def test_run_ensemble_writes_the_jax_examples_dataset(tmp_path, monkeypatch,
                                                      capsys):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert run_ensemble.main([*FLAGS, "--cpu", "--outdir", mine]) == 0
    assert "dataset complete: 2 visits x 4 exposures" in \
        capsys.readouterr().out
    _run_jax_example(theirs, monkeypatch)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    with open(os.path.join(mine, "manifest.json")) as fh:
        m = json.load(fh)
    with open(os.path.join(theirs, "manifest.json")) as fh:
        j = json.load(fh)
    assert m["chunks"] == j["chunks"] and m["n_mc"] == j["n_mc"] == 2
    assert m["n_exp"] == j["n_exp"] == 4
    got, want = load_dataset(mine), load_dataset(theirs)
    assert sorted(got) == sorted(want) == ["label_rp_scale", "spectra_e"]
    assert got["spectra_e"].shape == want["spectra_e"].shape == (2, 4, 64)
    assert np.all(np.isfinite(got["spectra_e"]))
    np.testing.assert_array_equal(got["label_rp_scale"],
                                  want["label_rp_scale"])


def test_run_ensemble_raises_without_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_ensemble.main([*FLAGS, "--outdir", str(tmp_path / "ds")])
    assert not (tmp_path / "ds").exists()

"""The port's dataset-at-scale tool (``wayne_tpu_torch.tools.
dataset_scale``) on the CPU at 64^2, 8 exposures, ``chunk_mc`` 2, against
the JAX package's tool.

- Phase 2 skips exactly phase 1's chunks (``resume_ok``) for each grism,
  and every chunk of the resumed dataset equals, bit for bit, a one-shot
  run of the same realisations into a fresh directory.
- The truncation to a chunk multiple and the 11-chunk minimum equal the
  JAX tool's own statements (lifted with ``ast``).
- The record's keys are ``DATASET_SCALE.json``'s plus ``card``; nothing is
  written in the repository; without ``--cpu`` and without a card it
  raises.

The file takes ~15 s on one core.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from wayne_tpu_torch.parallel.dataset import generate_dataset
from wayne_tpu_torch.tools import dataset_scale as ds

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(S=64, NL=32, N_EXP=8, nsamp=3)
CHUNK = 2


@pytest.fixture(scope="module")
def scaled(tmp_path_factory):
    root = tmp_path_factory.mktemp("scale")
    before = set(os.listdir(REPO))
    out = root / "DATASET_SCALE_TORCH.json"
    record = ds.run_scale(5, "cpu", str(out), chunk_mc=CHUNK,
                          scratch=str(root / "data"), **SMALL)
    assert set(os.listdir(REPO)) == before
    with open(out) as fh:
        assert json.load(fh) == record
    return record, root


def test_resume_skips_exactly_phase_one(scaled):
    record, _ = scaled
    n = ds.effective_n(5, CHUNK)
    assert record["n_per_grism"] == n == 11 * CHUNK
    for grism in ds.GRISMS:
        g = record["grisms"][grism]
        assert g["resume_ok"] is True
        assert g["resume_skipped_chunks"] == ds.PHASE1_CHUNKS
        assert g["chunks"] == n // CHUNK and g["n_mc"] == n
    assert record["total_visits_generated"] == 2 * n


def test_resumed_chunks_equal_a_one_shot_run(scaled, tmp_path):
    record, root = scaled
    n = record["n_per_grism"]
    sizes = dict(ds.SIZES, **SMALL)
    cfg, scenes, grisms = ds.scale_inputs(torch.device("cpu"), n, **sizes)
    for grism, (tables, rp) in grisms.items():
        fresh = tmp_path / grism
        manifest = generate_dataset(
            scenes, tables, cfg, str(fresh), n_mc=n, chunk_mc=CHUNK, seed=3,
            overrides={"rp_over_rs": np.broadcast_to(
                rp[:, None], (n, sizes["NL"])).copy()},
            labels={"rp": rp}, device="cpu")
        resumed = root / "data" / grism
        for name in manifest["chunks"]:
            with np.load(fresh / name) as a, np.load(resumed / name) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=name)


def _jax_truncation():
    """The JAX tool's statements from its truncation to its minimum."""
    path = os.path.join(REPO, "tools", "dataset_scale.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    main, = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "main"]
    start = next(i for i, s in enumerate(main.body)
                 if isinstance(s, ast.If) and "CHUNK_MC" in ast.unparse(s))
    stop = next(i for i, s in enumerate(main.body)
                if isinstance(s, ast.Assign) and "max(" in ast.unparse(s))
    code = compile(ast.Module(body=main.body[start: stop + 1],
                              type_ignores=[]), path, "exec")

    def run(n, chunk):
        ns = {"n_per_grism": n, "CHUNK_MC": chunk, "log": lambda m: None}
        exec(code, ns)
        return ns["n_per_grism"]
    return run


@pytest.mark.parametrize("n", [1, 5, 219, 220, 221, 5000, 5013, 4999])
@pytest.mark.parametrize("chunk", [2, 20])
def test_truncation_and_minimum_are_the_jax_tools(n, chunk):
    assert ds.effective_n(n, chunk) == _jax_truncation()(n, chunk)


def test_record_has_the_jax_keys(scaled):
    record, _ = scaled
    with open(os.path.join(REPO, "DATASET_SCALE.json")) as fh:
        jax_record = json.load(fh)
    assert list(record) == list(jax_record) + ["card"]
    for grism in ds.GRISMS:
        assert list(record["grisms"][grism]) == \
            list(jax_record["grisms"][grism])
    assert record["backend"] == "cpu" and record["device"] == "cpu"
    assert record["card"] is None and record["subarray"] == SMALL["S"]


def test_committed_record_is_the_cards():
    with open(os.path.join(REPO, "DATASET_SCALE.json")) as fh:
        jax_record = json.load(fh)
    with open(os.path.join(REPO, "DATASET_SCALE_TORCH.json")) as fh:
        record = json.load(fh)
    assert set(record) == set(jax_record) | {"card"}
    assert record["backend"] == "cuda" and record["card"]
    assert record["n_per_grism"] >= 1000
    assert all(record["grisms"][g]["resume_ok"] for g in ds.GRISMS)


def test_raises_without_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "r.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.main(["22", "--out", str(out)])
    assert not out.exists()

"""The port's Monte-Carlo dataset path (wayne_tpu_torch.parallel, run_dataset)
against the JAX package's on the CPU: the ensemble's spectra on identical
inputs with the stochastic effects off, the CR-aware extraction on the
port's own noisy reads, the scene sweeps, and generate_dataset's chunking,
resume checks and files."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu.calibration import synthetic_tables
from wayne_tpu.config import ExposureStatic, NoiseFlags
from wayne_tpu.parallel import dataset as dataset_j
from wayne_tpu.parallel import ensemble as ensemble_j
from wayne_tpu.parallel.mesh import make_mesh, shard_scenes
from wayne_tpu.reduction import extract_spectra_cr as extract_spectra_cr_j
from wayne_tpu.scene import example_scene
from wayne_tpu_torch import config as config_t
from wayne_tpu_torch.convert import (
    numpy_leaves, scenes_from_numpy, tables_from_numpy,
)
from wayne_tpu_torch.ops import readout
from wayne_tpu_torch.ops.exposure import simulate_exposure
from wayne_tpu_torch.parallel.dataset import (
    _fingerprint, generate_dataset, load_dataset, sweep_scenes,
)
from wayne_tpu_torch.parallel.ensemble import (
    mc_scenes, simulate_ensemble_spectra,
)
from wayne_tpu_torch.parallel.mesh import make_mesh as make_mesh_t
from wayne_tpu_torch.parallel.torch_data import WayneSpectraDataset
from wayne_tpu_torch.pytree import tree_map
from wayne_tpu_torch.reduction import extract_spectra_cr
from wayne_tpu_torch.run_dataset import main as run_dataset

torch.set_num_threads(1)

S, NL, NSAMP = 64, 32, 3
# every deterministic effect on (non-linearity, bias, gain map, IPC ...);
# Poisson, read noise, cosmic rays and the bias drift off (the two
# packages draw their random numbers from different generators)
DETERMINISTIC = dataclasses.replace(NoiseFlags.all(), poisson=False,
                                    read_noise=False, cosmic_rays=False,
                                    bias_drift=False)
CFG = ExposureStatic(subarray=S, n_lambda=NL, n_sub=2, nsamp=NSAMP,
                     samp_seq="SPARS10", scan=True, max_cr_per_read=8,
                     transit_quad=16, band_px=16, noise=NoiseFlags.all())
TABLES = synthetic_tables("G141", subarray=S, n_lambda=NL,
                          samp_seq="SPARS10", nsamp=NSAMP)


def _static_t(cfg_j: ExposureStatic) -> config_t.ExposureStatic:
    kw = dataclasses.asdict(cfg_j)
    kw["noise"] = config_t.NoiseFlags(**kw["noise"])
    return config_t.ExposureStatic(**kw)


def _visit_j(n_exp=4):
    """A JAX visit whose spectrum lands on the 64^2 frame."""
    base = dataclasses.replace(example_scene(NL, scan_speed=1.0),
                               x_ref=jnp.float32(10.0),
                               y_ref=jnp.float32(10.0))
    visit = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (n_exp,) + x.shape), base)
    return dataclasses.replace(
        visit, exp_start_s=jnp.arange(n_exp, dtype=jnp.float32) * 600.0)


def _visit_t(n_exp=4):
    return scenes_from_numpy(numpy_leaves(_visit_j(n_exp)), "cpu")


TABLES_T = tables_from_numpy(numpy_leaves(TABLES), "cpu")
CFG_T = _static_t(CFG)


@pytest.mark.parametrize("ramp", [False, True], ids=["cds", "ramp"])
@pytest.mark.parametrize("dq_aware", [True, False],
                         ids=["dq_aware", "raw_cr"])
def test_ensemble_spectra_match_jax(dq_aware, ramp):
    """simulate_ensemble_spectra on a visit carried across by convert.py,
    the deterministic effects on and NLINCORR on: the JAX package's
    spectra (through a mesh of one CPU device) at rtol 2e-5, the bar of
    reads_dn in tests/test_torch_exposure.py."""
    cfg = dataclasses.replace(CFG, noise=DETERMINISTIC)
    n_mc = 2
    mesh = make_mesh(jax.devices()[:1])
    ens_j = shard_scenes(ensemble_j.mc_scenes(_visit_j(3), n_mc), mesh)
    want = np.asarray(ensemble_j.simulate_ensemble_spectra(
        ens_j, TABLES, cfg, mesh, ramp=ramp, dq_aware=dq_aware))
    got = simulate_ensemble_spectra(
        mc_scenes(_visit_t(3), n_mc), TABLES_T, _static_t(cfg), ramp=ramp,
        dq_aware=dq_aware, chunk=2).numpy()
    assert got.shape == (n_mc, 3, S)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    # the spectrum is on the frame
    assert float(got.max()) > 10.0 * float(np.median(got))


def test_extract_spectra_cr_matches_jax_on_the_ports_noisy_reads():
    """The port's reads and hit lists with the whole noise chain on and a
    cosmic-ray rate that puts several hits in each interval: the port's
    extraction and the JAX package's on the same arrays agree at rtol
    1e-5, CDS and up-the-ramp."""
    tables = tables_from_numpy(numpy_leaves(dataclasses.replace(
        TABLES, cr_rate_px_s=jnp.float32(2e-4))), "cpu")
    one = tree_map(lambda x: x[0], mc_scenes(_visit_t(2), 1))
    res = simulate_exposure(one, tables, CFG_T)
    assert int(res.cr_count.sum()) > 10
    for read_times in (None, TABLES_T.read_times):
        got = extract_spectra_cr(res.reads_dn, res.cr_pos, res.cr_count,
                                 read_times).numpy()
        want = np.stack([np.asarray(extract_spectra_cr_j(
            jnp.asarray(res.reads_dn[b].numpy()),
            jnp.asarray(res.cr_pos[b].numpy()),
            jnp.asarray(res.cr_count[b].numpy()),
            None if read_times is None else jnp.asarray(read_times.numpy())))
            for b in range(2)])
        np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# mc_scenes / sweep_scenes: tests/test_dataset.py's cases, mirrored
# ---------------------------------------------------------------------------

def _leaves_but_keys(scene) -> dict:
    out = numpy_leaves(scene)
    out.pop("key", None)
    out.pop("seed", None)
    return out


def _assert_same_leaves(a: dict, b: dict) -> None:
    """The port's leaves ``a`` equal the JAX package's ``b``; the JAX
    Scene's optional leaves that the port lacks are absent there too."""
    assert set(a) <= set(b)
    assert all(b[k] is None for k in set(b) - set(a))
    for k, v in a.items():
        if isinstance(v, dict):
            _assert_same_leaves(v, b[k])
        elif v is None:
            assert b[k] is None, k
        else:
            np.testing.assert_array_equal(v, b[k], err_msg=k)


@pytest.mark.parametrize("case", ["rp_over_exposures", "scalar_field",
                                  "bad_shape"])
def test_sweep_scenes_matches_jax(case):
    """The three cases of tests/test_dataset.py::TestSweep on both
    packages: every leaf but the keys equal, the same errors."""
    if case == "rp_over_exposures":
        n_mc, over = 6, {"rp_over_rs": np.linspace(0.1, 0.2, 6)[:, None]
                         * np.ones((6, NL))}
    elif case == "scalar_field":
        n_mc, over = 4, {"scan_speed": np.array([0.5, 1.0, 1.5, 2.0])}
    else:
        n_mc, over = 4, {"scan_speed": np.ones(3)}
    if case == "bad_shape":
        with pytest.raises(ValueError):
            dataset_j.sweep_scenes(_visit_j(), n_mc, overrides=over)
        with pytest.raises(ValueError, match="n_mc"):
            sweep_scenes(_visit_t(), n_mc, overrides=over)
        return
    ens_j = dataset_j.sweep_scenes(
        _visit_j(), n_mc, overrides={k: jnp.asarray(v)
                                     for k, v in over.items()})
    ens = sweep_scenes(_visit_t(), n_mc, overrides=over)
    assert ens.seed.shape == (n_mc, 4, 2)
    _assert_same_leaves(_leaves_but_keys(ens), _leaves_but_keys(ens_j))


def test_sweep_scenes_rejects_a_wrong_exposure_axis():
    with pytest.raises(ValueError, match="exposure axis"):
        sweep_scenes(_visit_t(), 2, overrides={"scan_speed": np.ones((2, 3))})


def test_seed_words_differ_per_realisation_and_exposure_and_follow_the_index():
    """Every (realisation, exposure) has its own seed words, and they
    depend only on the root seed and the GLOBAL realisation index."""
    whole = mc_scenes(_visit_t(), 6, seed=3).seed
    assert len({tuple(w) for w in whole.reshape(-1, 2).tolist()}) == 24
    part = mc_scenes(_visit_t(), 2, seed=3, mc_offset=4).seed
    assert torch.equal(part, whole[4:])
    assert not torch.equal(mc_scenes(_visit_t(), 6, seed=4).seed, whole)


# ---------------------------------------------------------------------------
# generate_dataset
# ---------------------------------------------------------------------------

def _generate(d, **kw):
    kw = dict(dict(n_mc=4, chunk_mc=2, device="cpu"), **kw)
    return generate_dataset(_visit_t(), TABLES_T, kw.pop("cfg", CFG_T),
                            str(d), **kw)


def test_generate_dataset_is_chunk_size_invariant(tmp_path):
    """Realisation i is keyed by its GLOBAL index: runs chunked 2 and 4
    realisations give bit-identical spectra, the whole noise chain on."""
    _generate(tmp_path / "two", chunk_mc=2)
    _generate(tmp_path / "four", chunk_mc=4)
    a = load_dataset(str(tmp_path / "two"))["spectra_e"]
    b = load_dataset(str(tmp_path / "four"))["spectra_e"]
    assert a.shape == (4, 4, S) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[0], a[1])        # independent noise


def test_generate_dataset_does_not_depend_on_the_exposure_batch(tmp_path):
    """``chunk`` (exposures per readout launch) changes no bit: 1, 3 (the
    visit padded) and 4."""
    runs = []
    for chunk in (1, 3, 4):
        d = tmp_path / f"c{chunk}"
        _generate(d, chunk=chunk, n_mc=2)
        runs.append(load_dataset(str(d))["spectra_e"])
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])


def test_generate_dataset_writes_resumes_and_loads(tmp_path):
    """The JAX package's files and manifest; a second call skips every
    chunk; load_dataset and the torch adapter read it back."""
    rp = np.linspace(0.9, 1.1, 4)
    over = {"scan_speed": np.full((4,), 1.0)}
    log = []
    m = _generate(tmp_path, overrides=over, labels={"rp_scale": rp},
                  progress=log.append)
    assert m["chunks"] == ["chunk_0000.npz", "chunk_0001.npz"]
    assert sum("wrote" in s for s in log) == 2
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest == m
    assert set(manifest) == {"n_mc", "chunk_mc", "n_exp", "subarray", "seed",
                             "dq_aware", "labels", "chunk_inputs_sha",
                             "recovered", "recover", "nlincorr", "keys",
                             "mesh", "chunks"}
    assert manifest["keys"] == "wayne_tpu_torch" and manifest["nlincorr"]
    assert manifest["mesh"] == [1, 1]          # no mesh: one device
    with np.load(tmp_path / "chunk_0001.npz") as z:
        assert set(z.files) == {"spectra_e", "label_rp_scale"}
        assert z["spectra_e"].shape == (2, 4, S)
    assert not list(tmp_path.glob("*.tmp.npz"))
    # the content fingerprints are the JAX package's for the same inputs
    assert manifest["chunk_inputs_sha"] == \
        dataset_j._chunk_input_fingerprints(4, 2, over, {"rp_scale": rp})
    assert _fingerprint([{"a": np.arange(3)}]) == \
        dataset_j._fingerprint([{"a": np.arange(3)}])

    log2 = []
    _generate(tmp_path, overrides=over, labels={"rp_scale": rp},
              progress=log2.append)
    assert len(log2) == 2 and all("skipping" in s for s in log2)
    data = load_dataset(str(tmp_path))
    assert data["spectra_e"].shape == (4, 4, S)
    np.testing.assert_allclose(data["label_rp_scale"], rp)
    assert np.isfinite(data["spectra_e"]).all()

    # a truncated chunk is regenerated, bit for bit
    with open(tmp_path / "chunk_0000.npz", "r+b") as fh:
        fh.truncate(100)
    log3 = []
    _generate(tmp_path, overrides=over, labels={"rp_scale": rp},
              progress=log3.append)
    assert any("regenerating" in s for s in log3)
    np.testing.assert_array_equal(load_dataset(str(tmp_path))["spectra_e"],
                                  data["spectra_e"])


@pytest.mark.parametrize("change", [
    "seed", "chunk_mc", "dq_aware", "nlincorr", "labels", "label_content",
    "chunk_keys", "short_labels"])
def test_generate_dataset_resume_mismatch_raises(tmp_path, change):
    """Every setting and input that shaped the written chunks is checked
    on resume, with the JAX package's errors."""
    rp = np.linspace(0.9, 1.1, 4)
    _generate(tmp_path, labels={"rp_scale": rp})
    kw = dict(labels={"rp_scale": rp})
    match = "resume mismatch"
    if change == "seed":
        kw["seed"] = 99
    elif change == "chunk_mc":
        kw["chunk_mc"] = 4
    elif change == "dq_aware":
        kw["dq_aware"] = False
    elif change == "nlincorr":
        kw["cfg"] = dataclasses.replace(CFG_T, noise=dataclasses.replace(
            CFG_T.noise, non_linearity=False))
        match = "nlincorr"
    elif change == "labels":
        kw["labels"] = {"other": rp}
    elif change == "label_content":
        bad = rp.copy()
        bad[0] += 0.05
        kw["labels"] = {"rp_scale": bad}
        match = "content differs"
    elif change == "chunk_keys":
        # a chunk holding other arrays than this run writes
        with np.load(tmp_path / "chunk_0000.npz") as z:
            payload = dict(z)
        np.savez_compressed(tmp_path / "chunk_0000.npz", extra=np.zeros(1),
                            **payload)
        match = "holds"
    else:
        kw["labels"] = {"rp_scale": rp[:3]}
        match = "rows"
    with pytest.raises(ValueError, match=match):
        _generate(tmp_path, **kw)


def test_generate_dataset_refuses_a_directory_the_jax_package_wrote(tmp_path):
    """The same seed makes other realisations in the other package: a
    directory written by the JAX package does not resume here."""
    dataset_j.generate_dataset(_visit_j(), TABLES, CFG, str(tmp_path),
                               n_mc=4, chunk_mc=2,
                               mesh=make_mesh(jax.devices()[:1]))
    with pytest.raises(ValueError, match="keys"):
        _generate(tmp_path)


def test_generate_dataset_recover_raises(tmp_path):
    """recover= is ported (tests/test_torch_recover.py); what still raises
    is turning it on over chunks written without it, and n_chan < 1, as in
    the JAX package."""
    visit = _visit_t()
    recover = {"exp_mid_s": np.zeros(4, np.float32),
               "orbit": tree_map(lambda x: x[0], visit.orbit),
               "ld": visit.ld[0], "rp0": 0.15, "x_window": (10, 50),
               "n_chan": 2}
    _generate(tmp_path)
    with pytest.raises(ValueError, match="resume mismatch"):
        _generate(tmp_path, recover=recover)
    with pytest.raises(ValueError, match="n_chan"):
        _generate(tmp_path / "zero", recover=dict(recover, n_chan=0))


def test_torch_adapter_over_the_ports_dataset(tmp_path):
    rp = np.linspace(0.9, 1.1, 4)
    _generate(tmp_path, labels={"rp_scale": rp})
    ds = WayneSpectraDataset(str(tmp_path))
    assert len(ds) == 4
    spectra, labels = ds[3]
    assert spectra.shape == (4, S) and spectra.dtype == np.float32
    np.testing.assert_array_equal(spectra,
                                  load_dataset(str(tmp_path))["spectra_e"][3])
    np.testing.assert_allclose(labels["rp_scale"], rp[3])
    with pytest.raises(IndexError):
        ds[4]
    from torch.utils.data import DataLoader
    xb, yb = next(iter(DataLoader(WayneSpectraDataset(str(tmp_path),
                                                      as_torch=True),
                                  batch_size=4)))
    assert xb.shape == (4, 4, S) and yb["rp_scale"].shape == (4,)


# ---------------------------------------------------------------------------
# run_dataset
# ---------------------------------------------------------------------------

TINY_YAML = """\
observation:
  grism: G141
  subarray: 64
  NSAMP: 2
  SAMPSEQ: SPARS10
  scan: true
  x_ref: 10.0
  y_ref: 10.0
  num_orbits: 1
  exposures_per_orbit: 3
  n_lambda: 16
  n_sub: 2
"""


def test_run_dataset_cpu_writes_a_dataset_that_loads(tmp_path):
    """``--cpu`` on a tiny visit: 4 realisations in 2 chunks, the swept
    Rp/Rs as a label; every B1 call on the CPU goes to the plain version
    (no launch)."""
    yml = tmp_path / "pars.yml"
    yml.write_text(TINY_YAML)
    out = tmp_path / "ds"
    readout.exposure_readout.launches = 0
    assert run_dataset(["-p", str(yml), "-o", str(out), "--n-mc", "4",
                        "--chunk-mc", "2", "--rp-sigma", "0.002",
                        "--cpu"]) == 0
    assert readout.exposure_readout.launches == 0
    data = load_dataset(str(out))
    assert data["spectra_e"].shape == (4, 3, 64)
    assert np.isfinite(data["spectra_e"]).all()
    assert data["label_rp"].shape == (4,) and np.std(data["label_rp"]) > 0
    spectra, labels = WayneSpectraDataset(str(out))[2]
    np.testing.assert_array_equal(spectra, data["spectra_e"][2])
    assert float(labels["rp"]) == float(data["label_rp"][2])


def test_run_dataset_unported_flags_raise(tmp_path):
    yml = tmp_path / "pars.yml"
    yml.write_text(TINY_YAML)
    argv = ["-p", str(yml), "-o", str(tmp_path / "ds"), "--n-mc", "2",
            "--chunk-mc", "2", "--cpu"]
    with pytest.raises(SystemExit):            # --recover is ported; 0
        run_dataset(argv + ["--recover", "0"])  # channels is refused
    with pytest.raises(SystemExit):            # no eclipse in the visit
        run_dataset(argv + ["--fp-sigma", "1e-4"])


def test_jax_style_positional_mesh_cannot_switch_estimator():
    """The JAX signature is (scenes, tables, cfg, mesh, ramp=...): a call
    written for it either raises (a JAX mesh: TypeError naming the port's
    make_mesh) or returns the CDS spectra (None, or the port's own mesh, in
    mesh's place), never up-the-ramp slopes."""
    ens = mc_scenes(_visit_t(2), 1)
    cds = simulate_ensemble_spectra(ens, TABLES_T, CFG_T, chunk=2)
    mesh = make_mesh(jax.devices()[:1])
    with pytest.raises(TypeError, match="wayne_tpu_torch.parallel.make_mesh"):
        simulate_ensemble_spectra(ens, TABLES_T, CFG_T, mesh)
    assert torch.equal(simulate_ensemble_spectra(ens, TABLES_T, CFG_T, None,
                                                 chunk=2), cds)
    assert torch.equal(simulate_ensemble_spectra(
        ens, TABLES_T, CFG_T, make_mesh_t(["cpu"]), chunk=2), cds)
    with pytest.raises(TypeError):         # ramp is keyword-only
        simulate_ensemble_spectra(ens, TABLES_T, CFG_T, None, True)
    ramp = simulate_ensemble_spectra(ens, TABLES_T, CFG_T, ramp=True,
                                     chunk=2)
    assert not torch.equal(ramp, cds)


def test_charge_memory_maps_stay_one_buffer_and_rts_warns():
    """mc_scenes views the visit's persist_rate and trap_mult (no copy per
    realisation), realisations see the same maps, and active unstable
    pixels warn that the column sums carry them unrepaired."""
    visit = _visit_t(3)
    maps = torch.rand((3, S, S), generator=torch.Generator().manual_seed(0))
    visit = dataclasses.replace(visit, persist_rate=maps,
                                trap_mult=1.0 - 0.01 * maps)
    ens = mc_scenes(visit, 4)
    for name in ("persist_rate", "trap_mult"):
        leaf = getattr(ens, name)
        assert leaf.shape == (4, 3, S, S) and leaf.stride(0) == 0
        assert leaf.data_ptr() == getattr(visit, name).data_ptr()
    noise_off = dataclasses.replace(CFG_T, noise=config_t.NoiseFlags.none())
    sp = simulate_ensemble_spectra(ens, TABLES_T, noise_off, chunk=2)
    assert torch.equal(sp[0], sp[3])
    bare = simulate_ensemble_spectra(mc_scenes(_visit_t(3), 1), TABLES_T,
                                     noise_off, chunk=2)
    assert not torch.equal(sp[0], bare[0])
    rts = dataclasses.replace(TABLES_T, rts_amp=torch.full((S, S), 0.05))
    with pytest.warns(UserWarning, match="rts_amp"):
        simulate_ensemble_spectra(mc_scenes(_visit_t(2), 1), rts,
                                  noise_off, chunk=2)

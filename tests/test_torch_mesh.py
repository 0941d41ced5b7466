"""The port's (mc, exp) mesh (wayne_tpu_torch.parallel.mesh) and every
entry point that takes one, on the CPU: make_mesh and shard_scenes against
the JAX package's mesh on its eight virtual CPU devices; sharded runs
against the one-device run bit for bit with the noise on (the ensemble,
simulate_visit_sharded, Observation.generate, generate_dataset with
recovered labels); the noise-off sharded spectra against the JAX package's
sharded spectra; the refusals, the worker threads and run_visit
--all-devices.

A mesh of the CPU device listed n times, ``make_mesh(["cpu"] * n)``, is the
port's counterpart of JAX's n virtual CPU devices."""

import dataclasses
import glob
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec

from wayne_tpu.calibration import synthetic_tables
from wayne_tpu.config import ExposureStatic, NoiseFlags
from wayne_tpu.parallel import ensemble as ensemble_j
from wayne_tpu.parallel import mesh as mesh_j
from wayne_tpu.scene import example_scene
from wayne_tpu_torch import config as config_t
from wayne_tpu_torch.config import config_from_dict
from wayne_tpu_torch.convert import (
    numpy_leaves, scenes_from_numpy, seed_from_key, tables_from_numpy,
)
from wayne_tpu_torch.io.fits import read_fits
from wayne_tpu_torch.observation import Observation
from wayne_tpu_torch.ops import readout
from wayne_tpu_torch.ops.kepler import OrbitParams
from wayne_tpu_torch.ops.visit import simulate_visit, simulate_visit_sharded
from wayne_tpu_torch.parallel.dataset import generate_dataset, load_dataset
from wayne_tpu_torch.parallel.ensemble import (
    mc_scenes, simulate_ensemble_spectra,
)
from wayne_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, run_on_mesh, shard_scenes,
)
from wayne_tpu_torch.pytree import leaves
from wayne_tpu_torch.run_visit import main as run_visit

torch.set_num_threads(1)

S, NL, NSAMP = 64, 32, 3
CFG = ExposureStatic(subarray=S, n_lambda=NL, n_sub=2, nsamp=NSAMP,
                     samp_seq="SPARS10", scan=True, max_cr_per_read=8,
                     transit_quad=16, band_px=16, noise=NoiseFlags.all())
# the deterministic effects only: the two packages draw different bits
DETERMINISTIC = dataclasses.replace(CFG, noise=dataclasses.replace(
    NoiseFlags.all(), poisson=False, read_noise=False, cosmic_rays=False,
    bias_drift=False))
TABLES = synthetic_tables("G141", subarray=S, n_lambda=NL,
                          samp_seq="SPARS10", nsamp=NSAMP)
TABLES_T = tables_from_numpy(numpy_leaves(TABLES), "cpu")
CPU8 = ["cpu"] * 8


def _static_t(cfg: ExposureStatic) -> config_t.ExposureStatic:
    kw = dataclasses.asdict(cfg)
    kw["noise"] = config_t.NoiseFlags(**kw["noise"])
    return config_t.ExposureStatic(**kw)


CFG_T = _static_t(CFG)


def _visit_j(n_exp: int, charge_memory: bool = False):
    """A JAX visit whose spectrum lands on the 64^2 frame; with
    ``charge_memory`` it carries persistence and trap maps (seeded)."""
    base = dataclasses.replace(example_scene(NL, scan_speed=1.0),
                               x_ref=jnp.float32(10.0),
                               y_ref=jnp.float32(10.0))
    visit = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (n_exp,) + x.shape), base)
    visit = dataclasses.replace(
        visit, exp_start_s=jnp.arange(n_exp, dtype=jnp.float32) * 600.0)
    if charge_memory:
        rng = np.random.RandomState(5)
        maps = rng.uniform(0.0, 2.0, (n_exp, S, S)).astype(np.float32)
        visit = dataclasses.replace(
            visit, persist_rate=jnp.asarray(maps),
            trap_mult=jnp.asarray(1.0 - 0.01 * maps))
    return visit


def _visit_t(n_exp: int, charge_memory: bool = False):
    return scenes_from_numpy(numpy_leaves(_visit_j(n_exp, charge_memory)),
                             "cpu")


def _same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# make_mesh and shard_scenes against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_factorises_as_jax(n):
    """JAX's shape for n devices, with the default and every mc_shards
    from 0 to n + 1, and JAX's ValueError texts where it refuses."""
    devs = jax.devices()[:n]
    assert make_mesh(["cpu"] * n).devices.shape == \
        mesh_j.make_mesh(devs).devices.shape
    for mc in range(0, n + 2):
        try:
            want = mesh_j.make_mesh(devs, mc).devices.shape
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                make_mesh(["cpu"] * n, mc)
            assert str(got.value) == str(err)
        else:
            mesh = make_mesh(["cpu"] * n, mc)
            assert mesh.devices.shape == want
            assert mesh.shape == {"mc": want[0], "exp": want[1]}
            assert mesh.axis_names == ("mc", "exp")
            assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def _jax_pairs(block, jax_tree, prefix=""):
    """(name, the port block's leaf, the JAX tree's leaf) over the port
    Scene's present leaves; the port's ``seed`` pairs with JAX's ``key``."""
    for f in dataclasses.fields(block):
        v = getattr(block, f.name)
        if v is None:
            continue
        jv = getattr(jax_tree, "key" if f.name == "seed" else f.name)
        if dataclasses.is_dataclass(v):
            yield from _jax_pairs(v, jv, prefix + f.name + ".")
        else:
            yield prefix + f.name, v, jv


def _shard_on(arr, device) -> np.ndarray:
    shard, = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


@pytest.mark.parametrize("layout", ["ensemble", "visit"])
def test_shard_scenes_blocks_are_the_jax_shards(layout):
    """Every leaf's block at every mesh position = the JAX global array
    sliced at that device's shard index, on the 8 virtual devices. The
    ensemble: JAX's ``shard_scenes`` of its ``mc_scenes`` ((4, 2) mesh;
    the charge-memory maps cut on 'exp' only, one copy per exposure block
    shared by the mc positions). The visit (one batch axis): the exposure
    axis over the flattened mesh, as ``simulate_visit_sharded`` lays it
    out."""
    jmesh = mesh_j.make_mesh(jax.devices())
    mesh = make_mesh(CPU8)
    assert jmesh.devices.shape == mesh.devices.shape == (4, 2)
    if layout == "ensemble":
        ens_j = ensemble_j.mc_scenes(_visit_j(4, charge_memory=True), 8,
                                     seed=2)
        placed = mesh_j.shard_scenes(ens_j, jmesh)
        sharded = shard_scenes(scenes_from_numpy(numpy_leaves(ens_j), "cpu"),
                               mesh)
        positions = list(np.ndindex(4, 2))
        jdev = lambda pos: jmesh.devices[pos]
    else:
        visit_j = _visit_j(16, charge_memory=True)
        flat = JaxMesh(jmesh.devices.reshape(-1), ("exp",))
        placed = jax.tree_util.tree_map(lambda x: jax.device_put(
            x, NamedSharding(flat, PartitionSpec("exp"))), visit_j)
        sharded = shard_scenes(scenes_from_numpy(numpy_leaves(visit_j),
                                                 "cpu"), mesh, 1)
        positions = list(np.ndindex(4, 2))
        jdev = lambda pos: flat.devices[pos[0] * 2 + pos[1]]
    assert sharded.batch_shape == ((8, 4) if layout == "ensemble" else (16,))
    n_checked = 0
    for pos in positions:
        block = sharded.blocks[pos]
        for name, got, want_arr in _jax_pairs(block, placed):
            want = _shard_on(want_arr, jdev(pos))
            if name == "seed":
                want = seed_from_key(want)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            n_checked += 1
    assert n_checked > 8 * 20
    if layout == "ensemble":
        # the maps: one copy per exposure block, shared along 'mc'
        ptrs = {pos: sharded.blocks[pos].persist_rate.data_ptr()
                for pos in positions}
        assert ptrs[(0, 0)] == ptrs[(3, 0)] != ptrs[(0, 1)]


def test_shard_scenes_shares_mc_scenes_expanded_maps():
    """The port's own mc_scenes views one (n_exp, S, S) map per leaf over
    every realisation: each position's block views the exposure block's one
    copy over its realisations."""
    ens = mc_scenes(_visit_t(4, charge_memory=True), 8, seed=1)
    sharded = shard_scenes(ens, make_mesh(CPU8))
    for (i, j), block in np.ndenumerate(sharded.blocks):
        leaf = block.trap_mult
        assert leaf.shape == (2, 2, S, S) and leaf.stride(0) == 0
        assert torch.equal(leaf[1], ens.trap_mult[0, 2 * j:2 * j + 2])
        assert torch.equal(block.seed, ens.seed[2 * i:2 * i + 2,
                                                2 * j:2 * j + 2])


# ---------------------------------------------------------------------------
# Sharded = one device, noise on, bit for bit
# ---------------------------------------------------------------------------

def test_sharded_ensemble_equals_one_device_bit_for_bit():
    """simulate_ensemble_spectra on make_mesh(["cpu"] * 8), the (4, 2)
    mesh, against mesh=None with chunk = n_exp / 2 on both: the whole
    noise chain on, cosmic rays repaired, the charge-memory maps on."""
    ens = mc_scenes(_visit_t(4, charge_memory=True), 4, seed=11)
    mesh = make_mesh(CPU8)
    one = simulate_ensemble_spectra(ens, TABLES_T, CFG_T, chunk=2)
    sharded = simulate_ensemble_spectra(ens, TABLES_T, CFG_T, mesh, chunk=2)
    assert sharded.shape == one.shape == (4, 4, S)
    assert torch.equal(sharded, one)
    # a ShardedScenes cut for this mesh is taken as it is
    again = simulate_ensemble_spectra(shard_scenes(ens, mesh), TABLES_T,
                                      CFG_T, mesh, chunk=2)
    assert torch.equal(again, one)
    assert not torch.equal(one[0], one[1])      # realisations differ


def test_simulate_visit_sharded_equals_simulate_visit():
    """Eight exposures over a mesh of four, 2 a launch, against
    simulate_visit at chunk 2: every output bit for bit, in global order."""
    visit = _visit_t(8)
    want = simulate_visit(visit, TABLES_T, CFG_T, 2)
    got = simulate_visit_sharded(visit, TABLES_T, CFG_T,
                                 make_mesh(["cpu"] * 4), 2)
    assert got.reads_dn.shape == (8, NSAMP + 1, S, S)
    assert _same(got, want)
    assert int(got.cr_count.sum()) > 0


# the JAX package's tests/test_parallel.py visit
GEN_PARS = dict(grism="G141", subarray=64, nsamp=2, samp_seq="RAPID",
                scan=True, x_ref=15.0, y_ref=20.0, n_orbits=1,
                exposures_per_orbit=8, n_lambda=32, n_sub=2, seed=7)


def _planes(path) -> dict:
    hdus = read_fits(path)
    out = {"EXPSTART": hdus[0][0]["EXPSTART"]}
    for h, d in hdus[1:]:
        if h.get("EXTNAME") in ("SCI", "DQ", "TIME"):
            out[(h["EXTNAME"], h.get("EXTVER"))] = d
    return out


def test_generate_sharded_matches_single_device(tmp_path):
    """Observation.generate(mesh=make_mesh(["cpu"] * 4), chunk=1) against
    generate(chunk=1): every file's SCI, DQ and TIME planes and EXPSTART
    equal (the files byte for byte). A resume skips the steps on disk and
    recomputes the one with a missing file."""
    obs = Observation(config_from_dict(GEN_PARS), device="cpu")
    mesh = make_mesh(["cpu"] * 4)
    one, sh = tmp_path / "single", tmp_path / "mesh"
    singles = obs.generate(str(one), chunk=1, progress=lambda s: None)
    sharded = obs.generate(str(sh), chunk=1, mesh=mesh,
                           progress=lambda s: None)
    assert len(singles) == len(sharded) == 8
    for p1, p2 in zip(singles, sharded):
        a, b = _planes(p1), _planes(p2)
        assert a.keys() == b.keys() and len(a) == 1 + 3 * 3
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
        with open(p1, "rb") as f1, open(p2, "rb") as f2:
            assert f1.read() == f2.read()
    os.remove(sharded[5])
    said = []
    again = obs.generate(str(sh), chunk=1, mesh=mesh, progress=said.append)
    assert again == [sharded[5]]
    assert [s for s in said if s.endswith("written")] == [
        "exposure 6/8 written"]
    with open(singles[5], "rb") as f1, open(sharded[5], "rb") as f2:
        assert f1.read() == f2.read()


# recovered labels need a transit across the visit: the trace fills
# columns 0-60 at x_ref = -120, 16 exposures over 4 h around the transit
N_EXP_REC = 16


def _recover_inputs():
    base = dataclasses.replace(example_scene(NL, scan_speed=1.0),
                               x_ref=jnp.float32(-120.0),
                               y_ref=jnp.float32(8.0))
    starts = np.linspace(0.0, 4.0 * 3600.0, N_EXP_REC).astype(np.float32)
    visit = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N_EXP_REC,) + x.shape), base)
    visit = dataclasses.replace(visit, exp_start_s=jnp.asarray(starts))
    orbit = OrbitParams(**{f.name: torch.as_tensor(np.asarray(
        getattr(base.orbit, f.name))) for f in dataclasses.fields(
            OrbitParams)})
    recover = {"exp_mid_s": starts + float(TABLES.read_times[-1]) / 2.0,
               "orbit": orbit, "ld": torch.as_tensor(np.asarray(base.ld)),
               "rp0": 0.15, "x_window": (0, 61), "n_chan": 3}
    return scenes_from_numpy(numpy_leaves(visit), "cpu"), recover


def test_generate_dataset_sharded_equals_one_device(tmp_path):
    """generate_dataset(mesh=make_mesh(["cpu"] * 8)) with recovered labels
    against mesh=None, chunk = n_exp / 2: every chunk file's arrays, the
    recovered labels included, bit for bit; the manifest records the
    mesh; a directory written under one mesh resumes under another."""
    visit, recover = _recover_inputs()
    rp = np.linspace(0.13, 0.18, 8).astype(np.float32)
    kw = dict(n_mc=8, chunk_mc=4, seed=3, labels={"rp": rp},
              overrides={"rp_over_rs": np.broadcast_to(rp[:, None],
                                                       (8, NL))},
              recover=recover, chunk=N_EXP_REC // 2)
    m_one = generate_dataset(visit, TABLES_T, CFG_T, str(tmp_path / "one"),
                             device="cpu", **kw)
    m_mesh = generate_dataset(visit, TABLES_T, CFG_T, str(tmp_path / "mesh"),
                              mesh=make_mesh(CPU8), **kw)
    assert m_one["mesh"] == [1, 1] and m_mesh["mesh"] == [4, 2]
    assert m_one["chunks"] == m_mesh["chunks"] == ["chunk_0000.npz",
                                                   "chunk_0001.npz"]
    for name in m_one["chunks"]:
        with np.load(tmp_path / "one" / name) as a, \
                np.load(tmp_path / "mesh" / name) as b:
            assert set(a.files) == set(b.files) and "recovered_rp" in a.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    data = load_dataset(str(tmp_path / "mesh"))
    assert data["spectra_e"].shape == (8, N_EXP_REC, S)
    assert np.isfinite(data["recovered_rp"]).all()
    # resume under another mesh: every chunk is on disk, none recomputed
    said = []
    generate_dataset(visit, TABLES_T, CFG_T, str(tmp_path / "mesh"),
                     mesh=make_mesh(["cpu"] * 2, mc_shards=1),
                     progress=said.append, **kw)
    assert said == ["chunk 0: exists, skipping", "chunk 1: exists, skipping"]


# ---------------------------------------------------------------------------
# Against the JAX package's sharded run, noise off
# ---------------------------------------------------------------------------

def test_sharded_ensemble_matches_jax_sharded():
    """The port's (4, 2) CPU mesh against the JAX package's
    simulate_ensemble_spectra on make_mesh(jax.devices()), the
    deterministic effects and NLINCORR on: rtol 2e-5, the bar of
    tests/test_torch_ensemble.py. One JAX trace."""
    jmesh = mesh_j.make_mesh(jax.devices())
    ens_j = ensemble_j.mc_scenes(_visit_j(4), 4, seed=4)
    want = np.asarray(ensemble_j.simulate_ensemble_spectra(
        mesh_j.shard_scenes(ens_j, jmesh), TABLES, DETERMINISTIC, jmesh))
    got = simulate_ensemble_spectra(
        mc_scenes(_visit_t(4), 4, seed=4), TABLES_T,
        _static_t(DETERMINISTIC), make_mesh(CPU8), chunk=2).numpy()
    assert got.shape == want.shape == (4, 4, S)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert float(got.max()) > 10.0 * float(np.median(got))


# ---------------------------------------------------------------------------
# Refusals, the worker threads, the CLI
# ---------------------------------------------------------------------------

def test_mesh_refusals(tmp_path):
    """JAX's divisibility errors in each entry point; a JAX mesh raises
    TypeError naming make_mesh; a CUDA mesh raises without a card;
    generate_dataset's device must be the mesh's first."""
    mesh = make_mesh(CPU8)                               # (4, 2)
    ens = mc_scenes(_visit_t(4), 2)
    with pytest.raises(ValueError, match="n_mc 2 not a multiple"):
        simulate_ensemble_spectra(ens, TABLES_T, CFG_T, mesh)
    with pytest.raises(ValueError, match="n_exp 3 not a multiple"):
        simulate_ensemble_spectra(mc_scenes(_visit_t(3), 4), TABLES_T,
                                  CFG_T, mesh)
    with pytest.raises(ValueError, match="devices\\*chunk = 8\\*2"):
        simulate_visit_sharded(_visit_t(8), TABLES_T, CFG_T, mesh, 2)
    with pytest.raises(ValueError, match="sharded over"):
        simulate_visit_sharded(shard_scenes(ens, make_mesh(["cpu"] * 2)),
                               TABLES_T, CFG_T, make_mesh(["cpu"] * 2), 1)
    kw = dict(n_mc=4, chunk_mc=2)
    with pytest.raises(ValueError, match="chunk_mc must be a multiple of "
                                         "mesh mc=4"):
        generate_dataset(_visit_t(4), TABLES_T, CFG_T, str(tmp_path),
                         mesh=mesh, **kw)
    with pytest.raises(ValueError, match="not shardable over the mesh "
                                         "exp=2"):
        generate_dataset(_visit_t(3), TABLES_T, CFG_T, str(tmp_path),
                         mesh=make_mesh(["cpu"] * 2, mc_shards=1), **kw)
    with pytest.raises(ValueError, match="first device"):
        generate_dataset(_visit_t(4), TABLES_T, CFG_T, str(tmp_path),
                         mesh=mesh, device="meta", **kw)
    jmesh = mesh_j.make_mesh(jax.devices()[:1])
    for call in (
            lambda: shard_scenes(ens, jmesh),
            lambda: simulate_ensemble_spectra(ens, TABLES_T, CFG_T, jmesh),
            lambda: simulate_visit_sharded(_visit_t(2), TABLES_T, CFG_T,
                                           jmesh, 1),
            lambda: generate_dataset(_visit_t(4), TABLES_T, CFG_T,
                                     str(tmp_path), mesh=jmesh, **kw),
            lambda: Observation(config_from_dict(GEN_PARS), device="cpu"
                                ).generate(str(tmp_path / "g"), mesh=jmesh)):
        with pytest.raises(TypeError, match="wayne_tpu_torch.parallel."
                                            "make_mesh"):
            call()
    if not torch.cuda.is_available():
        for devices in (["cuda:0"], ["cpu", "cuda"], None):
            with pytest.raises(RuntimeError, match="CUDA"):
                make_mesh(devices)


def test_run_on_mesh_raises_worker_errors_and_keeps_mesh_order():
    """An exception in one worker reaches the caller; with more worker
    threads than cores and a short switch interval, every position's
    result comes back in mesh order and the tables are copied once per
    device (here: not at all, the CPU)."""
    visit = _visit_t(16)

    def fail_at_5(block, tables, device):
        if float(block.exp_start_s[0]) == 5 * 600.0:
            raise RuntimeError("worker 5 failed")
        return float(block.exp_start_s[0])

    mesh = make_mesh(["cpu"] * 16)
    sharded = shard_scenes(visit, mesh, 1)
    with pytest.raises(RuntimeError, match="worker 5 failed"):
        run_on_mesh(fail_at_5, sharded, TABLES_T)
    seen = []
    lock = threading.Lock()

    def record(block, tables, device):
        assert tables is TABLES_T and device == torch.device("cpu")
        total = 0.0
        for _ in range(200):
            total += float(block.exp_start_s.sum())
        with lock:
            seen.append(threading.get_ident())
        return total / 200.0

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = run_on_mesh(record, sharded, TABLES_T)
    finally:
        sys.setswitchinterval(old)
    assert got == [k * 600.0 for k in range(16)]
    assert len(seen) == 16


def test_launch_counts_lose_no_update_across_threads():
    """The kernels' launch counters are raised under a lock: 16 threads x
    500 raises with a short switch interval add up exactly."""
    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            readout._count(wrapper) for _ in range(500)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 500


def test_run_visit_cpu_all_devices(tmp_path, capsys):
    """run_visit --cpu --all-devices: a mesh of the one CPU device, the
    JAX CLI's sharding line, every file written."""
    yml = tmp_path / "pars.yml"
    yml.write_text("observation:\n  subarray: 64\n  NSAMP: 2\n"
                   "  SAMPSEQ: RAPID\n  x_ref: 15.0\n  y_ref: 20.0\n"
                   "  num_orbits: 1\n  exposures_per_orbit: 3\n"
                   "  n_lambda: 16\n  n_sub: 2\n")
    out = tmp_path / "out"
    assert run_visit(["-p", str(yml), "-o", str(out), "--cpu",
                      "--all-devices", "--chunk", "2"]) == 0
    said = capsys.readouterr().out
    assert "sharding exposures over 1 devices\n" in said
    assert "wrote 3 exposures" in said
    assert len(glob.glob(str(out / "*_ima.fits"))) == 3


def test_mesh_is_frozen_and_its_devices_read_only():
    mesh = make_mesh(["cpu"] * 4)
    assert isinstance(mesh, Mesh) and mesh.devices.size == 4
    with pytest.raises(dataclasses.FrozenInstanceError):
        mesh.devices = None
    with pytest.raises(ValueError):
        mesh.devices[0, 0] = torch.device("meta")

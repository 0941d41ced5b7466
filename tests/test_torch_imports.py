"""The port stands alone: importing it (every module) pulls in neither JAX
nor the JAX package, nor triton, and builds no kernel; its subpackages
export the JAX package's names; its entry points run on CUDA by default,
and its smoke run refuses to start without a card or without the
repository."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what each subpackage __init__ of the JAX package exports
# (wayne_tpu/{io,models,ops,parallel,utils}/__init__.py)
JAX_EXPORTS = {
    "io": ["FitsHDU", "read_fits", "write_fits", "write_ima", "read_ima",
           "cr_dq_planes", "saturation_dq", "static_dq_plane",
           "default_primary_header", "DQ_COSMIC_RAY", "DQ_SATURATED",
           "DQ_HOT_PIXEL", "DQ_REF_PIXEL"],
    "models": ["Grism", "G102", "G141", "WFC3IRDetector", "Star", "Planet"],
    "ops": ["eccentric_anomaly", "true_anomaly", "projected_separation",
            "orbital_phase_angle", "claret_intensity", "claret_total_flux",
            "transit_depth_curve", "transit_light_curve",
            "uniform_disk_hidden_frac", "ierf", "pixel_fractions_static",
            "pixel_fractions_moving", "TraceParams", "trace_params",
            "wl_to_x", "x_to_wl", "x_deposit_matrix", "flat_plane"],
    "parallel": ["make_mesh", "shard_scenes", "mc_scenes",
                 "simulate_ensemble_spectra", "extract_spectra"],
    "utils": ["rebin_spectrum", "interp_to_grid", "crop_spectrum",
              "blackbody_flam_um"],
}

_PROBE = """
import importlib, json, pkgutil, sys
import wayne_tpu_torch
names = ['wayne_tpu_torch'] + [m.name for m in pkgutil.walk_packages(
    wayne_tpu_torch.__path__, 'wayne_tpu_torch.')]
for name in names:
    importlib.import_module(name)
exports = json.loads(sys.argv[1])
from wayne_tpu_torch.ops import readout
print(json.dumps({
    'modules': names,
    'jax': sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')),
    'wayne_tpu': sorted(m for m in sys.modules
                        if m == 'wayne_tpu' or m.startswith('wayne_tpu.')),
    'triton': sorted(m for m in sys.modules if m.split('.')[0] == 'triton'),
    'kernels_loaded': readout._lib is not None,
    'missing': {sub: [n for n in want if not hasattr(importlib.import_module(
        'wayne_tpu_torch.' + sub), n)] for sub, want in exports.items()},
}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE,
                          json.dumps(JAX_EXPORTS)], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for expected in ("wayne_tpu_torch.observation", "wayne_tpu_torch.run_visit",
                     "wayne_tpu_torch.ops.readout", "wayne_tpu_torch.convert",
                     "wayne_tpu_torch.reduction", "wayne_tpu_torch.run_dataset",
                     "wayne_tpu_torch.parallel.ensemble",
                     "wayne_tpu_torch.parallel.dataset",
                     "wayne_tpu_torch.parallel.torch_data",
                     "wayne_tpu_torch.parallel.mesh",
                     "wayne_tpu_torch.ops.spots",
                     "wayne_tpu_torch.ops.persistence",
                     "wayne_tpu_torch.ops.recte",
                     "wayne_tpu_torch.program",
                     "wayne_tpu_torch.run_program",
                     "wayne_tpu_torch.calwf3",
                     "wayne_tpu_torch.run_calwf3",
                     "wayne_tpu_torch.run_reduce",
                     "wayne_tpu_torch.etc",
                     "wayne_tpu_torch.diagnostics",
                     "wayne_tpu_torch.utils.cli",
                     "wayne_tpu_torch.mcmc",
                     "wayne_tpu_torch.retrieval",
                     "wayne_tpu_torch.run_retrieve",
                     "wayne_tpu_torch.tools",
                     "wayne_tpu_torch.tools.program_ephemeris",
                     "wayne_tpu_torch.tools.validate_recovery",
                     "wayne_tpu_torch.tools.uncertainty_triangle"):
        assert expected in got["modules"]
    assert got["jax"] == []
    assert got["wayne_tpu"] == []
    assert got["triton"] == [] and got["kernels_loaded"] is False
    assert got["missing"] == {sub: [] for sub in JAX_EXPORTS}


def test_tf32_is_off_after_import():
    import wayne_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from wayne_tpu_torch.config import config_from_dict
    from wayne_tpu_torch.device import resolve_device
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.parallel import make_mesh
    from wayne_tpu_torch.parallel.dataset import generate_dataset
    from wayne_tpu_torch.program import Program
    from wayne_tpu_torch.run_dataset import main as run_dataset
    from wayne_tpu_torch.run_program import main as run_program
    from wayne_tpu_torch.run_visit import main

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    cfg = config_from_dict({"subarray": 64, "NSAMP": 2, "n_lambda": 16})
    with pytest.raises(RuntimeError, match="CUDA"):
        Observation(cfg)
    yml = tmp_path / "pars.yml"
    yml.write_text("observation:\n  subarray: 64\n  NSAMP: 2\n"
                   "  n_lambda: 16\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-p", str(yml), "-o", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-p", str(yml), "-o", str(tmp_path / "out"), "--all-devices"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dataset(["-p", str(yml), "-o", str(tmp_path / "ds"),
                     "--n-mc", "2", "--chunk-mc", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_dataset(None, None, None, str(tmp_path / "ds"), n_mc=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Program(cfg)
    from wayne_tpu_torch.run_calwf3 import main as run_calwf3
    with pytest.raises(RuntimeError, match="CUDA"):
        run_calwf3(["-d", str(tmp_path), "-p", str(yml)])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_program(["-p", str(yml), "-o", str(tmp_path / "prog")])
    from wayne_tpu_torch.etc import main as etc, predict
    from wayne_tpu_torch.run_reduce import extract_from_files
    from wayne_tpu_torch.run_reduce import main as run_reduce
    with pytest.raises(RuntimeError, match="CUDA"):
        run_reduce(["-d", str(tmp_path), "-p", str(yml)])
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_from_files([], 2.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        etc(["-p", str(yml)])
    with pytest.raises(RuntimeError, match="CUDA"):
        predict(cfg)
    from wayne_tpu_torch.run_retrieve import main as run_retrieve
    from wayne_tpu_torch.run_retrieve import raw_column_sums
    with pytest.raises(RuntimeError, match="CUDA"):
        run_retrieve(["-d", str(tmp_path), "-p", str(yml)])
    with pytest.raises(RuntimeError, match="CUDA"):
        raw_column_sums([], "ramp", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_retrieve(["-d", str(tmp_path), "-p", str(yml), "--program"])
    from wayne_tpu_torch.compat import ExposureGenerator, run
    with pytest.raises(RuntimeError, match="CUDA"):
        ExposureGenerator(subarray=64, n_lambda=16, nsamp=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(str(yml), outdir=str(tmp_path / "compat"))
    from wayne_tpu_torch.tools import program_ephemeris as pe
    from wayne_tpu_torch.tools import uncertainty_triangle as ut
    from wayne_tpu_torch.tools import validate_recovery as vr
    with pytest.raises(RuntimeError, match="CUDA"):
        vr.main(["--sections", "main", "--n-mc", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        vr.run_sections(["retrieval_mode"], out=str(tmp_path / "v.json"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ut.main(["--n-mc", "2"])
    prog = tmp_path / "prog"
    (prog / "visit_00").mkdir(parents=True)
    (prog / "program_summary.json").write_text(json.dumps(
        {"visits": [{"dir": "visit_00"}]}))
    with pytest.raises(RuntimeError, match="CUDA"):
        pe.main(["-d", str(prog), "-p", str(yml)])
    assert not (tmp_path / "v.json").exists()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result on a machine
    without CUDA, and when it stands alone without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for script in (os.path.join(REPO, "chip_smoke.py"), str(alone)):
        proc = subprocess.run([sys.executable, script], cwd=tmp_path,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, script
        assert '"ok"' not in proc.stdout, script

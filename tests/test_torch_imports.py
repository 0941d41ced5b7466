"""The port stands alone: importing it (every module) pulls in neither JAX
nor the JAX package, its entry points run on CUDA by default, and its
smoke run refuses to start without a card or without the repository."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import wayne_tpu_torch
names = ['wayne_tpu_torch'] + [m.name for m in pkgutil.walk_packages(
    wayne_tpu_torch.__path__, 'wayne_tpu_torch.')]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    'modules': names,
    'jax': sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')),
    'wayne_tpu': sorted(m for m in sys.modules
                        if m == 'wayne_tpu' or m.startswith('wayne_tpu.')),
}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for expected in ("wayne_tpu_torch.observation", "wayne_tpu_torch.run_visit",
                     "wayne_tpu_torch.ops.readout", "wayne_tpu_torch.convert"):
        assert expected in got["modules"]
    assert got["jax"] == []
    assert got["wayne_tpu"] == []


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

"""Tests of the port that need a CUDA card (marker ``cuda``); they skip on
a machine without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed (the repo's conftest imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import os

import numpy as np
import pytest
import torch

from wayne_tpu_torch.config import config_from_dict
from wayne_tpu_torch.io.ima import read_ima
from wayne_tpu_torch.observation import Observation
from wayne_tpu_torch.ops.readout import exposure_readout, exposure_readout_plain

torch.set_num_threads(1)

TINY = {"grism": "G141", "subarray": 128, "NSAMP": 4, "SAMPSEQ": "SPARS10",
        "scan": True, "x_ref": 30.0, "y_ref": 40.0, "num_orbits": 1,
        "exposures_per_orbit": 5, "n_lambda": 64, "n_sub": 4}
DETERMINISTIC = {"preset": "all", "poisson": False, "read_noise": False,
                 "cosmic_rays": False, "bias_drift": False}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_cuda.py --noconftest -m cuda)")
    return torch.device("cuda")


def _readout_inputs(dev, B=3, NR=5, W=32, S=128, n_cr=6):
    g = torch.Generator().manual_seed(3)
    r = lambda *shape: torch.rand(shape, generator=g)
    dts = torch.full((B, NR), 2.9)
    dts[:, 0] = 0.0
    bands = 800.0 * r(B, NR, W, S)
    bands[:, 0] = 0.0
    y0s = torch.tensor([0, 8, 48, 96, 88], dtype=torch.int32).expand(B, NR)
    bg = 3.0 * r(B, S, S)
    bg[:, :, :4] = 0.0
    cr_pos = torch.randint(0, S, (B, NR, 2, n_cr), generator=g,
                           dtype=torch.int32)
    cr_pos[:, 2, :, :2] = torch.tensor([[10, 10], [31, 31]], dtype=torch.int32)
    cr_q = 1000.0 * r(B, NR, n_cr)
    cr_q[:, 0] = 0.0
    args = (torch.tensor([[3, 7], [-1, 9], [5, -5]], dtype=torch.int32)[:B],
            y0s.contiguous(), dts, bands, bg,
            1000.0 + r(S, S), 1.0 / (2.5 + 0.02 * r(S, S)),
            torch.tensor([0.012, 0.012, 0.016])[:, None, None]
            * (1 + 0.03 * r(3, S, S)), cr_pos, cr_q)
    consts = (20.0, 78000.0, 2.5, 0.015)          # host scalars
    return tuple(a.to(dev).contiguous() for a in args) + (consts,)


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("ipc", [False, True])
def test_kernel_matches_plain(card, noise, ipc):
    """Kernel = plain version on the same card (the same Philox draws)."""
    args = _readout_inputs(card)
    kw = dict(poisson=noise, read_noise=noise, ipc=ipc)
    got, cum = exposure_readout(*args, **kw)
    want, cum_w = exposure_readout_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(cum, cum_w, rtol=1e-5, atol=0)
    assert exposure_readout(*args, **kw)[0].equal(got)     # reproducible


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(card):
    args = list(_readout_inputs(card))
    args[4] = args[4].cpu()                                  # bg on the CPU
    with pytest.raises(ValueError, match="bg_rate"):
        exposure_readout(*args)
    args = list(_readout_inputs(card))
    args[1] = args[1].to(torch.int64)                        # y0s dtype
    with pytest.raises(TypeError, match="y0s"):
        exposure_readout(*args)


@pytest.mark.cuda
def test_generate_on_the_card_matches_cpu(card, tmp_path):
    """A tiny visit on the card (readout kernel, pinned async host copies,
    on-device uint16 quantization) and on the CPU (plain version): the
    deterministic effects agree to the tolerance of
    tests/test_torch_observation.py; with the noise on, the integer DN
    agree except where the two devices' float32 transcendentals round a
    Poisson draw differently."""
    for noise, exact in ((DETERMINISTIC, True), ({"preset": "all"}, False)):
        params = dict(TINY, noise=noise, quantize_adc=not exact)
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = str(tmp_path / f"{dev}{exact}")
            Observation(config_from_dict(params), device=dev).generate(
                outs[dev], chunk=4, progress=lambda s: None)
        names = sorted(os.listdir(outs["cpu"]))
        assert names == sorted(os.listdir(outs["cuda"])) and len(names) == 6
        for name in names:
            hc, rc, _ = read_ima(os.path.join(outs["cuda"], name))
            hp, rp, _ = read_ima(os.path.join(outs["cpu"], name))
            assert hc == hp, name
            if exact:
                np.testing.assert_allclose(
                    rc, rp, rtol=2e-5, atol=max(1e-3, 5e-6 * float(rp.max())))
            else:   # spectra are quantized; the direct image is not
                if name.endswith("_ima.fits"):
                    assert np.array_equal(rc, np.round(rc)), name
                assert float(np.isclose(rc, rp, rtol=0, atol=1e-3).mean()
                             ) > 0.99, name

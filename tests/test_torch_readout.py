"""The port's whole-exposure readout against the JAX package's Pallas kernel.

The plain PyTorch version (what a CPU tensor runs) is held against
``wayne_tpu.ops.pallas_readout.fused_exposure_readout`` in TPU interpret
mode on identical inputs with the noise off, and by the Poisson law with
the noise on (random bits are never compared across packages). The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wayne_tpu.ops.pallas_readout import fused_exposure_readout
from wayne_tpu_torch.ops.readout import exposure_readout, exposure_readout_plain

torch.set_num_threads(1)

S, W, NR, NCR = 128, 32, 4, 6


def _inputs():
    """Noise-free-comparable inputs: nonlin, bias, a per-pixel gain, CR
    hits at tile-seam-like columns and band rows across the frame."""
    rng = np.random.RandomState(11)
    bands = rng.uniform(0, 800, (NR, W, S)).astype(np.float32)
    bands[0] = 0.0
    y0s = np.asarray([0, 8, 48, S - W], np.int32)
    dts = np.asarray([0.0, 2.9, 2.9, 2.9], np.float32)
    bg = rng.uniform(0, 3.0, (S, S)).astype(np.float32)
    bias = (1000.0 + rng.standard_normal((S, S))).astype(np.float32)
    gain = (2.5 * (1 + 0.01 * rng.standard_normal((S, S)))).astype(np.float32)
    nl = (np.asarray([0.012, 0.012, 0.016])[:, None, None]
          * (1 + 0.03 * rng.standard_normal((3, S, S)))).astype(np.float32)
    cr_pos = np.zeros((NR, 2, NCR), np.int32)
    cr_q = np.zeros((NR, NCR), np.float32)
    # hits hugging 32- and 64-column seams, a frame corner, and two hits
    # on one pixel in one read
    cr_pos[2] = [[10, 20, 30, 40, 127, 10], [31, 32, 63, 64, 127, 31]]
    cr_q[2] = [1e3, 2e3, 3e3, 4e3, 5e3, 6e3]
    cr_pos[3] = [[0, 1, 0, 0, 0, 0], [0, 127, 0, 0, 0, 0]]
    cr_q[3] = [7e3, 8e3, 0, 0, 0, 0]
    consts = np.asarray([20.0, 78000.0, 2.5, 0.015], np.float32)
    return bands, y0s, dts, bg, bias, gain, nl, cr_pos, cr_q, consts


@pytest.mark.parametrize("ipc", [False, True])
def test_plain_matches_pallas_interpret_noise_off(ipc):
    bands, y0s, dts, bg, bias, gain, nl, cr_pos, cr_q, consts = _inputs()
    kw = dict(poisson=False, read_noise=False, non_linearity=True,
              bias=True, scalar_gain=False, with_cr=True, ipc=ipc)
    with pltpu.force_tpu_interpret_mode():
        dn_j, cum_j = fused_exposure_readout(
            jnp.array([3, 0, 7], jnp.int32), jnp.asarray(y0s),
            jnp.asarray(dts), jnp.asarray(bands), jnp.zeros((S, S)),
            jnp.asarray(bg), jnp.asarray(bias), jnp.asarray(1.0 / gain),
            jnp.asarray(nl), jnp.asarray(cr_pos), jnp.asarray(cr_q),
            jnp.asarray(consts), col_tiles=1, **kw)
    t = torch.as_tensor
    dn_t, cum_t = exposure_readout(
        t([[3, 7]], dtype=torch.int32), t(y0s)[None], t(dts)[None],
        t(bands)[None], t(bg)[None], t(bias), t(1.0 / gain), t(nl),
        t(cr_pos)[None], t(cr_q)[None], t(consts), **kw)
    np.testing.assert_allclose(cum_t[0].numpy(), np.asarray(cum_j),
                               rtol=1e-5)
    np.testing.assert_allclose(dn_t[0].numpy(), np.asarray(dn_j), rtol=1e-5)
    # every CR charge landed exactly once (two hits share pixel (10, 31))
    dep = cum_t[0].numpy() - bg * dts.sum()
    hits = {(10, 31): 7e3, (20, 32): 2e3, (30, 63): 3e3, (40, 64): 4e3,
            (127, 127): 5e3, (0, 0): 7e3, (1, 127): 8e3}
    for (y, x), q in hits.items():
        band_sum = sum(float(bands[k, y - y0s[k], x]) for k in range(NR)
                       if 0 <= y - y0s[k] < W)
        np.testing.assert_allclose(dep[y, x], band_sum + q, rtol=1e-5)


def _regime_run(flags, bg, bands, consts, B=8, nr=16, w=W):
    """B exposures of nr reads, dt = 1 s, unit gain, no bias: the read
    increments are the per-read Poisson samples (plus read noise)."""
    s = bg.shape[-1]
    t32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    dts = torch.ones((B, nr))
    dts[:, 0] = 0.0
    return exposure_readout_plain(
        torch.arange(2 * B, dtype=torch.int32).view(B, 2) + 5, t32(B, nr),
        dts, bands, bg.expand(B, s, s).contiguous(),
        torch.zeros((s, s)), torch.ones((s, s)), torch.zeros((3, s, s)),
        t32(B, nr, 2, 4), torch.zeros((B, nr, 4)), consts,
        non_linearity=False, bias=False, scalar_gain=False, with_cr=False,
        bg_poisson=True, **flags)[0]


def test_plain_poisson_regimes_and_read_noise():
    """The three-regime sampler's law per regime (bars of
    tests/test_pallas.py's hardware test), the band's exact branch, and
    the read-noise sigma."""
    B, nr, q = 8, 16, S // 4
    bg = torch.zeros((S, S))
    for j, lam in enumerate((0.0, 0.5, 12.0, 500.0)):
        bg[:, j * q:(j + 1) * q] = lam
    bands = torch.full((B, nr, W, S), 2.0)
    bands[:, 0] = 0.0
    reads = _regime_run(dict(poisson=True, read_noise=False), bg, bands,
                        torch.tensor([0.0, 78000.0, 1.0, 0.0]))
    inc = torch.diff(reads, dim=1).double()
    body = inc[:, :, W:]
    cls = [body[..., j * q:(j + 1) * q] for j in range(4)]
    assert bool((cls[0] == 0).all())                  # Poisson(0) = 0 exactly
    assert bool((cls[1] == torch.round(cls[1])).all()) and cls[1].min() == 0
    for lam, c, dm, dv in ((0.5, cls[1], 0.01, 0.01),
                           (12.0, cls[2], 0.05, 0.25),
                           (500.0, cls[3], 0.5, 5.0)):
        assert abs(float(c.mean()) - lam) < dm, (lam, float(c.mean()))
        assert abs(float(c.var()) - lam) < dv, (lam, float(c.var()))
    band = inc[:, :, :W, :q]                          # bg = 0 there
    assert abs(float(band.mean()) - 2.0) < 0.01
    assert abs(float(band.var()) - 2.0) < 0.02

    reads = _regime_run(dict(poisson=False, read_noise=True),
                        torch.zeros((S, S)), torch.zeros((B, nr, W, S)),
                        torch.tensor([20.0, 78000.0, 1.0, 0.0]))
    assert abs(float(reads.double().std()) - 20.0) < 0.5
    assert abs(float(reads.double().mean())) < 0.1


def test_plain_draws_are_reproducible_and_batch_independent():
    """Same seed words -> bit-identical reads; an exposure's draws do not
    depend on the other exposures of its batch."""
    bg = torch.full((S, S), 0.7)
    bands = torch.full((2, 3, W, S), 40.0)
    flags = dict(poisson=True, read_noise=True)
    c = torch.tensor([20.0, 78000.0, 1.0, 0.0])
    a = _regime_run(flags, bg, bands, c, B=2, nr=3)
    b = _regime_run(flags, bg, bands, c, B=2, nr=3)
    one = _regime_run(flags, bg, bands[:1], c, B=1, nr=3)
    assert torch.equal(a, b)
    assert torch.equal(a[:1], one)



def test_consts_are_host_scalars():
    """The four scalars come from the host (a sequence or a CPU tensor);
    a tensor on another device is refused rather than read back."""
    bands, y0s, dts, bg, bias, gain, nl, cr_pos, cr_q, consts = _inputs()
    t = torch.as_tensor
    args = (t([[3, 7]], dtype=torch.int32), t(y0s)[None], t(dts)[None],
            t(bands)[None], t(bg)[None], t(bias), t(1.0 / gain), t(nl),
            t(cr_pos)[None], t(cr_q)[None])
    a, _ = exposure_readout(*args, tuple(consts.tolist()))
    b, _ = exposure_readout(*args, t(consts))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="host scalars"):
        exposure_readout(*args, t(consts).to("meta"))

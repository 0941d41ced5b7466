"""The port's per-read readout steps against the JAX package's Pallas kernels.

The plain PyTorch versions (what a CPU tensor runs) of the banded step
(``read_step_banded``) and the full-frame step (``read_step``) are held
against ``fused_read_step_banded`` and ``fused_read_step`` of
``wayne_tpu.ops.pallas_readout`` in TPU interpret mode on identical inputs
with the noise off, and by the Poisson and read-noise laws with the noise
on (random bits are never compared across packages). The CUDA kernels are
held against the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wayne_tpu.ops.pallas_readout import fused_read_step, fused_read_step_banded
from wayne_tpu_torch.ops import readout as ro
from wayne_tpu_torch.ops.readout import (
    add_hits, exposure_readout_plain, read_step, read_step_banded,
    read_step_banded_plain, read_step_plain, sample_band,
)

torch.set_num_threads(1)

S, W, NCR = 128, 32, 8
CONSTS = np.asarray([20.0, 78000.0, 2.5, 0.015], np.float32)
SEEDS = np.asarray([[3, 7], [-1, 9]], np.int32)
READ = 5


def _planes(rng):
    bias = (1000.0 + rng.standard_normal((S, S))).astype(np.float32)
    gain = (2.5 * (1 + 0.01 * rng.standard_normal((S, S)))).astype(np.float32)
    nl = (np.asarray([0.012, 0.012, 0.016])[:, None, None]
          * (1 + 0.03 * rng.standard_normal((3, S, S)))).astype(np.float32)
    return bias, (1.0 / gain).astype(np.float32), nl


def _banded_inputs():
    """Two exposures: charge near full well in places, unaligned band rows
    that differ per exposure, CR hits on the kernel's tile seams (columns
    29/30, 31/32, 59/60, 63/64; rows 5/6, 7/8), a frame corner and one
    pixel hit twice, and zero charges beyond the hit count."""
    rng = np.random.RandomState(5)
    cum = rng.uniform(0, 7e4, (2, S, S)).astype(np.float32)
    band = rng.uniform(0, 800, (2, W, S)).astype(np.float32)
    bg = rng.uniform(0, 20, (2, S, S)).astype(np.float32)
    y0 = np.asarray([41, 93], np.int32)
    dt = np.asarray([2.9, 5.0], np.float32)
    cr_pos = np.zeros((2, 2, NCR), np.int32)
    cr_q = np.zeros((2, NCR), np.float32)
    cr_pos[0] = [[10, 5, 6, 7, 8, 10, 0, 0], [31, 29, 30, 63, 64, 31, 0, 0]]
    cr_q[0] = [1e3, 2e3, 3e3, 4e3, 5e3, 6e3, 7e3, 0.0]
    cr_pos[1] = [[127, 0, 50, 60, 0, 0, 0, 0], [127, 127, 32, 59, 0, 0, 0, 0]]
    cr_q[1] = [8e3, 9e3, 1.5e3, 2.5e3, 0, 0, 0, 0]
    return cum, band, bg, y0, dt, cr_pos, cr_q


@pytest.mark.parametrize("scalar_gain", [False, True])
@pytest.mark.parametrize("ipc", [False, True])
def test_banded_plain_matches_pallas_interpret_noise_off(ipc, scalar_gain):
    cum, band, bg, y0, dt, cr_pos, cr_q = _banded_inputs()
    bias, inv_gain, nl = _planes(np.random.RandomState(6))
    kw = dict(poisson=False, read_noise=False, non_linearity=True,
              bias=True, scalar_gain=scalar_gain, with_cr=True, ipc=ipc)
    want = []
    with pltpu.force_tpu_interpret_mode():
        for b in range(2):
            want.append(fused_read_step_banded(
                jnp.array([SEEDS[b, 0], READ, SEEDS[b, 1]], jnp.int32),
                jnp.array([y0[b]], jnp.int32), jnp.asarray(cum[b]),
                jnp.asarray(band[b]), jnp.asarray(bg[b] * dt[b]),
                jnp.asarray(bias), jnp.asarray(inv_gain), jnp.asarray(nl),
                jnp.asarray(cr_pos[b]), jnp.asarray(cr_q[b]),
                jnp.asarray(CONSTS), **kw))
    t = torch.as_tensor
    cum_t, dn_t = read_step_banded(
        t(SEEDS), READ, t(y0), t(dt), t(cum), t(band), t(bg), t(bias),
        t(inv_gain), t(nl), t(cr_pos), t(cr_q), tuple(CONSTS.tolist()), **kw)
    for b, (cum_j, dn_j) in enumerate(want):
        np.testing.assert_allclose(cum_t[b].numpy(), np.asarray(cum_j),
                                   rtol=1e-5)
        np.testing.assert_allclose(dn_t[b].numpy(), np.asarray(dn_j),
                                   rtol=1e-5)
    # every charge landed exactly once, the twice-hit pixel (10, 31) twice
    lam = bg * dt[:, None, None]                      # float32, as the step
    dep = cum_t.double().numpy() - cum - lam.astype(np.float64)
    for b in range(2):
        dep[b, y0[b]:y0[b] + W] -= band[b]
    hits = {(0, 10, 31): 7e3, (0, 5, 29): 2e3, (0, 6, 30): 3e3,
            (0, 7, 63): 4e3, (0, 8, 64): 5e3, (0, 0, 0): 7e3,
            (1, 127, 127): 8e3, (1, 0, 127): 9e3, (1, 50, 32): 1.5e3,
            (1, 60, 59): 2.5e3}
    for (b, y, x), q in hits.items():
        np.testing.assert_allclose(dep[b, y, x], q, rtol=1e-3, atol=0.1)
        dep[b, y, x] = 0.0
    np.testing.assert_allclose(dep, 0.0, atol=0.02)


@pytest.mark.parametrize("scalar_gain", [False, True])
@pytest.mark.parametrize("bg_poisson", [True, False])
def test_full_frame_plain_matches_pallas_interpret_noise_off(bg_poisson,
                                                             scalar_gain):
    rng = np.random.RandomState(8)
    cum = rng.uniform(0, 7e4, (2, S, S)).astype(np.float32)
    add = rng.uniform(0, 1e3, (2, S, S)).astype(np.float32)
    bg = rng.uniform(0, 20, (2, S, S)).astype(np.float32)
    dt = np.asarray([2.9, 5.0], np.float32)
    bias, inv_gain, nl = _planes(rng)
    kw = dict(poisson=False, read_noise=False, non_linearity=True,
              bias=True, scalar_gain=scalar_gain, bg_poisson=bg_poisson)
    t = torch.as_tensor
    cum_t, dn_t = read_step(t(SEEDS), READ, t(dt), t(cum), t(add), t(bg),
                            t(bias), t(inv_gain), t(nl),
                            tuple(CONSTS.tolist()), **kw)
    with pltpu.force_tpu_interpret_mode():
        for b in range(2):
            cum_j, dn_j = fused_read_step(
                jnp.array([SEEDS[b, 0], READ, SEEDS[b, 1]], jnp.int32),
                jnp.asarray(cum[b]), jnp.asarray(add[b]),
                jnp.asarray(bg[b] * dt[b]), jnp.asarray(bias),
                jnp.asarray(inv_gain), jnp.asarray(nl),
                jnp.asarray(CONSTS[:3]), tile=64, **kw)
            np.testing.assert_allclose(cum_t[b].numpy(), np.asarray(cum_j),
                                       rtol=1e-5)
            np.testing.assert_allclose(dn_t[b].numpy(), np.asarray(dn_j),
                                       rtol=1e-5)


@pytest.mark.parametrize("ipc", [False, True])
@pytest.mark.parametrize("poisson", [False, True])
def test_banded_wrapper_draws_the_expected_band(poisson, ipc):
    """The banded step takes the EXPECTED band: on CPU tensors, with the
    noise on it is ``sample_band`` then ``read_step_banded_plain`` bit for
    bit, with the noise off the band is added as given; and reads 0 and 1
    through it are the whole-exposure readout's two reads, bit for bit."""
    cum, band, bg, y0, dt, cr_pos, cr_q = (torch.as_tensor(a)
                                           for a in _banded_inputs())
    bias, inv_gain, nl = (torch.as_tensor(a)
                          for a in _planes(np.random.RandomState(6)))
    seed = torch.as_tensor(SEEDS)
    consts = tuple(CONSTS.tolist())
    flags = dict(poisson=poisson, read_noise=poisson, ipc=ipc)
    planes = dict(bg_rate=bg, bias_map=bias, inv_gain=inv_gain,
                  nl_coeffs=nl, consts=consts)
    step = dict(planes, seed=seed, y0=y0, cr_pos=cr_pos, cr_q=cr_q, **flags)
    got = read_step_banded(read=READ, dt=dt, cum=cum, band=band, **step)
    drawn = sample_band(seed, READ, y0, band) if poisson else band
    assert poisson != torch.equal(drawn, band)
    want = read_step_banded_plain(read=READ, dt=dt, cum=cum, band=drawn,
                                  **step)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    # reads 0 (zero entries) and 1 from zero charge, against the
    # whole-exposure readout
    pair = lambda a: torch.stack([torch.zeros_like(a), a], 1).contiguous()
    reads, cum_w = exposure_readout_plain(
        seed, torch.stack([y0, y0], 1), pair(dt), pair(band), bg, bias,
        inv_gain, nl, pair(cr_pos), pair(cr_q), consts, **flags)
    c = torch.zeros_like(cum)
    for k in range(2):
        c, dn = read_step_banded(
            read=k, dt=pair(dt)[:, k].contiguous(), cum=c,
            band=pair(band)[:, k].contiguous(),
            **dict(step, cr_pos=pair(cr_pos)[:, k].contiguous(),
                   cr_q=pair(cr_q)[:, k].contiguous()))
        assert torch.equal(dn, reads[:, k])
    assert torch.equal(c, cum_w)


def _law_run(step, bg, rn, reads=4, B=16):
    """``reads`` reads of B exposures from zero charge, dt = 1 s, unit
    gain, no bias, no non-linearity: each read's charge increment is a
    Poisson sample of bg, and dn - cum is the read noise."""
    s = bg.shape[-1]
    seed = torch.arange(2 * B, dtype=torch.int32).view(B, 2) + 11
    dt = torch.ones(B)
    common = dict(bias_map=torch.zeros((s, s)), inv_gain=torch.ones((s, s)),
                  nl_coeffs=torch.zeros((3, s, s)),
                  consts=(rn, 78000.0, 1.0, 0.0), poisson=True,
                  read_noise=rn > 0, non_linearity=False, bias=False,
                  scalar_gain=False, bg_poisson=True)
    cum = torch.zeros((B, s, s))
    incs, noise = [], []
    for k in range(1, reads + 1):
        if step == "banded":
            new, dn = read_step_banded_plain(
                seed, k, torch.zeros(B, dtype=torch.int32), dt, cum,
                torch.zeros((B, W, s)), bg.expand(B, s, s), with_cr=False,
                cr_pos=torch.zeros((B, 2, 4), dtype=torch.int32),
                cr_q=torch.zeros((B, 4)), **common)
        else:
            new, dn = read_step_plain(seed, k, dt, cum,
                                      torch.zeros((B, s, s)),
                                      bg.expand(B, s, s), **common)
        incs.append(new - cum)
        noise.append(dn - new)
        cum = new
    return torch.stack(incs).double(), torch.stack(noise).double()


@pytest.mark.parametrize("step", ["banded", "full_frame"])
def test_plain_poisson_and_read_noise_laws(step):
    """The background sampler's law per regime (the bars of
    tests/test_torch_readout.py) and the read-noise sigma."""
    q = S // 4
    bg = torch.zeros((S, S))
    for j, lam in enumerate((0.0, 0.5, 12.0, 500.0)):
        bg[:, j * q:(j + 1) * q] = lam
    inc, _ = _law_run(step, bg, 0.0)
    cls = [inc[..., j * q:(j + 1) * q] for j in range(4)]
    assert bool((cls[0] == 0).all())                  # Poisson(0) = 0 exactly
    assert bool((cls[1] == torch.round(cls[1])).all()) and cls[1].min() == 0
    for lam, c, dm, dv in ((0.5, cls[1], 0.01, 0.01),
                           (12.0, cls[2], 0.05, 0.25),
                           (500.0, cls[3], 0.5, 5.0)):
        assert abs(float(c.mean()) - lam) < dm, (lam, float(c.mean()))
        assert abs(float(c.var()) - lam) < dv, (lam, float(c.var()))
    _, noise = _law_run(step, torch.zeros((S, S)), 20.0)
    assert abs(float(noise.std()) - 20.0) < 0.5
    assert abs(float(noise.mean())) < 0.1


def test_add_hits_adds_in_list_order():
    """One scatter per rank adds the hits of one pixel in list order, as
    a sequential loop over the list does, bit for bit."""
    rng = np.random.RandomState(2)
    frame = torch.as_tensor(rng.uniform(0, 1e4, (2, 16, 16)).astype(np.float32))
    pos = torch.as_tensor(rng.randint(0, 4, (2, 2, 40)).astype(np.int32))
    q = torch.as_tensor(rng.uniform(0, 3e3, (2, 40)).astype(np.float32))
    q[:, 30:] = 0.0
    want = frame.clone()
    for b in range(2):
        for i in range(40):
            want[b, pos[b, 0, i], pos[b, 1, i]] += q[b, i]
    assert torch.equal(add_hits(frame, pos, q), want)


def test_library_name_hashes_every_compiled_file(tmp_path, monkeypatch):
    """The built library's name hashes every file nvcc reads, the shared
    header included, so an edit never loads a stale build."""
    assert sorted(os.listdir(ro._CSRC)) == sorted(ro.SOURCES + ro.HEADERS)
    csrc = tmp_path / "csrc"
    shutil.copytree(ro._CSRC, csrc)
    monkeypatch.setattr(ro, "_CSRC", str(csrc))
    first = ro.library_path()
    for name in ro.SOURCES + ro.HEADERS:
        text = (csrc / name).read_text()
        (csrc / name).write_text(text + "\n// edited\n")
        assert ro.library_path() != first, name
        (csrc / name).write_text(text)
    assert ro.library_path() == first

"""The port's forward-model retrieval (wayne_tpu_torch.retrieval) against
the JAX package's (wayne_tpu.retrieval), in process, on identical tables
and scenes (carried across with wayne_tpu_torch.convert): a 64^2 scan
visit of 12 exposures, NSAMP 3, 64 wavelength bins, every deterministic
detector effect on (flat, sky, dark, non-linearity, IPC, bias, gain map,
SSV, visit trend), four channels over columns 2-62.

Also the readout's autograd Function (ops.readout.exposure_readout) against
autograd of its own plain version, and the Jacobian in the configuration
where the JAX package's is degenerate (every fitted channel at the rp
vector's minimum) against central finite differences.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wayne_tpu.retrieval as ret_j
import wayne_tpu_torch.retrieval as ret_t
from wayne_tpu.calibration import synthetic_tables
from wayne_tpu.config import ExposureStatic, NoiseFlags
from wayne_tpu.ops.kepler import OrbitParams
from wayne_tpu.ops.spots import SpotParams
from wayne_tpu.ops.visit import simulate_visit
from wayne_tpu.reduction import _channel_edges, out_of_transit_mask
from wayne_tpu.scene import example_scene
from wayne_tpu_torch import config as config_t
from wayne_tpu_torch.convert import (
    numpy_leaves, scenes_from_numpy, tables_from_numpy,
)
from wayne_tpu_torch.ops import readout as ro

torch.set_num_threads(1)

S, NL, NSAMP, N_EXP, N_CHAN = 64, 64, 3, 12, 4
X_WINDOW = (2, 62)
DETERMINISTIC = dataclasses.replace(NoiseFlags.all(), poisson=False,
                                    read_noise=False, cosmic_rays=False,
                                    bias_drift=False)


def _static_t(cfg_j: ExposureStatic) -> config_t.ExposureStatic:
    kw = dataclasses.asdict(cfg_j)
    kw["noise"] = config_t.NoiseFlags(**kw["noise"])
    return config_t.ExposureStatic(**kw)


@dataclasses.dataclass
class Visit:
    cfg: ExposureStatic
    tables: object
    scenes: object
    truth: np.ndarray         # (NL,) the injected depth spectrum

    @property
    def port(self):
        return (_static_t(self.cfg),
                tables_from_numpy(numpy_leaves(self.tables), "cpu"),
                scenes_from_numpy(numpy_leaves(self.scenes), "cpu"))


def _visit(variant: str = "transit", seed: int = 0) -> Visit:
    """The test visit: "transit"; "flat" (the same with the flat spectrum
    0.1595, as the headline YAML injects); "eclipse" (the secondary eclipse
    at the 2 h mark, planet light on); "nuisances" (forward/reverse
    alternating scans and two starspots)."""
    eclipse = variant == "eclipse"
    cfg = ExposureStatic(subarray=S, n_lambda=NL, n_sub=2, nsamp=NSAMP,
                         samp_seq="SPARS10", scan=True, noise=DETERMINISTIC,
                         band_px=32, eclipse=eclipse)
    tables = synthetic_tables("G141", subarray=S, n_lambda=NL,
                              samp_seq="SPARS10", nsamp=NSAMP)
    wl = np.asarray(tables.wl_centers)
    rp = (0.1595 + (variant != "flat") * 0.004 * np.sin(9.0 * wl)
          ).astype(np.float32)
    fp = (1.5e-3 + 4e-4 * np.sin(7.0 * wl)).astype(np.float32)
    base = dataclasses.replace(
        example_scene(NL, scan_speed=0.6), x_ref=jnp.float32(-90.0),
        y_ref=jnp.float32(12.0), rp_over_rs=jnp.asarray(rp),
        fp_over_fs=jnp.asarray(fp))
    if eclipse:
        per = 0.813475 * 86400.0
        base = dataclasses.replace(base, orbit=OrbitParams.create(
            period_s=per, t0_s=2.0 * 3600.0 - per / 2.0, sma_rs=4.855,
            inc_rad=np.deg2rad(82.1)))
    scenes = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N_EXP,) + x.shape), base)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(seed), i))(jnp.arange(N_EXP))
    scenes = dataclasses.replace(
        scenes, key=keys, exp_start_s=jnp.asarray(
            np.linspace(0.0, 4.0 * 3600.0, N_EXP), jnp.float32))
    if variant == "nuisances":
        rev = np.arange(N_EXP) % 2 == 1
        exptime = float(tables.read_times[-1])
        rng = np.random.RandomState(8)
        spots = SpotParams.create(
            np.deg2rad([41.8, -20.0]), np.deg2rad([-1.0, -35.0]),
            [0.10, 0.06], rng.uniform(0.5, 0.9, (2, NL)),
            2.0 * np.pi / (15.6 * 86400.0))
        scenes = dataclasses.replace(
            scenes,
            scan_speed=jnp.asarray(np.where(rev, -0.6, 0.6), jnp.float32),
            y_ref=jnp.asarray(np.where(rev, 12.0 + 0.6 * exptime, 12.0),
                              jnp.float32),
            spots=jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x[None], (N_EXP,) + x.shape),
                spots))
    return Visit(cfg, tables, scenes, fp if eclipse else rp)


def _observe(v: Visit, chunk: int = 6, noise_seed: int | None = None
             ) -> np.ndarray:
    """The JAX package's noise-free CDS column sums; with ``noise_seed``
    each column sum scattered by 2e-4 of itself (a channel's curve then
    scatters by ~5e-5, which sets the reported sigmas)."""
    out = simulate_visit(v.scenes, v.tables, v.cfg, chunk=chunk)
    obs = np.asarray((out.reads_dn[:, -1] - out.reads_dn[:, 0]).sum(axis=1))
    if noise_seed is not None:
        rng = np.random.default_rng(noise_seed)
        obs = (obs * (1.0 + 2e-4 * rng.standard_normal(obs.shape))
               ).astype(np.float32)
    return obs


# ---------------------------------------------------------------------------
# The readout's autograd Function
# ---------------------------------------------------------------------------

def _readout_inputs(rng, B=2, NR=4, W=5, S_=12):
    t = torch.as_tensor
    dts = rng.uniform(0.5, 3.0, (B, NR)).astype(np.float32)
    dts[:, 0] = 0.0
    bands = rng.uniform(0.0, 4e4, (B, NR, W, S_)).astype(np.float32)
    bands[:, 0] = 0.0
    return dict(
        seed=t(rng.integers(0, 2**31, (B, 2)), dtype=torch.int32),
        y0s=t(rng.integers(0, S_ - W, (B, NR)), dtype=torch.int32),
        dts=t(dts), bands=t(bands),
        bg_rate=t(rng.uniform(0.0, 50.0, (B, S_, S_)).astype(np.float32)),
        bias_map=t(rng.uniform(0.0, 100.0, (S_, S_)).astype(np.float32)),
        inv_gain=t(rng.uniform(0.3, 0.5, (S_, S_)).astype(np.float32)),
        nl_coeffs=t(np.stack([rng.uniform(0.01, 0.05, (S_, S_)),
                              rng.uniform(0.0, 0.02, (S_, S_)),
                              rng.uniform(0.0, 0.01, (S_, S_))]
                             ).astype(np.float32)),
        cr_pos=torch.zeros((B, NR, 2, 3), dtype=torch.int32),
        cr_q=torch.zeros((B, NR, 3)),
        consts=(20.0, 8e4, 2.4, 0.02))


@pytest.mark.parametrize("nonlin,ipc,scalar_gain", [
    (True, False, False), (True, True, False), (False, True, True),
    (True, True, True)])
def test_readout_function_jvp_and_backward_match_autograd_of_plain(
        nonlin, ipc, scalar_gain):
    """The Function's jvp (``torch.func.jvp``, and ``jacfwd`` through
    either input alone; written out, not taken of the plain version) and
    backward (``torch.autograd``) against the same derivatives of the plain
    readout itself, taken by autograd, with the noise off: rtol 1e-6 of each
    output's largest entry (measured 1.2e-7); the value is the plain
    version's bit for bit. Charges near the full well (the bands reach
    4e4 e- of 8e4) exercise the non-linearity's slope."""
    inp = _readout_inputs(np.random.default_rng(1))
    flags = dict(poisson=False, read_noise=False, non_linearity=nonlin,
                 bias=True, scalar_gain=scalar_gain, with_cr=False,
                 bg_poisson=True, ipc=ipc)

    def call(fn, bands, bg):
        return fn(**dict(inp, bands=bands, bg_rate=bg), **flags)

    fun = lambda b, g: call(ro.exposure_readout, b, g)
    plain = lambda b, g: call(ro.exposure_readout_plain, b, g)
    b0, g0 = inp["bands"], inp["bg_rate"]
    for a, b in zip(fun(b0, g0), plain(b0, g0)):
        assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(3)
    db = torch.randn(b0.shape, generator=gen)
    dg = torch.randn(g0.shape, generator=gen)
    close = lambda a, b: torch.testing.assert_close(
        a, b, rtol=0.0, atol=1e-6 * float(b.abs().max()))
    for a, b in zip(torch.func.jvp(fun, (b0, g0), (db, dg))[1],
                    torch.func.jvp(plain, (b0, g0), (db, dg))[1]):
        close(a, b)
    jf = torch.func.jacfwd(lambda s: fun(b0 * s, g0)[0].sum((-1, -2)))
    jp = torch.func.jacfwd(lambda s: plain(b0 * s, g0)[0].sum((-1, -2)))
    close(jf(torch.ones(())), jp(torch.ones(())))
    # a tangent on bg_rate alone
    jf = torch.func.jacfwd(lambda s: fun(b0, g0 * s)[0].sum((-1, -2)))
    jp = torch.func.jacfwd(lambda s: plain(b0, g0 * s)[0].sum((-1, -2)))
    close(jf(torch.ones(())), jp(torch.ones(())))
    g_reads = torch.randn((2, 4, 12, 12), generator=gen)
    g_cum = torch.randn((2, 12, 12), generator=gen)
    grads = []
    for fn in (fun, plain):
        b, g = b0.clone().requires_grad_(), g0.clone().requires_grad_()
        reads, cum = fn(b, g)
        ((reads * g_reads).sum() + (cum * g_cum).sum()).backward()
        grads.append((b.grad, g.grad))
    close(grads[0][0], grads[1][0])
    close(grads[0][1], grads[1][1])


def test_readout_function_half_derivative_at_the_full_well():
    """A pixel whose charge lands exactly on the full well: the value is
    the plain version's, and the derivative there is half the slope below
    it, as ``jnp.minimum`` splits a tie (the readout's tangent in the JAX
    package's retrieval)."""
    inp = _readout_inputs(np.random.default_rng(4), B=1, NR=2)
    fw = 8e4
    bands = torch.zeros_like(inp["bands"])
    y0 = int(inp["y0s"][0, 1])
    bands[0, 1, 0, 3] = fw                   # read 1, row y0, column 3
    off = dict(poisson=False, read_noise=False, with_cr=False, bias=False,
               non_linearity=True, ipc=False, scalar_gain=False)
    kw = dict(inp, bg_rate=torch.zeros_like(inp["bg_rate"]), consts=(
        20.0, fw, 2.4, 0.02))
    fun = lambda b: ro.exposure_readout(**dict(kw, bands=b), **off)[0]
    tang = torch.zeros_like(bands)
    tang[0, 1, 0, 3] = 1.0
    reads, d = torch.func.jvp(fun, (bands,), (tang,))
    assert torch.equal(reads, ro.exposure_readout_plain(
        **dict(kw, bands=bands), **off)[0])
    c = kw["nl_coeffs"][:, y0, 3]
    below = kw["inv_gain"][y0, 3] * (1.0 - 2.0 * c[0] - 3.0 * c[1]
                                     - 4.0 * c[2])
    torch.testing.assert_close(d[0, 1, y0, 3], 0.5 * below, rtol=1e-6,
                               atol=0.0)
    assert int(torch.count_nonzero(d)) == 1


def test_readout_function_refuses_other_derivatives():
    """A derivative with respect to any input but bands and bg_rate, or
    with the noise on, raises instead of being dropped; ``vmap`` over the
    bands folds into one call that equals the plain version's."""
    inp = _readout_inputs(np.random.default_rng(2))
    off = dict(poisson=False, read_noise=False, with_cr=False)
    with pytest.raises(ValueError, match="bias_map carries a derivative"):
        torch.func.jvp(lambda m: ro.exposure_readout(
            **dict(inp, bias_map=m), **off)[0], (inp["bias_map"],),
            (inp["bias_map"],))
    with pytest.raises(ValueError, match="dts carries a derivative"):
        ro.exposure_readout(
            **dict(inp, dts=inp["dts"].clone().requires_grad_()), **off)
    # through the Function's vmap rule too (jacfwd = vmap of jvp)
    with pytest.raises(ValueError, match="dts carries a derivative"):
        torch.func.jacfwd(lambda d: ro.exposure_readout(
            **dict(inp, dts=d), **off)[1])(inp["dts"])
    with pytest.raises(ValueError, match="inv_gain carries a derivative"):
        torch.func.grad(lambda g: ro.exposure_readout(
            **dict(inp, inv_gain=g), **off)[1].sum())(inp["inv_gain"])
    with pytest.raises(ValueError, match="noise"):
        torch.func.jvp(lambda b: ro.exposure_readout(
            **dict(inp, bands=b), poisson=True, read_noise=False,
            with_cr=False)[0], (inp["bands"],), (inp["bands"],))
    stack = torch.stack([inp["bands"], 0.5 * inp["bands"]])
    got = torch.func.vmap(lambda b: ro.exposure_readout(
        **dict(inp, bands=b), **off)[0])(stack)
    for k in range(2):
        assert torch.equal(got[k], ro.exposure_readout_plain(
            **dict(inp, bands=stack[k]), **off)[0])


# ---------------------------------------------------------------------------
# forward_spectra and the LM Jacobian against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("estimator,y_window", [("cds", None),
                                                ("ramp", (6, 50))])
def test_forward_spectra_matches_jax(estimator, y_window):
    """The model twin's spectra, rtol 1e-5 and atol 1e-3 DN (the bar of
    tests/test_retrieval.py's noise-free forward check; measured 0.73 of
    it at most); the whole-exposure route the port's twin takes equals the
    per-read route bit for bit."""
    v = _visit()
    want = np.asarray(ret_j.forward_spectra(
        v.scenes, v.tables, ret_j.deterministic_cfg(v.cfg), chunk=5,
        estimator=estimator, y_window=y_window))
    cfg, tables, scenes = v.port
    twin = ret_t.deterministic_cfg(cfg)
    assert twin.fused_reads and not twin.noise.poisson and not twin.ssv_walk
    got = ret_t.forward_spectra(scenes, tables, twin, chunk=5,
                                estimator=estimator, y_window=y_window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    per_read = ret_t.forward_spectra(
        scenes, tables, dataclasses.replace(twin, fused_reads=False),
        chunk=5, estimator=estimator, y_window=y_window)
    assert torch.equal(per_read, got)


def _jac_inputs(v: Visit, variant: str, theta_depth):
    """Both packages' _lm_val_jac arguments at one theta: the data are the
    noise-free spectra, sigma 1e-4 per channel."""
    obs = _observe(v)
    edges = _channel_edges(X_WINDOW, N_CHAN)
    orbit0 = jax.tree_util.tree_map(lambda x: x[0], v.scenes.orbit)
    mid = v.scenes.exp_start_s + 0.5 * float(v.tables.read_times[-1])
    oot = out_of_transit_mask(mid, orbit0).astype(jnp.float32)
    data = ret_j._normalise_oot(ret_j._bin_channels(jnp.asarray(obs),
                                                    edges), oot)
    idx, inw = ret_j.bin_channel_map(v.scenes, v.tables, X_WINDOW, N_CHAN)
    eclipse = variant == "eclipse"
    fixed = v.scenes.fp_over_fs[0] if eclipse else v.scenes.rp_over_rs[0]
    rev = (np.asarray(v.scenes.scan_speed) < 0).astype(np.float32)
    sig = np.full(N_CHAN, 1e-4, np.float32)
    statics = dict(chunk=6, estimator="cds", y_window=None, n_rp=N_CHAN,
                   eclipse=eclipse, fit_t0=variant == "ramp_t0",
                   fit_ramp=variant == "ramp_t0",
                   fit_scan_offset=variant == "nuisances",
                   fit_spots=variant == "nuisances")
    extra = {"ramp_t0": [40.0, 0.01 / 86400.0, 0.003],
             "nuisances": [0.004, 0.8]}.get(variant, [])
    theta = np.asarray(list(theta_depth) + extra, np.float64)
    args_j = (ret_j.deterministic_scenes(v.scenes), v.tables, data, oot,
              jnp.asarray(sig), jnp.asarray(idx), jnp.asarray(inw,
                                                              jnp.float32),
              fixed, jnp.asarray(rev), edges)
    cfg, tables, scenes = v.port
    t = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), dtype=dt)
    args_t = (ret_t.deterministic_scenes(scenes), tables, t(data), t(oot),
              t(sig), t(idx, torch.int64), t(inw), t(fixed), t(rev), edges)
    return (theta, args_j, dict(statics, cfg=ret_j.deterministic_cfg(v.cfg)),
            args_t, dict(statics, cfg=ret_t.deterministic_cfg(cfg)))


def _port_val_jac(theta, args_t, st_t, with_jac=True):
    out = ret_t._lm_val_jac(torch.as_tensor(theta, dtype=torch.float32),
                            *args_t, with_jac=with_jac, **st_t)
    return (tuple(o.numpy().astype(np.float64) for o in out) if with_jac
            else out.numpy().astype(np.float64))


# depths off the rp vector's minimum and maximum (held by out-of-window
# bins: 0.1555 and 0.1635), as the JAX package's Jacobian needs
OFF_TIE = (0.158, 0.160, 0.157, 0.161)


@pytest.mark.parametrize("variant", ["transit", "eclipse", "ramp_t0",
                                     "nuisances"])
def test_lm_jacobian_matches_jax(variant):
    """_lm_val_jac's residuals and ``jacfwd`` Jacobian against JAX's,
    where no fitted channel holds the rp vector's minimum or maximum:
    transit, eclipse (Fp/Fs), fit_ramp + fit_t0, fit_scan_offset +
    fit_spots. Residuals within 1e-6 of a normalised flux (0.01 at sigma
    1e-4: 8 float32 ulps of 1; measured 8.9e-7). A depth column
    within 2e-3 of its largest entry: both packages interpolate the flux
    between control radii 5e-4 apart, so a depth column is the difference
    of two fluxes near 1 over that step, and their float32 roundings (6e-8)
    are 4e-4 of it (measured 5.3e-4); a nuisance column within 1e-4
    (measured 1.8e-6; the spot scale's 3.9e-5: the spot deficit is a
    difference of nearly equal occulted areas)."""
    v = _visit("eclipse" if variant == "eclipse" else
               "nuisances" if variant == "nuisances" else "transit")
    depths = (1.4e-3, 1.6e-3, 1.2e-3, 1.7e-3) if variant == "eclipse" \
        else OFF_TIE
    theta, args_j, st_j, args_t, st_t = _jac_inputs(v, variant, depths)
    r_j, J_j = (np.asarray(a, np.float64) for a in ret_j._lm_val_jac(
        jnp.asarray(theta), *args_j, with_jac=True, **st_j))
    r_t, J_t = _port_val_jac(theta, args_t, st_t)
    assert J_t.shape == J_j.shape == (N_EXP * N_CHAN, theta.size)
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-6 / 1e-4)
    np.testing.assert_array_equal(
        _port_val_jac(theta, args_t, st_t, with_jac=False), r_t)
    for c in range(theta.size):
        bar = (2e-3 if c < N_CHAN else 1e-4) * np.abs(J_j[:, c]).max()
        np.testing.assert_allclose(J_t[:, c], J_j[:, c], rtol=0, atol=bar,
                                   err_msg=f"column {c}")
        assert np.abs(J_t[:, c]).max() > 0.0


def test_trapped_jacobian_matches_finite_differences():
    """Every fitted channel at 0.150, below every out-of-window radius
    (0.1555-0.1635): the rp vector's minimum is the fitted set itself.
    There the JAX package's depth block is singular (its control grid's
    bounds and clip carry the tangent: condition number 1.2e24, each
    column spread evenly over the four channels' rows); the port's holds
    central finite differences (h = 2e-4) within 2e-2 of each column's
    largest entry (measured 6.3e-3: the secant crosses a control node and
    float32 resolves a 6e-5 flux change to 1e-3), and each channel's
    column lies on its own channel's rows (measured 99.2% of its square
    at least; condition number 1.17)."""
    v = _visit()
    theta, args_j, st_j, args_t, st_t = _jac_inputs(v, "transit",
                                                    (0.150,) * N_CHAN)
    J_j = np.asarray(ret_j._lm_val_jac(jnp.asarray(theta), *args_j,
                                       with_jac=True, **st_j)[1])
    _, J_t = _port_val_jac(theta, args_t, st_t)
    own = np.zeros((N_EXP, N_CHAN, N_CHAN), bool)
    for c in range(N_CHAN):
        own[:, c, c] = True
    own = own.reshape(-1, N_CHAN)
    share = lambda J: (np.sum(np.where(own, J, 0.0) ** 2, axis=0)
                       / np.sum(J ** 2, axis=0))
    assert np.all(share(J_j) < 0.5) and np.linalg.cond(J_j) > 1e6
    assert np.all(share(J_t) > 0.98) and np.linalg.cond(J_t) < 10.0
    h = 2e-4
    for c in range(N_CHAN):
        tp, tm = theta.copy(), theta.copy()
        tp[c] += h
        tm[c] -= h
        fd = (_port_val_jac(tp, args_t, st_t, with_jac=False)
              - _port_val_jac(tm, args_t, st_t, with_jac=False)) / (2 * h)
        np.testing.assert_allclose(J_t[:, c], fd, rtol=0,
                                   atol=2e-2 * np.abs(fd).max())


def test_flat_start_jacobian_matches_finite_differences():
    """The retrieval's own start on a flat spectrum (run_retrieve's
    rp_init is the YAML's flat Rp/Rs, so every bin holds one value): the
    depth columns within 3e-3 of each column's largest entry of central
    finite differences, h = 2e-3 (each perturbed bin then sits on a control
    node, so the differences are of uninterpolated fluxes). Measured 1.1e-3
    with the control grid's least span 2e-3; 1.05e-2 with the JAX
    package's 1e-4."""
    v = _visit("flat")
    theta, _, _, args_t, st_t = _jac_inputs(v, "transit", (0.1595,) * N_CHAN)
    _, J_t = _port_val_jac(theta, args_t, st_t)
    h = 2e-3
    for c in range(N_CHAN):
        tp, tm = theta.copy(), theta.copy()
        tp[c] += h
        tm[c] -= h
        fd = (_port_val_jac(tp, args_t, st_t, with_jac=False)
              - _port_val_jac(tm, args_t, st_t, with_jac=False)) / (2 * h)
        assert np.abs(fd).max() > 0.0
        np.testing.assert_allclose(J_t[:, c], fd, rtol=0,
                                   atol=3e-3 * np.abs(fd).max())


@pytest.mark.parametrize("spread", [0.0, 5e-5, 1e-3, 1.9e-3])
def test_narrow_spectrum_light_curve_matches_jax(spread):
    """A spectrum narrower than the control grid's least span (the port's
    2e-3, the JAX package's 1e-4): the interpolated light curve within the
    JAX package's by 2e-6 (tests/test_torch_physics.py's bar) and within
    4e-7 of the port's uninterpolated one (measured 2.4e-7 at most, as far
    as with the JAX package's span: float32 rounding of the weights)."""
    import wayne_tpu.ops.transit as tr_j
    from wayne_tpu.ops.kepler import OrbitParams as OrbitJ
    from wayne_tpu_torch.ops import transit as tr_t
    from wayne_tpu_torch.ops.kepler import OrbitParams as OrbitT

    orbit = dict(period_s=0.813475 * 86400.0, t0_s=0.0, sma_rs=4.855,
                 inc_rad=float(np.deg2rad(82.1)))
    t = np.linspace(-3000.0, 3000.0, 200).astype(np.float32)
    wl = np.linspace(1.1, 1.7, NL)
    rp = (0.1595 + 0.5 * spread * np.sin(9.0 * wl)).astype(np.float32)
    ld = np.asarray([0.5, -0.1, 0.3, -0.1], np.float32)
    want = np.asarray(tr_j.transit_light_curve(
        jnp.asarray(t), OrbitJ.create(**orbit), jnp.asarray(rp),
        jnp.asarray(ld), 64))
    T = torch.as_tensor
    got, direct = (tr_t.transit_light_curve(
        T(t), OrbitT.create(**orbit), T(rp), T(ld), 64,
        interp_channels=interp).numpy() for interp in (True, False))
    assert got.min() < 0.98
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, direct, rtol=0, atol=4e-7)


# ---------------------------------------------------------------------------
# The retrievals against the JAX package's
# ---------------------------------------------------------------------------

def _compare_results(got, want, rp_bar=1e-5):
    """Depths within ``rp_bar``, sigmas within 5e-3 relative (each scaled
    by its channel's residual rms, a float32 sum over the curve), the same
    iteration count, chi^2 within 1e-2 relative + 1e-6."""
    np.testing.assert_allclose(got.rp, want.rp, rtol=0, atol=rp_bar)
    np.testing.assert_allclose(got.rp_sigma, want.rp_sigma, rtol=5e-3)
    assert got.n_iter == want.n_iter and got.n_points == want.n_points
    assert abs(got.chi2 - want.chi2) <= 1e-2 * abs(want.chi2) + 1e-6
    np.testing.assert_array_equal(got.constrained, want.constrained)


def test_retrieve_transmission_matches_jax():
    """Four LM steps from a start off the tie, on a wiggly spectrum's
    spectra with 2e-4 of scatter, the noise prior from the out-of-transit
    scatter: depths within 1e-5 (measured 1.3e-6), sigmas 5e-3 (measured
    2.1e-3), chi^2 1e-2 (1.5e-3); the recovered channels within 1e-3 of
    the injected in-channel means."""
    v = _visit()
    obs = _observe(v, noise_seed=5)
    kw = dict(x_window=X_WINDOW, n_chan=N_CHAN, rp_init=np.array(OFF_TIE),
              chunk=6, n_lm=4)
    want = ret_j.retrieve_transmission(jnp.asarray(obs), v.scenes, v.tables,
                                       v.cfg, **kw)
    cfg, tables, scenes = v.port
    got = ret_t.retrieve_transmission(torch.as_tensor(obs), scenes, tables,
                                      cfg, **kw)
    _compare_results(got, want)
    idx, inw = ret_j.bin_channel_map(v.scenes, v.tables, X_WINDOW, N_CHAN)
    truth = np.array([v.truth[inw & (idx == c)].mean()
                      for c in range(N_CHAN)])
    assert np.all(np.abs(got.rp - truth) < 1e-3), (got.rp, truth)


def test_retrieve_transmission_joint_matches_jax():
    """Two visits, the second's transit 150 s late, a shared spectrum and
    a per-visit t0 (grid-seeded over +-600 s), three LM steps: depths
    within 1e-5, t0 offsets within 0.05 s, sigmas 5e-3, the model curves
    at the solution within 1e-6 (measured 9.8e-7, 0.0031 s, 7.2e-4,
    7.7e-7)."""
    v1, v2 = _visit(seed=0), _visit(seed=1)
    late = dataclasses.replace(v2.scenes, orbit=dataclasses.replace(
        v2.scenes.orbit, t0_s=v2.scenes.orbit.t0_s + 150.0))
    obs = [_observe(v1, noise_seed=6),
           _observe(dataclasses.replace(v2, scenes=late), noise_seed=7)]
    kw = dict(x_window=X_WINDOW, n_chan=N_CHAN, rp_init=np.array(OFF_TIE),
              chunk=6, n_lm=3, t0_window_s=600.0)
    want = ret_j.retrieve_transmission_joint(
        [jnp.asarray(o) for o in obs], [v1.scenes, v2.scenes], v1.tables,
        v1.cfg, **kw)
    cfg, tables, s1 = v1.port
    s2 = v2.port[2]
    got = ret_t.retrieve_transmission_joint(
        [torch.as_tensor(o) for o in obs], [s1, s2], tables, cfg, **kw)
    _compare_results(got, want)
    np.testing.assert_allclose(got.t0_offsets_s, want.t0_offsets_s,
                               rtol=0, atol=0.05)
    np.testing.assert_allclose(got.t0_offsets_sigma_s,
                               want.t0_offsets_sigma_s, rtol=2e-3)
    for a, b in zip(got.model_chan, want.model_chan):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert abs(got.t0_offsets_s[1] - got.t0_offsets_s[0] - 150.0) < 5.0


def test_retrieval_refusals_match_jax():
    """The JAX package's argument errors, message for message."""
    v = _visit()
    cfg, tables, scenes = v.port
    ones_j = jnp.ones((N_EXP, S), jnp.float32)
    ones_t = torch.ones((N_EXP, S))
    nuis = dataclasses.replace(v.cfg.noise, visit_trend=False)
    for kw, match in (
            (dict(fit_scan_offset=True), "alternating"),
            (dict(fit_spots=True), "scenes.spots"),
            (dict(mode="dayside"), "mode must be"),
            (dict(mode="eclipse"), "eclipse=True"),
            (dict(n_chan=50), "no wavelength-bin")):
        said = []
        for fn, sp, sc, tb, cf in (
                (ret_j.retrieve_transmission, ones_j, v.scenes, v.tables,
                 v.cfg),
                (ret_t.retrieve_transmission, ones_t, scenes, tables, cfg)):
            with pytest.raises(ValueError, match=match) as err:
                fn(sp, sc, tb, cf, **dict(dict(x_window=X_WINDOW,
                                               n_chan=N_CHAN), **kw))
            said.append(str(err.value))
        assert said[0] == said[1], said
    with pytest.raises(ValueError, match="visit_trend"):
        ret_t.retrieve_transmission(
            ones_t, scenes, tables,
            dataclasses.replace(cfg, noise=config_t.NoiseFlags(
                **dataclasses.asdict(nuis))),
            x_window=X_WINDOW, n_chan=N_CHAN, fit_ramp=True)
    with pytest.raises(ValueError, match="exposures"):
        ret_t.retrieve_transmission(ones_t[:5], scenes, tables, cfg,
                                    x_window=X_WINDOW, n_chan=N_CHAN)

"""The port's divide-white sigma probe (``wayne_tpu_torch.tools.
probe_dw_sigma``) on the CPU at a small size, against the JAX package's
tool.

- The sin-only variant's clean run (the sinusoidal SSV and the visit trend,
  no noise, the walk off: deterministic) against the JAX tool's
  ``make_run`` composition (``tools/probe_dw_sigma.py:66-104``: no
  amplifier correction, ``divide_white_fit_depths`` with its components)
  at 128^2, NSAMP 3, 16 exposures, 4 channels: both pipelines reduce the
  JAX tool's reads (the port's own held to them at rtol 2e-5), Rp/Rs at
  rtol 1e-5.
- The ratio arithmetic against the JAX tool's own statements (lifted with
  ``ast`` from its ``variant``) on seeded stacks, exactly.
- The variants are the JAX tool's; ``--bg-rows`` parses as the JAX tool
  parses it; one variant end to end at n_mc 2 prints the JAX tool's line
  with finite ratios; the CLI raises without a card unless ``--cpu``.

The file takes ~40 s on one core (JAX compiles dominate).
"""

import ast
import dataclasses
import io
import os
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu.calibration import synthetic_tables as synthetic_tables_j
from wayne_tpu.config import ExposureStatic as ExposureStatic_j
from wayne_tpu.config import NoiseFlags as NoiseFlags_j
from wayne_tpu.ops.exposure import simulate_exposure as simulate_exposure_j
from wayne_tpu.reduction import divide_white_fit_depths as divide_white_j
from wayne_tpu.reduction import reduce_visit as reduce_visit_j
from wayne_tpu.scene import example_scene as example_scene_j
from wayne_tpu_torch.tools import probe_dw_sigma as pr
from wayne_tpu_torch.tools import validate_recovery as vr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "probe_dw_sigma.py")
S, NL, NSAMP, N_EXP, N_CHAN = 128, 64, 3, 16, 4
SEQ = "SPARS10"
X_REF, Y_REF = -60.0, 30.0
X_WIN, Y_WIN, BG = (4, 124), (20, 50), (90, 125)
CORE = dict(S=S, NL=NL, NSAMP=NSAMP, N_EXP=N_EXP, N_CHAN=N_CHAN,
            samp_seq=SEQ, band_px=32, x_ref=X_REF, y_ref=Y_REF,
            x_window=X_WIN, y_window=Y_WIN, bg_rows=BG)


def _jax_tool():
    with open(TOOL) as fh:
        tree = ast.parse(fh.read())
    main, = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "main"]
    return main


def _variant_calls():
    """The JAX tool's ``variant(name, flags, rw)`` calls, evaluated."""
    calls = [s.value for s in _jax_tool().body
             if isinstance(s, ast.Expr) and isinstance(s.value, ast.Call)
             and getattr(s.value.func, "id", None) == "variant"]
    return [tuple(eval(compile(ast.Expression(a), TOOL, "eval"))
                  for a in c.args) for c in calls]


def _lift_ratio():
    """The JAX tool's statements from ``dev = rp_n - rp_c`` to ``ratio =
    ...`` in its ``variant``, as a function of the stacks."""
    variant, = [n for n in _jax_tool().body
                if isinstance(n, ast.FunctionDef) and n.name == "variant"]
    names = [{t.id for t in getattr(s, "targets", [])
              if isinstance(t, ast.Name)} for s in variant.body]
    start = next(i for i, n in enumerate(names) if "dev" in n)
    stop = next(i for i, n in enumerate(names) if "ratio" in n)
    code = compile(ast.Module(body=variant.body[start: stop + 1],
                              type_ignores=[]), TOOL, "exec")

    def run(rp_n, rp_c, rel, n_chan):
        ns = {"rp_n": rp_n, "rp_c": rp_c, "rel": rel, "N_CHAN": n_chan,
              "np": np}
        exec(code, ns)
        return ns["ratio"]
    return run


def test_variants_are_the_jax_tools():
    assert [(n, f, rw) for n, f, rw in pr.VARIANTS] == _variant_calls()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ratio_arithmetic_matches_the_jax_tool(seed):
    rng = np.random.default_rng(seed)
    n_mc, n_chan = 12, 8
    rp_c = 0.157 + 1e-3 * rng.standard_normal((n_mc, n_chan))
    rp_n = rp_c + rng.uniform(2e-4, 9e-4, n_chan) * rng.standard_normal(
        (n_mc, n_chan))
    rel = rng.uniform(2e-4, 8e-4, n_chan)
    rel[seed] = 0.0                                 # the 1e-12 floor
    np.testing.assert_array_equal(pr.rel_ratio(rp_n, rp_c, rel, n_chan),
                                  _lift_ratio()(rp_n, rp_c, rel, n_chan))


@pytest.mark.parametrize("text,want", [("180:250", (180, 250)),
                                       ("4:36", (4, 36)),
                                       ("0:16", (0, 16))])
def test_bg_rows_parse_as_the_jax_tool(text, want):
    assert pr.parse_bg_rows(text) == want
    assert tuple(int(v) for v in text.split(":")) == want


def _jax_clean_run(cfg_noise):
    """The JAX tool's clean ``make_run`` of the sin-only variant at the
    test's size: (its reads, its divide-white depths)."""
    cfg = ExposureStatic_j(subarray=S, n_lambda=NL, n_sub=4, nsamp=NSAMP,
                           samp_seq=SEQ, scan=True, noise=cfg_noise,
                           band_px=32)
    tables = synthetic_tables_j("G141", subarray=S, n_lambda=NL,
                                samp_seq=SEQ, nsamp=NSAMP)
    base = example_scene_j(NL, scan_speed=0.5)
    wl = np.asarray(tables.wl_centers)
    b = dataclasses.replace(
        base, x_ref=jnp.float32(X_REF), y_ref=jnp.float32(Y_REF),
        rp_over_rs=jnp.asarray(0.1595 + 0.003 * np.sin(8.0 * wl),
                               jnp.float32),
        trends=dataclasses.replace(base.trends, ssv_rw_amp=jnp.float32(0.0)))
    v = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N_EXP,) + x.shape), b)
    starts = np.linspace(0.0, 4.0 * 3600.0, N_EXP)
    v = dataclasses.replace(v, exp_start_s=jnp.asarray(starts, jnp.float32))
    mid = jnp.asarray(starts + float(tables.read_times[-1]) / 2.0,
                      jnp.float32)
    keys = jax.vmap(lambda e: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(123), 0), e))(jnp.arange(N_EXP))
    reads = jax.jit(lambda s: jax.lax.map(
        lambda x: simulate_exposure_j(x, tables, cfg).reads_dn, s))(
        dataclasses.replace(v, key=keys))
    red = reduce_visit_j(reads, tables.gain, mid, base.orbit,
                         y_window=Y_WIN, x_window=X_WIN, bg_rows=BG,
                         n_chan=N_CHAN)
    rp = divide_white_j(red.white_lc, red.channel_lc, mid, base.orbit,
                        base.ld, jnp.float32(0.155),
                        return_components=True)[0]
    return np.asarray(reads), np.asarray(rp, np.float64)


def test_sin_only_clean_run_matches_jax(monkeypatch):
    name, extra, rw = pr.VARIANTS[2]
    assert name.startswith("sin-only") and rw == 0.0
    core = vr.build_core("cpu", **CORE)
    noisy, clean = pr.variant_cfgs(core, extra)
    assert noisy.noise == dataclasses.replace(core.flags, **extra)
    reads_j, rp_j = _jax_clean_run(dataclasses.replace(
        NoiseFlags_j.none(), ssv=True, visit_trend=True))
    real = vr.sim_reads

    def same(scenes, tables, cfg):
        mine, cr_pos, cr_count = real(scenes, tables, cfg)
        np.testing.assert_allclose(
            mine.numpy(), reads_j, rtol=2e-5,
            atol=max(1e-3, 5e-6 * float(np.abs(reads_j).max())))
        return torch.as_tensor(reads_j.copy()), cr_pos, cr_count

    monkeypatch.setattr(vr, "sim_reads", same)
    run = pr.variant_run(core, rw)
    assert run.quad is None and run.seed == 123
    got = vr.ensemble(core, run, clean, "divide-white", 1)["rp"][0]
    np.testing.assert_allclose(got, rp_j, rtol=1e-5, atol=0)


def test_one_variant_end_to_end_prints_the_jax_line():
    lines = []
    res = pr.probe(2, "cpu", (90, 125), variants=pr.VARIANTS[:1],
                   core_kw=CORE, say=lines.append)
    name = pr.VARIANTS[0][0]
    assert lines[0] == "bg_rows=(90, 125)"
    assert lines[1].startswith(f"{name:28s} ratio=[")
    r = res[name]
    assert r["rp_noisy"].shape == r["rp_clean"].shape == (2, N_CHAN)
    assert np.all(np.isfinite(r["ratio"])) and np.all(r["ratio"] > 0)
    assert not np.array_equal(r["rp_noisy"], r["rp_clean"])


def test_cli_raises_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(RuntimeError, match="CUDA"):
            pr.main(["--n-mc", "2"])

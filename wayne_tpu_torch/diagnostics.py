"""Optional matplotlib quicklook diagnostics (port of the JAX package's
``diagnostics``): host-side PNGs of an exposure, a visit's extracted
spectra and white light curve, and a ``run_reduce`` report.

matplotlib is imported only when a plot is drawn (Agg backend); nothing
else in the port needs it.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def quicklook_exposure(reads_dn, path: str, title: str = "exposure") -> str:
    """Last-read image + up-the-ramp traces of the 5 brightest pixels of
    one exposure's reads (NR, S, S) -> one PNG."""
    plt = _plt()
    reads = _host(reads_dn)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    net = reads[-1] - reads[0]
    im = axes[0].imshow(net, origin="lower", cmap="magma",
                        vmin=0, vmax=np.percentile(net, 99.5))
    axes[0].set_title(f"{title}: last - zeroth read (DN)")
    fig.colorbar(im, ax=axes[0], shrink=0.8)
    ys, xs = np.unravel_index(np.argsort(net.ravel())[-5:], net.shape)
    for y, x in zip(ys, xs):
        axes[1].plot(reads[:, y, x] - reads[0, y, x], marker="o", ms=3,
                     label=f"({y},{x})")
    axes[1].set_xlabel("read")
    axes[1].set_ylabel("DN above zeroth read")
    axes[1].set_title("up-the-ramp samples (brightest pixels)")
    axes[1].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def quicklook_visit(spectra_e, white_lc, exp_mid_s, path: str) -> str:
    """Extracted spectra stack (n_exp, S) + white light curve -> one PNG."""
    plt = _plt()
    spectra = _host(spectra_e)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    im = axes[0].imshow(spectra, origin="lower", aspect="auto",
                        cmap="viridis")
    axes[0].set_xlabel("detector column")
    axes[0].set_ylabel("exposure")
    axes[0].set_title("extracted spectra (e-)")
    fig.colorbar(im, ax=axes[0], shrink=0.8)
    t = _host(exp_mid_s) / 3600.0
    axes[1].plot(t, _host(white_lc), ".", ms=4)
    axes[1].set_xlabel("time (h)")
    axes[1].set_ylabel("relative flux")
    axes[1].set_title("white light curve")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def quicklook_reduction(report: dict, path: str) -> str:
    """One PNG from a run_reduce JSON report: the white light curve and
    the recovered spectrum with error bars (Rp/Rs in transit mode, Fp/Fs
    in eclipse and phase mode)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    t = np.asarray(report["mid_times_s"]) / 3600.0
    axes[0].plot(t, np.asarray(report["white_lc"]), ".", ms=4)
    axes[0].set_xlabel("time (h)")
    axes[0].set_ylabel("relative flux")
    axes[0].set_title("white light curve")
    chans = report["channels"]
    wl = [(c["wl_lo_um"] + c["wl_hi_um"]) / 2 for c in chans]
    emission = report.get("mode") in ("eclipse", "phase")
    key, skey = (("fp_over_fs", "fp_sigma") if emission
                 else ("rp_over_rs", "rp_sigma"))
    axes[1].errorbar(wl, [c[key] for c in chans],
                     yerr=[c[skey] for c in chans], fmt="o", ms=4,
                     capsize=3)
    axes[1].set_xlabel("wavelength (um)")
    axes[1].set_ylabel("Fp / Fs" if emission else "Rp / Rs")
    axes[1].set_title("recovered " + ("emission" if emission
                                      else "transmission") + " spectrum")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def quicklook_curves(obs, reads_dn):
    """What the visit quicklook plots: ``reduce_visit`` of a visit's reads
    (n_exp, NR, S, S) DN (a tensor or a NumPy array) over the whole frame
    in 8 channels, sky from the first S/16 rows, on the device of the
    observation's tables. Returns (ReducedVisit, mid-times (n_exp,) s)."""
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.reduction import reduce_visit

    dev = obs.tables.device
    S = obs.cfg.subarray
    mid = obs.plan.exp_start_s + obs.detector_exptime / 2.0
    red = reduce_visit(
        torch.as_tensor(reads_dn).to(dev), obs.tables.gain,
        torch.as_tensor(mid, dtype=torch.float32, device=dev),
        tree_map(lambda x: x.to(dev), obs.planet.orbit_params()),
        y_window=(0, S), x_window=(0, S), bg_rows=(0, max(S // 16, 2)),
        n_chan=8)
    return red, mid


def visit_quicklooks(obs, result, outdir: str) -> list[str]:
    """Quicklook PNGs of an Observation and its reads (``result.reads_dn``,
    (n_exp, NR, S, S) DN, a tensor or a NumPy array): the first exposure
    (``exposure0.png``) and :func:`quicklook_curves`' spectra and white
    curve (``visit_lightcurve.png``)."""
    os.makedirs(outdir, exist_ok=True)
    reads = torch.as_tensor(result.reads_dn)
    paths = [quicklook_exposure(
        reads[0], os.path.join(outdir, "exposure0.png"),
        title=f"{obs.cfg.star.name} {obs.cfg.grism}")]
    red, mid = quicklook_curves(obs, reads)
    paths.append(quicklook_visit(
        red.spectra_e, red.white_lc, mid,
        os.path.join(outdir, "visit_lightcurve.png")))
    return paths

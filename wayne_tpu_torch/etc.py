"""Exposure-time calculator (port of the JAX package's ``etc``): the
saturation and SNR prediction for a configuration, from one noise-free
exposure of the simulator's own exposure path, so that the prediction
cannot drift from the instrument model.

  - the peak accumulated charge of each read against full well (which
    read saturates first, if any),
  - the source electrons of an exposure, the sky and dark background in
    the extraction window, the sample sequence's duty cycle,
  - the white-light and median per-column SNR of the CDS and up-the-ramp
    estimators (photon + sky + dark + read noise),
  - warnings (saturation, NSAMP headroom, off-detector spectrum).

Usage:
    python -m wayne_tpu_torch.etc -p pars.yml [--sat-margin 0.85] [--cpu]
or  from wayne_tpu_torch.etc import predict; rep = predict(cfg)

The exposure runs on the CUDA card (through the whole-exposure readout
kernel, the noise flags off) unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["predict", "EtcReport", "main"]


@dataclasses.dataclass
class EtcReport:
    peak_e_per_read: list[float]     # max accumulated e- at each read
    full_well_e: float
    peak_frac_full_well: float       # last read's peak / full well
    first_saturating_read: int | None
    source_e_per_exposure: float     # total source electrons (last read)
    background_e_per_px: float       # sky+dark e-/px accumulated, window
    exptime_s: float
    duty_cycle: float                # exptime / (exptime + overhead)
    snr_white_cds: float
    snr_white_ramp: float
    snr_per_column_median: float     # median over illuminated columns, CDS
    n_illuminated_columns: int
    warnings: list[str]

    def summary(self) -> str:
        lines = [
            f"peak charge {self.peak_e_per_read[-1]:.0f} e- "
            f"({100 * self.peak_frac_full_well:.1f}% of full well "
            f"{self.full_well_e:.0f} e-)",
            f"source {self.source_e_per_exposure:.3g} e-/exposure, "
            f"background {self.background_e_per_px:.1f} e-/px, "
            f"exptime {self.exptime_s:.1f} s "
            f"(duty cycle {100 * self.duty_cycle:.0f}%)",
            f"white SNR {self.snr_white_cds:.0f} (CDS) / "
            f"{self.snr_white_ramp:.0f} (up-the-ramp); median column SNR "
            f"{self.snr_per_column_median:.0f} over "
            f"{self.n_illuminated_columns} columns",
        ]
        if self.first_saturating_read is not None:
            lines.append(f"SATURATES at read {self.first_saturating_read}")
        for w in self.warnings:
            lines.append(f"warning: {w}")
        return "\n".join(lines)


def predict(cfg, sat_margin: float = 0.85,
            device: torch.device | str | None = None) -> EtcReport:
    """ETC prediction for one exposure of ``cfg`` (ObservationConfig).

    Runs the first planned exposure noise-free (Poisson, read noise and
    cosmic rays off; the deterministic sky, dark and flat kept) with the
    ideal source frame, on ``device`` (None: the CUDA card), and reduces
    it to charge and SNR statistics in float64 on the host.
    ``sat_margin``: warn above this fraction of full well.
    """
    from wayne_tpu_torch.config import NoiseFlags
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops.exposure import simulate_exposure
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.reduction import read_noise_var_e2

    obs = Observation(cfg, device=device)
    tables, static = obs.tables, obs.static
    flags = dataclasses.replace(
        NoiseFlags.none(), sky=True, dark=True, flat=cfg.noise.flat)
    det_cfg = dataclasses.replace(static, noise=flags, use_pallas=False,
                                  compute_ideal=True)
    scene0 = tree_map(lambda x: x[:1], obs.scenes)
    res = simulate_exposure(scene0, tables, det_cfg)
    gain = float(tables.gain)
    reads_e = res.reads_dn[0].cpu().numpy().astype(np.float64) * gain
    fw = float(tables.full_well_e)
    t = tables.read_times.cpu().numpy().astype(np.float64)

    peak = [float(r.max()) for r in reads_e]
    first_sat = next((k for k, p in enumerate(peak) if p >= fw), None)
    ideal = res.ideal_e[0].cpu().numpy().astype(np.float64)  # source only
    source_total = float(ideal.sum())

    # extraction window: columns above 5% of the peak column signal, rows
    # of the source footprint
    col_sig = ideal.sum(axis=0)
    cols = np.where(col_sig > 0.05 * col_sig.max())[0]
    row_sig = ideal.sum(axis=1)
    rows = np.where(row_sig > 0.02 * row_sig.max())[0]
    n_rows = max(len(rows), 1)
    bg_map = reads_e[-1] - ideal                           # sky+dark e-/px
    bg_px = float(np.median(bg_map[np.ix_(rows, cols)])) if len(cols) \
        else 0.0

    rn = float(tables.read_noise_e)
    nr = reads_e.shape[0]
    col_src = col_sig[cols]
    col_bg = bg_px * n_rows

    def snr(var_rn):
        var_col = col_src + col_bg + n_rows * var_rn
        white = float(col_src.sum()
                      / np.sqrt(var_col.sum())) if len(cols) else 0.0
        per_col = col_src / np.sqrt(var_col)
        return white, float(np.median(per_col)) if len(cols) else 0.0

    snr_cds, med_cds = snr(read_noise_var_e2(rn, nr))
    snr_ramp, _ = snr(read_noise_var_e2(rn, nr, ramp=True))

    exptime = float(t[-1])
    duty = exptime / (exptime + float(cfg.exposure_overhead_s))
    warnings: list[str] = []
    if first_sat is not None:
        warnings.append(
            f"read {first_sat} reaches full well — reduce NSAMP to "
            f"<= {max(first_sat - 1, 1)}, pick a shorter sample "
            "sequence, or raise the scan rate")
    elif peak[-1] > sat_margin * fw:
        warnings.append(
            f"peak charge is {100 * peak[-1] / fw:.0f}% of full well "
            f"(margin {100 * sat_margin:.0f}%) — hot pixels / pointing "
            "error may saturate")
    if not cfg.scan and peak[-1] > sat_margin * fw:
        warnings.append(
            "staring mode concentrates the trace on ~2 rows — consider "
            "spatial scanning for this brightness")
    if len(cols) == 0:
        warnings.append("no illuminated columns found — is the spectrum "
                        "on the detector?")
    return EtcReport(
        peak_e_per_read=peak, full_well_e=fw,
        peak_frac_full_well=peak[-1] / fw,
        first_saturating_read=first_sat,
        source_e_per_exposure=source_total,
        background_e_per_px=bg_px, exptime_s=exptime, duty_cycle=duty,
        snr_white_cds=snr_cds, snr_white_ramp=snr_ramp,
        snr_per_column_median=med_cds,
        n_illuminated_columns=int(len(cols)), warnings=warnings)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.etc",
        description="WFC3 IR grism exposure-time calculator (simulator-"
                    "exact: runs one noise-free exposure of the config; "
                    "PyTorch port of wayne_tpu)")
    parser.add_argument("-p", "--parameter-file", required=True)
    parser.add_argument("--sat-margin", type=float, default=0.85)
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    args = parser.parse_args(argv)
    from wayne_tpu_torch.config import load_yaml

    cfg = load_yaml(args.parameter_file)
    rep = predict(cfg, sat_margin=args.sat_margin,
                  device="cpu" if args.cpu else None)
    print(rep.summary())
    return 0 if rep.first_saturating_read is None else 2


if __name__ == "__main__":
    import sys

    sys.exit(main())

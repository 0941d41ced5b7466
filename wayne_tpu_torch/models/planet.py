"""Planet + orbit handling (reference: exodata system resolution +
transmission-spectrum file loading in wayne/observation.py).

The reference resolves named systems from the Open Exoplanet Catalogue via
the exodata package; with no catalog in this environment the same surface
is provided by explicit PlanetConfig parameters plus a tiny built-in table
of well-known benchmark systems (values from the published literature).
"""

from __future__ import annotations

import numpy as np

from wayne_tpu_torch.config import PlanetConfig
from wayne_tpu_torch.ops.kepler import OrbitParams
from wayne_tpu_torch.utils.spectra import interp_to_grid

# Built-in catalog of benchmark transiting systems (literature values):
# period [d], a/Rs, inc [deg], Rp/Rs, Teff [K], J mag of host.
KNOWN_SYSTEMS: dict[str, dict] = {
    "WASP-43 b": dict(period_days=0.813475, sma_over_rs=4.855,
                      inclination_deg=82.1, rp_over_rs=0.1595,
                      star_teff=4520.0, star_j=9.995),
    "HD 209458 b": dict(period_days=3.52474859, sma_over_rs=8.76,
                        inclination_deg=86.71, rp_over_rs=0.12086,
                        star_teff=6065.0, star_j=6.591),
    "GJ 1214 b": dict(period_days=1.58040464, sma_over_rs=14.85,
                      inclination_deg=89.1, rp_over_rs=0.1160,
                      star_teff=3026.0, star_j=9.750),
    "WASP-18 b": dict(period_days=0.94145299, sma_over_rs=3.57,
                      inclination_deg=84.9, rp_over_rs=0.0958,
                      star_teff=6400.0, star_j=8.413),
    "HD 189733 b": dict(period_days=2.21857567, sma_over_rs=8.84,
                        inclination_deg=85.71, rp_over_rs=0.1566,
                        star_teff=5040.0, star_j=6.07),
    "GJ 436 b": dict(period_days=2.64389803, sma_over_rs=14.54,
                     inclination_deg=86.86, rp_over_rs=0.0822,
                     star_teff=3416.0, star_j=6.90),
    "WASP-12 b": dict(period_days=1.0914203, sma_over_rs=3.039,
                      inclination_deg=83.37, rp_over_rs=0.1175,
                      star_teff=6300.0, star_j=10.477),
    "WASP-121 b": dict(period_days=1.2749255, sma_over_rs=3.86,
                       inclination_deg=87.6, rp_over_rs=0.1217,
                       star_teff=6460.0, star_j=9.625),
    "HAT-P-11 b": dict(period_days=4.8878162, sma_over_rs=15.58,
                       inclination_deg=88.99, rp_over_rs=0.0576,
                       star_teff=4780.0, star_j=7.608),
    "WASP-39 b": dict(period_days=4.0552941, sma_over_rs=11.37,
                      inclination_deg=87.83, rp_over_rs=0.1457,
                      star_teff=5400.0, star_j=10.663),
}


# Fields a catalog entry may carry (all optional except the orbit basics).
CATALOG_FIELDS = ("period_days", "t0_mjd", "sma_over_rs", "inclination_deg",
                  "eccentricity", "periastron_deg", "rp_over_rs",
                  "eclipse_depth", "star_teff", "star_j", "star_radius_rsun")


def load_catalog(path: str) -> dict[str, dict]:
    """Load a file-based system catalog (exodata's OEC-file equivalent).

    Accepts JSON (``{"NAME": {"period_days": ..., ...}, ...}``) or CSV
    with a header row whose first column is ``name`` and remaining
    columns are any of :data:`CATALOG_FIELDS`. Pure: returns the entries
    (``{name: {field: value}}``) without touching any process state —
    pass them to :func:`resolve_system` as ``catalog=`` so one config's
    catalog can never leak into the next config loaded in the same
    process.
    """
    entries: dict[str, dict] = {}
    if path.endswith(".json"):
        import json

        with open(path) as fh:
            entries = json.load(fh)
        if not isinstance(entries, dict):
            raise ValueError(f"catalog {path!r} must be a JSON object")
    else:
        import csv

        with open(path) as fh:
            for row in csv.DictReader(fh):
                name = (row.pop("name", None) or "").strip()
                if not name:
                    raise ValueError(f"catalog {path!r} rows need a 'name'")
                entries[name] = {k: float(v) for k, v in row.items()
                                 if v not in ("", None)}
    out: dict[str, dict] = {}
    for name, vals in entries.items():
        unknown = set(vals) - set(CATALOG_FIELDS)
        if unknown:
            raise ValueError(
                f"catalog entry {name!r} has unknown fields {sorted(unknown)}"
                f"; allowed: {CATALOG_FIELDS}")
        out[name.strip()] = {k: float(v) for k, v in vals.items()}
    return out


def resolve_system(name: str, catalog: dict[str, dict] | None = None) -> dict:
    """Catalog lookup by name (exodata-equivalent seam).

    A user ``catalog`` (the dict :func:`load_catalog` returns) takes
    precedence over the built-in benchmark table.
    """
    key = name.strip()
    # return a COPY: callers merging/mutating the result must never
    # corrupt the module-level catalog for later visits in the process
    if catalog and key in catalog:
        return dict(catalog[key])
    if key in KNOWN_SYSTEMS:
        return dict(KNOWN_SYSTEMS[key])
    raise KeyError(
        f"unknown system {name!r}; provide explicit PlanetConfig parameters, "
        f"a catalog_file, or one of {sorted(KNOWN_SYSTEMS)}")


def _load_two_col(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(wavelength_um ascending, values) from a two-column text file.

    Accepts Angstrom input (wavelengths > 100 -> 1e-4 scale) and ANY
    row order — frequency-tabulated library files come descending, and
    unsorted input silently breaks interp/rebin's ascending assumption.
    """
    data = np.loadtxt(path)
    if data.ndim != 2 or data.shape[1] < 2:
        raise ValueError(f"{path!r} needs two columns: wavelength, value")
    wl = data[:, 0] * (1e-4 if data[:, 0].max() > 100.0 else 1.0)
    order = np.argsort(wl)
    return wl[order], data[order, 1]


class Planet:
    """Host-side planet: orbit params + transmission spectrum on the grid."""

    def __init__(self, cfg: PlanetConfig, visit_start_mjd: float = 0.0):
        self.cfg = cfg
        self.visit_start_mjd = visit_start_mjd
        if cfg.spectrum_file:
            wl, rp = _load_two_col(cfg.spectrum_file)
            if np.median(rp) > 1.0:      # given as depth in (Rp/Rs)^2 ppm?
                raise ValueError("planet spectrum must be Rp/Rs (got values > 1)")
            self._wl, self._rp = wl, rp
        else:
            self._wl = None
            self._rp = None
        # parse the optional eclipse/LD files ONCE, like spectrum_file:
        # per-call np.loadtxt repeated file I/O and deferred a missing/
        # corrupt file to deep inside scene construction
        self._fp_tab = None
        if cfg.eclipse_file:
            wl, fp = _load_two_col(cfg.eclipse_file)
            if np.max(np.abs(fp)) > 0.5:
                # ppm/percent units would silently make the eclipse
                # outshine the star (the rp path has the same guard)
                raise ValueError(
                    "eclipse_file must give FRACTIONAL Fp/Fs (got values "
                    f"up to {np.max(np.abs(fp)):g}; ppm input?)")
            self._fp_tab = (wl, fp)
        self._ld_tab = None
        if cfg.ld_file:
            data = np.loadtxt(cfg.ld_file)
            if data.ndim != 2 or data.shape[1] < 5:
                raise ValueError("ld_file needs 5 columns: wavelength, c1..c4")
            wl = data[:, 0] * (1e-4 if data[:, 0].max() > 100.0 else 1.0)
            order = np.argsort(wl)
            self._ld_tab = (wl[order], data[order, 1:5])

    def rp_on_grid(self, wl_centers: np.ndarray) -> np.ndarray:
        if self._wl is None:
            return np.full(np.asarray(wl_centers).shape, self.cfg.rp_over_rs)
        return interp_to_grid(self._wl, self._rp, np.asarray(wl_centers))

    def fp_on_grid(self, wl_centers: np.ndarray) -> np.ndarray:
        """Dayside emission contrast Fp/Fs per channel (secondary-eclipse
        depth). Zero unless eclipse_depth / eclipse_file is configured —
        beyond the reference, which models transits only."""
        if self._fp_tab is not None:
            return interp_to_grid(self._fp_tab[0], self._fp_tab[1],
                                  np.asarray(wl_centers))
        return np.full(np.asarray(wl_centers).shape,
                       float(self.cfg.eclipse_depth))

    def ld_on_grid(self, wl_centers: np.ndarray) -> np.ndarray:
        """Claret coefficients: (4,) scalar set, or (NL, 4) when an
        ld_file (clablimb-style table: micron, c1..c4) is configured."""
        if self._ld_tab is None:
            return np.asarray(self.cfg.ld_coeffs, np.float64)
        wl, coeffs = self._ld_tab
        wl_c = np.asarray(wl_centers)
        return np.stack([interp_to_grid(wl, coeffs[:, i], wl_c)
                         for i in range(4)], axis=1)

    def orbit_params(self) -> OrbitParams:
        """OrbitParams on the visit clock (seconds since visit start)."""
        t0_s = (self.cfg.t0_mjd - self.visit_start_mjd) * 86400.0
        return OrbitParams.create(
            period_s=self.cfg.period_days * 86400.0,
            t0_s=t0_s,
            sma_rs=self.cfg.sma_over_rs,
            inc_rad=np.deg2rad(self.cfg.inclination_deg),
            ecc=self.cfg.eccentricity,
            omega_rad=np.deg2rad(self.cfg.periastron_deg),
        )

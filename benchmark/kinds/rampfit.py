"""Traffic kind ``rampfit``: fitting one visit's light curves as
``run_reduce --detrend ramp`` does: the program's ``fit_white_ramp``, then
``ramp_detrend`` of the channel curves by its template, then
``fit_depths``.

The light curves are made here, in set-up, from the seed: at the visit's
exposure mid-times (frozen in the file the configuration's ``midtimes``
names), the
configured planet's transit (Rp/Rs drawn about the configured value, a
per-channel spectrum about it), times the Iraclis ramp (parameters drawn
from the traffic's ranges), times a normalisation, plus white noise. The
requests cycle through ``realisations`` such visits; the program and the
reference get the same float32 arrays.

The check: every completed request's fitted numbers against the
reference's fit of the same arrays in float64: the white fit's six
parameters and each channel's Rp/Rs, in units of the reference's own
1-sigma.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark.harness.registry import ROOT
from benchmark.reference import fits as ref


def _draw(rng, lo_hi):
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi))


def make_visits(params: dict, traffic: dict, seed: int, t_mid: np.ndarray,
                orbit: ref.Orbit) -> list[dict]:
    """``realisations`` visits of white and channel curves (float32)."""
    rng = np.random.default_rng([seed % 2 ** 64, 7])
    rp0 = float(params["planet"]["rp_over_rs"])
    ld = torch.tensor(params["planet"]["ld_coeffs"], dtype=torch.float64)
    t = torch.as_tensor(t_mid, dtype=torch.float64)
    z, front = ref.separation(t, orbit)
    t_orb, first = ref.orbit_clock(t)
    t_day = (t - t.mean()) / 86400.0
    n_chan = int(traffic["n_chan"])
    out = []
    for _ in range(int(traffic["realisations"])):
        rp_w = rp0 + traffic["rp_sigma"] * rng.standard_normal()
        rp_c = (rp_w + traffic["spectrum_amp"]
                * np.sin(np.linspace(0, 2 * np.pi, n_chan)
                         + rng.uniform(0, 2 * np.pi))
                + traffic["rp_sigma"] * rng.standard_normal(n_chan))
        ra = _draw(rng, traffic["slope_per_day"])
        rb = _draw(rng, traffic["hook_amp"])
        rbf = rb * _draw(rng, traffic["first_orbit_factor"])
        tau = _draw(rng, traffic["hook_tau_s"])
        ramp = ((1 - ra * t_day)
                * (1 - torch.where(first, rbf, rb) * torch.exp(-t_orb / tau)))

        def transit(rp):
            f = ref.transit_flux(z, torch.as_tensor(rp, dtype=torch.float64),
                                 ld, 64)
            return 1 - (1 - f) * front

        c = _draw(rng, traffic["norm"])
        white = (c * ramp * transit(rp_w)
                 + traffic["white_noise"] * c
                 * torch.as_tensor(rng.standard_normal(len(t))))
        chan = torch.stack([
            c * ramp * transit(float(r))
            + traffic["channel_noise"] * c
            * torch.as_tensor(rng.standard_normal(len(t)))
            for r in rp_c], dim=1)
        out.append({"white": white.numpy().astype(np.float32),
                    "channels": chan.numpy().astype(np.float32)})
    return out


def orbit_of(params: dict, visit_start_mjd: float) -> ref.Orbit:
    """The planet's orbit on the visit clock, each element rounded to
    float32 as both sides take it."""
    p = params["planet"]
    f32 = lambda v: float(np.float32(v))
    return ref.Orbit(
        period_s=f32(p["period"] * 86400.0),
        t0_s=f32((p["t0"] - visit_start_mjd) * 86400.0),
        sma_rs=f32(p["sma_over_rs"]),
        inc_rad=f32(np.deg2rad(p["inclination"])),
        ecc=f32(p.get("eccentricity", 0.0)),
        omega_rad=f32(np.deg2rad(p.get("periastron", 90.0))))


class RampFit:
    def __init__(self, config: dict, traffic: dict, seed: int, devices):
        import json

        from wayne_tpu_torch.ops.kepler import OrbitParams
        from wayne_tpu_torch.reduction import (
            fit_depths, fit_white_ramp, ramp_detrend,
        )

        self.params = params = config["parameters"]
        self.traffic, self.seed = traffic, seed
        self.device = devices[0]
        self.trace_requests = int(traffic["trace_requests"])
        with open(os.path.join(ROOT, config["midtimes"])) as fh:
            frozen = json.load(fh)
        self.t_mid = np.asarray(frozen["exp_mid_s"], np.float32)
        self.orbit = orbit_of(params, frozen["visit_start_mjd"])
        self.visits = make_visits(params, traffic, seed,
                                  self.t_mid.astype(np.float64), self.orbit)
        self.ld = np.asarray(params["planet"]["ld_coeffs"], np.float32)
        self.rp0 = float(params["planet"]["rp_over_rs"])
        dev = self.device
        o = self.orbit
        self._orbit = OrbitParams.create(o.period_s, o.t0_s, o.sma_rs,
                                         o.inc_rad, o.ecc, o.omega_rad,
                                         device=dev)
        self._t = torch.as_tensor(self.t_mid, device=dev)
        self._ld = torch.as_tensor(self.ld, device=dev)
        self._in = [(torch.as_tensor(v["white"], device=dev),
                     torch.as_tensor(v["channels"], device=dev))
                    for v in self.visits]
        self._fns = (fit_white_ramp, ramp_detrend, fit_depths)
        self.outputs: list[torch.Tensor] = []
        for k in range(int(traffic["warmup_requests"])):
            self._fit(k % len(self._in))

    def _fit(self, r: int) -> torch.Tensor:
        fit_white_ramp, ramp_detrend, fit_depths = self._fns
        white, chan = self._in[r]
        w = fit_white_ramp(white, self._t, self._orbit, self._ld, self.rp0,
                           n_iter=int(self.traffic["n_lm"]))
        detrended = ramp_detrend(chan, w, self._t, self._orbit)
        rp, sig = fit_depths(detrended, self._t, self._orbit, self._ld,
                             self.rp0)
        out = torch.cat([torch.stack([w.c, w.rp, w.slope_per_day, w.hook_amp,
                                      w.hook_amp_first, w.hook_tau_s]),
                         rp, sig])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def request(self, i: int) -> dict:
        self.outputs.append(self._fit(i % len(self._in)))
        return {"fits": 1}

    def release(self) -> None:
        self._in = None

    def reference(self, dtype=torch.float64) -> list:
        return [ref.fit_visit(v["white"], v["channels"], self.t_mid,
                              self.orbit, self.ld, self.rp0, dtype=dtype,
                              n_lm=int(self.traffic["n_lm"]))
                for v in self.visits]

    def check(self, n_done: int) -> list[dict]:
        refs = self.reference()
        got = [self.outputs[i].double().cpu() for i in range(n_done)]
        fitted = [(g[:6], g[6:6 + refs[0].depth.shape[0]]) for g in got]
        return gaps(fitted, refs, self.traffic["limits"])


def gaps(fitted, refs, limits) -> list[dict]:
    """The widest gaps of fitted (white six, channel depths) pairs, the
    i-th against ``refs[i % len(refs)]``, in units of its 1-sigma."""
    white_gap = depth_gap = 0.0
    for i, (white, depth) in enumerate(fitted):
        f = refs[i % len(refs)]
        white_gap = _worse(white_gap, float(
            ((white - f.white).abs() / f.white_sigma).max()))
        depth_gap = _worse(depth_gap, float(
            ((depth - f.depth).abs() / f.depth_sigma).max()))
    return [{"name": "white_gap", "value": white_gap,
             "limit": float(limits["white_gap"])},
            {"name": "depth_gap", "value": depth_gap,
             "limit": float(limits["depth_gap"])}]


def _worse(a: float, b: float) -> float:
    return math.inf if math.isnan(b) else max(a, b)


def control(config: dict, traffic: dict, seed: int, device) -> list[dict]:
    """The control's reading: the reference's fit with the model evaluated
    in bfloat16, against the reference's float64 fit, on every
    realisation."""
    state = RampFit(config, dict(traffic, warmup_requests=0), seed,
                    [torch.device("cpu")])
    refs = state.reference()
    low = state.reference(torch.bfloat16)
    return gaps([(f.white, f.depth) for f in low], refs, traffic["limits"])


def setup(config: dict, traffic: dict, seed: int, devices) -> RampFit:
    return RampFit(config, traffic, seed, devices)

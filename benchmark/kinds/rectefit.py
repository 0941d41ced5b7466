"""Traffic kind ``rectefit``: fitting one visit's light curves as
``run_reduce --detrend recte`` does: the program's ``fit_white_recte``
(the physical two-population RECTE ramp of Zhou et al. 2017 times the
transit, by a fixed-step Levenberg-Marquardt), then ``ramp_detrend`` of
the channel curves by its fitted systematic, then ``fit_depths``.

The light curves are made here, in set-up, from the seed, by the
reference's RECTE in float64: at the visit's exposure mid-times and
exposure time (frozen in the file the configuration's ``midtimes``
names), the configured planet's transit (Rp/Rs drawn about the configured
value, a per-channel spectrum about it), times the trap ramp at the
configuration's illuminated rate (``white_rate_e_s``) times a drawn rate
scale, from drawn initial fills of the two populations, times a slope and
a normalisation, plus white noise. Every channel carries the white
curve's systematic, as ``ramp_detrend`` assumes. The requests cycle
through ``realisations`` such visits; the program and the reference get
the same float32 arrays.

The check: every completed request's fitted numbers against the
reference's fit of the same arrays in float64: the white fit's six
numbers (c, Rp/Rs, slope, the two fills, the rate scale) and each
channel's Rp/Rs, in units of the reference's own 1-sigma
(``rampfit.gaps``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark.harness.registry import ROOT
from benchmark.kinds.rampfit import gaps, orbit_of
from benchmark.reference import fits as ref
from benchmark.reference import recte as rec


def make_visits(params: dict, traffic: dict, seed: int, t_mid: np.ndarray,
                exptime_s: float, orbit: ref.Orbit, rate_e_s: float,
                traps: rec.Traps) -> list[dict]:
    """``realisations`` visits of white and channel curves (float32)."""
    rng = np.random.default_rng([seed % 2 ** 64, 21])
    draw = lambda key: float(rng.uniform(*traffic[key]))
    rp0 = float(params["planet"]["rp_over_rs"])
    ld = torch.tensor(params["planet"]["ld_coeffs"], dtype=torch.float64)
    t = torch.as_tensor(t_mid, dtype=torch.float64)
    z, front = ref.separation(t, orbit)
    t_day = (t - t.mean()) / 86400.0
    n_chan = int(traffic["n_chan"])

    def transit(rp):
        f = ref.transit_flux(z, torch.as_tensor(rp, dtype=torch.float64), ld,
                             64)
        return 1 - (1 - f) * front

    out = []
    for _ in range(int(traffic["realisations"])):
        rp_w = rp0 + traffic["rp_sigma"] * rng.standard_normal()
        rp_c = (rp_w + traffic["spectrum_amp"]
                * np.sin(np.linspace(0, 2 * np.pi, n_chan)
                         + rng.uniform(0, 2 * np.pi))
                + traffic["rp_sigma"] * rng.standard_normal(n_chan))
        ra = draw("slope_per_day")
        ramp = rec.white_ramp(rate_e_s * draw("rate_scale"),
                              t - 0.5 * exptime_s, exptime_s, traps,
                              draw("f0_s"), draw("f0_f"))
        sys = (1 - ra * t_day) * ramp
        c = draw("norm")
        white = (c * sys * transit(rp_w) + traffic["white_noise"] * c
                 * torch.as_tensor(rng.standard_normal(len(t))))
        chan = torch.stack([
            c * sys * transit(float(r)) + traffic["channel_noise"] * c
            * torch.as_tensor(rng.standard_normal(len(t)))
            for r in rp_c], dim=1)
        out.append({"white": white.numpy().astype(np.float32),
                    "channels": chan.numpy().astype(np.float32)})
    return out


class RecteFit:
    def __init__(self, config: dict, traffic: dict, seed: int, devices):
        from wayne_tpu_torch.ops.kepler import OrbitParams

        params = config["parameters"]
        self.traffic = traffic
        self.device = dev = devices[0]
        self.trace_requests = int(traffic["trace_requests"])
        with open(os.path.join(ROOT, config["midtimes"])) as fh:
            frozen = json.load(fh)
        self.t_mid = np.asarray(frozen["exp_mid_s"], np.float32)
        self.exptime = float(frozen["exptime_s"])
        self.orbit = o = orbit_of(params, frozen["visit_start_mjd"])
        self.rate = float(config["white_rate_e_s"])
        self.traps = rec.Traps(**config["traps"])
        self.visits = make_visits(params, traffic, seed,
                                  self.t_mid.astype(np.float64), self.exptime,
                                  self.orbit, self.rate, self.traps)
        self.ld = np.asarray(params["planet"]["ld_coeffs"], np.float32)
        self.rp0 = float(params["planet"]["rp_over_rs"])
        self._orbit = OrbitParams.create(o.period_s, o.t0_s, o.sma_rs,
                                         o.inc_rad, o.ecc, o.omega_rad,
                                         device=dev)
        self._t = torch.as_tensor(self.t_mid, device=dev)
        self._ld = torch.as_tensor(self.ld, device=dev)
        # run_reduce hands the fits Rp/Rs as a float32 tensor on the card
        self._rp0 = torch.tensor(self.rp0, dtype=torch.float32, device=dev)
        self._in = [(torch.as_tensor(v["white"], device=dev),
                     torch.as_tensor(v["channels"], device=dev))
                    for v in self.visits]
        self.outputs: list[torch.Tensor] = []
        for k in range(int(traffic["warmup_requests"])):
            self._fit(k % len(self._in))

    def _fit(self, r: int) -> torch.Tensor:
        # looked up on the module at each call, so that the traced
        # window's spans (harness/frames.py) wrap them
        from wayne_tpu_torch import reduction

        white, chan = self._in[r]
        w = reduction.fit_white_recte(
            white, self._t, self._orbit, self._ld, self._rp0,
            rate_e_s=self.rate, exptime_s=self.exptime,
            n_iter=int(self.traffic["n_lm"]))
        detrended = reduction.ramp_detrend(chan, w, self._t, self._orbit)
        rp, sig = reduction.fit_depths(detrended, self._t, self._orbit,
                                       self._ld, self._rp0)
        out = torch.cat([torch.stack([w.c, w.rp, w.slope_per_day, w.f0_s,
                                      w.f0_f, w.rate_scale]), rp, sig])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def request(self, i: int) -> dict:
        self.outputs.append(self._fit(i % len(self._in)))
        return {"fits": 1}

    def release(self) -> None:
        self._in = None

    def reference(self, n: int, dtype=torch.float64) -> list:
        """The reference's fits of the first ``n`` realisations."""
        return [rec.fit_recte_visit(
            v["white"], v["channels"], self.t_mid, self.exptime, self.orbit,
            self.ld, self.rp0, self.rate, int(self.traffic["n_lm"]),
            traps=self.traps, dtype=dtype) for v in self.visits[:n]]

    def check(self, n_done: int) -> list[dict]:
        refs = self.reference(min(n_done, len(self.visits)))
        got = [self.outputs[i].double().cpu() for i in range(n_done)]
        fitted = [(g[:6], g[6:6 + refs[0].depth.shape[0]]) for g in got]
        return gaps(fitted, refs, self.traffic["limits"])


def control(config: dict, traffic: dict, seed: int, device) -> list[dict]:
    """The control's reading: the reference's fit with the model evaluated
    in bfloat16, against the reference's float64 fit, on every
    realisation."""
    state = RecteFit(config, dict(traffic, warmup_requests=0), seed,
                     [torch.device("cpu")])
    n = len(state.visits)
    refs = state.reference(n)
    low = state.reference(n, torch.bfloat16)
    return gaps([(f.white, f.depth) for f in low], refs, traffic["limits"])


def setup(config: dict, traffic: dict, seed: int, devices) -> RecteFit:
    return RecteFit(config, traffic, seed, devices)

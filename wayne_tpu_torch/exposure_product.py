"""Reference-style Exposure product object (port of the JAX package's
``exposure_product``; reference: wayne/exposure.py :: Exposure.add_read /
generate_fits).

The readout produces whole read stacks at once, but downstream code
written against the reference's API can keep using the incremental
Exposure object: accumulate reads (time order), then emit the ima-style
FITS product. A thin host-side shim over wayne_tpu_torch.io.ima.write_ima
(the native writer).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from wayne_tpu_torch.io.ima import default_primary_header, write_ima


class Exposure:
    """Incremental multi-read exposure product."""

    def __init__(self, *, targname: str = "target", grism: str = "G141",
                 samp_seq: str = "SPARS10", subarray: int = 512,
                 expstart_mjd: float = 0.0, scan: bool = True,
                 scan_rate_pix_s: float = 0.0, gain: float = 2.5,
                 read_noise_e: float = 20.0,
                 header_extra: Mapping[str, Any] | None = None):
        self.meta = dict(targname=targname, grism=grism, samp_seq=samp_seq,
                         subarray=subarray, expstart_mjd=expstart_mjd,
                         scan=scan, scan_rate_pix_s=scan_rate_pix_s)
        self.gain = gain
        self.read_noise_e = read_noise_e
        self.header_extra = dict(header_extra or {})
        self._reads: list[np.ndarray] = []
        self._times: list[float] = []
        self._dq: list[np.ndarray | None] = []

    def add_read(self, data_dn: np.ndarray, time_s: float,
                 dq: np.ndarray | None = None) -> None:
        """Append one read (TIME order; reference: Exposure.add_read)."""
        data_dn = np.asarray(data_dn, np.float32)
        if self._reads and data_dn.shape != self._reads[0].shape:
            raise ValueError("read shape mismatch")
        s = int(self.meta["subarray"])
        if not self._reads and data_dn.shape != (s, s):
            # the SUBARRAY header keyword must match the data geometry,
            # or downstream tooling mis-registers the frames
            raise ValueError(
                f"read shape {data_dn.shape} does not match the "
                f"product's subarray={s}")
        if self._times and time_s <= self._times[-1]:
            raise ValueError("reads must be added in increasing time order")
        self._reads.append(data_dn)
        self._times.append(float(time_s))
        self._dq.append(None if dq is None else np.asarray(dq, np.int16))

    @property
    def nsamp(self) -> int:
        return max(len(self._reads) - 1, 0)

    def generate_fits(self, path: str) -> str:
        """Write the ima-style product (reference: Exposure.generate_fits)."""
        if len(self._reads) < 2:
            raise ValueError("need at least the zeroth read plus one sample")
        reads = np.stack(self._reads)
        times = np.asarray(self._times)
        dq = None
        if any(d is not None for d in self._dq):
            dq = np.stack([
                d if d is not None else np.zeros(reads.shape[1:], np.int16)
                for d in self._dq])
        primary = default_primary_header(
            targname=self.meta["targname"], grism=self.meta["grism"],
            nsamp=self.nsamp, samp_seq=self.meta["samp_seq"],
            subarray=self.meta["subarray"],
            expstart_mjd=self.meta["expstart_mjd"],
            exptime_s=float(times[-1]), scan=self.meta["scan"],
            scan_rate_pix_s=self.meta["scan_rate_pix_s"],
            extra=self.header_extra)
        write_ima(path, reads, times, primary, dq=dq, gain=self.gain,
                  read_noise_e=self.read_noise_e)
        return path

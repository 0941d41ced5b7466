"""The port's native ima writer (wayne_tpu_torch/native/fitsio.cpp, built
with g++ at first use) against its Python writer and against the JAX
package's ``write_ima(use_native=True)`` file on the same inputs: every
non-ERR HDU identical, ERR to rtol 1e-6 (the writers round the shot term
in another order); the routing of ``write_ima``; no silent fallback."""

import os

import numpy as np
import pytest

from wayne_tpu.exposure_product import Exposure as Exposure_j
from wayne_tpu.io.ima import write_ima as write_ima_j
from wayne_tpu_torch.exposure_product import Exposure
from wayne_tpu_torch.io import native
from wayne_tpu_torch.io.fits import read_fits
from wayne_tpu_torch.io.ima import (
    DQ_COSMIC_RAY, DQ_SATURATED, default_primary_header, read_ima, write_ima,
)


def _inputs(nr=4, s=48):
    rng = np.random.RandomState(9)
    reads = np.cumsum(rng.uniform(0, 400, (nr, s, s)), axis=0).astype(
        np.float32) + 1000.0
    times = np.array([0.0, 0.853, 7.98, 15.1, 22.3][:nr])
    dq = np.zeros((nr, s, s), np.int16)
    dq[2:, 4, 9] = DQ_COSMIC_RAY
    dq[-1, rng.rand(s, s) < 0.02] |= DQ_SATURATED
    gain_map = (2.5 * (1 + 0.01 * rng.standard_normal((s, s)))).astype(
        np.float32)
    bias_e = (2500.0 + 12.0 * rng.standard_normal((s, s))).astype(np.float32)
    return reads, times, dq, gain_map, bias_e


def _primary(nr):
    return default_primary_header(
        targname="T", grism="G141", nsamp=nr - 1, samp_seq="SPARS10",
        subarray=48, expstart_mjd=56000.25, exptime_s=22.3, scan=True,
        scan_rate_pix_s=-1.1, extra={"SIMSEED": 3})


def assert_same_ima(a_path, b_path):
    a, b = read_fits(a_path), read_fits(b_path)
    assert len(a) == len(b)
    for (ha, da), (hb, db) in zip(a, b):
        assert ha == hb
        if da is None:
            assert db is None
        elif ha.get("EXTNAME") == "ERR":
            np.testing.assert_allclose(da, db, rtol=1e-6)
        else:
            assert da.dtype == db.dtype
            np.testing.assert_array_equal(da, db)


@pytest.mark.parametrize("maps", [False, True])
@pytest.mark.parametrize("with_dq", [False, True])
def test_native_matches_python_and_jax(tmp_path, maps, with_dq):
    reads, times, dq, gain_map, bias_e = _inputs()
    kw = dict(gain=2.5, read_noise_e=20.0, bias_pedestal_e=2500.0,
              dq=dq if with_dq else None,
              gain_map=gain_map if maps else None,
              bias_e_map=bias_e if maps else None)
    paths = {k: str(tmp_path / f"{k}.fits") for k in ("nat", "py", "jax")}
    write_ima(paths["nat"], reads, times, _primary(4), **kw)
    write_ima(paths["py"], reads, times, _primary(4), use_native=False, **kw)
    write_ima_j(paths["jax"], reads, times, _primary(4), use_native=True,
                **kw)
    assert_same_ima(paths["nat"], paths["py"])
    assert_same_ima(paths["nat"], paths["jax"])
    # beyond ERR the bytes are the JAX package's
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert len(raw["nat"]) == len(raw["py"]) == len(raw["jax"])
    hdr, got, t, got_dq = read_ima(paths["nat"], with_dq=True)
    np.testing.assert_array_equal(got, reads)
    np.testing.assert_array_equal(t, times)
    assert hdr["NSAMP"] == 4
    np.testing.assert_array_equal(got_dq, dq if with_dq else 0 * dq)


@pytest.mark.parametrize("kw", [dict(units="e_per_s"),
                                dict(err=np.full((4, 48, 48), 3.0,
                                                 np.float32))])
def test_rate_products_and_explicit_err_take_the_python_writer(tmp_path, kw):
    reads, times, dq, _, _ = _inputs()
    a, b = str(tmp_path / "a.fits"), str(tmp_path / "b.fits")
    write_ima(a, reads, times, _primary(4), dq=dq, **kw)
    write_ima(b, reads, times, _primary(4), dq=dq, use_native=False, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_no_silent_fallback_when_the_library_cannot_build(tmp_path,
                                                          monkeypatch):
    """Without g++ (and no library built for this source) write_ima raises
    naming g++ and writes nothing; use_native=False still writes. A
    library that does not load raises too."""
    reads, times, _, _, _ = _inputs()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    path = tmp_path / "x.fits"
    with pytest.raises(native.NativeWriterError, match="g\\+\\+"):
        write_ima(str(path), reads, times, _primary(4))
    assert not path.exists()
    write_ima(str(path), reads, times, _primary(4), use_native=False)
    assert path.exists()
    os.makedirs(tmp_path / "build")
    with open(native.library_path(), "wb") as fh:
        fh.write(b"not a shared library")
    with pytest.raises(native.NativeWriterError, match="g\\+\\+"):
        write_ima(str(tmp_path / "y.fits"), reads, times, _primary(4))


def test_library_is_built_once_per_source(tmp_path, monkeypatch):
    """The library's name hashes the source and the flags; a build puts
    it in the build directory and a second load reuses it."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    path = native.build()
    assert path == native.library_path() and os.path.exists(path)
    assert os.path.basename(path).startswith("libwaynefits-")
    mtime = os.stat(path).st_mtime_ns
    assert native.build() == path and os.stat(path).st_mtime_ns == mtime
    assert int(native.load(path).wayne_abi_version()) == native._ABI_VERSION
    assert "-march=native" not in native.CXX_FLAGS
    assert "-ffp-contract=off" in native.CXX_FLAGS


def test_exposure_product_matches_jax(tmp_path):
    """The reference-style Exposure (add_read, generate_fits) writes the
    JAX package's Exposure's file."""
    files = []
    for cls in (Exposure, Exposure_j):
        exp = cls(targname="X", grism="G141", samp_seq="SPARS10",
                  subarray=32, expstart_mjd=56000.0, scan=True,
                  scan_rate_pix_s=0.5)
        frame = np.zeros((32, 32), np.float32)
        exp.add_read(frame, 0.0)
        r = np.random.RandomState(1)
        for k in range(1, 4):
            frame = frame + r.uniform(0, 50, (32, 32)).astype(np.float32)
            dq = np.full((32, 32), k, np.int16) if k == 2 else None
            exp.add_read(frame, 0.1 + 10.0 * k, dq=dq)
        assert exp.nsamp == 3
        files.append(exp.generate_fits(str(tmp_path / f"{cls.__module__}"
                                                      "_ima.fits")))
    assert_same_ima(*files)
    with pytest.raises(ValueError, match="increasing time"):
        exp = Exposure(subarray=32)
        exp.add_read(np.zeros((32, 32)), 1.0)
        exp.add_read(np.zeros((32, 32)), 0.5)
    with pytest.raises(ValueError, match="subarray"):
        Exposure(subarray=32).add_read(np.zeros((16, 16)), 0.0)

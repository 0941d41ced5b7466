"""ctypes binding to the port's native FITS backend
(``wayne_tpu_torch/native/fitsio.cpp``, after the JAX package's
``io/native.py``, the same C ABI and ABI tag).

The library is built at first use with ``g++ -O3 -fPIC -std=c++17
-ffp-contract=off`` into ``wayne_tpu_torch/build/`` (named by a hash of
the source and the flags, built in a temporary file and renamed, so
concurrent builders are safe). There is no silent fallback: a library
that cannot be built or loaded raises, and only ``write_ima(...,
use_native=False)`` takes the Python writer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "fitsio.cpp")
_BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared"]
# Bump together with wayne_abi_version() in native/fitsio.cpp whenever the
# wayne_write_ima signature changes.
_ABI_VERSION = 3

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeWriterError(RuntimeError):
    """The native FITS library could not be built, loaded or run."""


def library_path() -> str:
    """Where the library for the current source and flags is (or will
    be)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(_BUILD_DIR,
                        f"libwaynefits-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library with g++ unless this source is already built
    so; returns its path. Raises NativeWriterError naming g++ on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeWriterError(
            "g++ not found: the native ima writer is built from "
            "wayne_tpu_torch/native/fitsio.cpp at first use (or pass "
            "use_native=False to write_ima)")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([gxx, *CXX_FLAGS, "-o", lib, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeWriterError(
                f"g++ failed ({proc.returncode}) building the native ima "
                f"writer:\n{proc.stderr}")
        os.replace(lib, out)
    return out


def load(path: str) -> ctypes.CDLL:
    """Open a built library, check its ABI tag and declare the writer's
    signature."""
    try:
        lib = ctypes.CDLL(path)
        version = int(lib.wayne_abi_version())
    except (OSError, AttributeError) as exc:
        raise NativeWriterError(
            f"cannot load the native ima writer {path!r} (built by g++ "
            f"from wayne_tpu_torch/native/fitsio.cpp): {exc}") from exc
    if version != _ABI_VERSION:
        raise NativeWriterError(
            f"native ima writer {path!r} has ABI {version}, expected "
            f"{_ABI_VERSION}: rebuild it with g++")
    lib.wayne_write_ima.restype = ctypes.c_int
    lib.wayne_write_ima.argtypes = [
        ctypes.c_char_p,                      # path
        ctypes.c_char_p, ctypes.c_long,       # primary header
        ctypes.POINTER(ctypes.c_char_p),      # extension headers
        ctypes.POINTER(ctypes.c_long),        # their lengths
        ctypes.POINTER(ctypes.c_float),       # reads
        ctypes.POINTER(ctypes.c_int16),       # dq planes (nullable)
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),      # read times
        ctypes.c_float, ctypes.c_float,       # gain, read noise
        ctypes.c_float,                       # bias pedestal (DN)
        ctypes.POINTER(ctypes.c_float),       # gain map (nullable)
        ctypes.POINTER(ctypes.c_float),       # bias e- map (nullable)
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """The native library, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def native_available() -> bool:
    """Whether the native writer builds and loads here."""
    try:
        get_lib()
    except NativeWriterError:
        return False
    return True


def write_ima_native(path: str, reads_dn: np.ndarray, read_times: np.ndarray,
                     primary_bytes: bytes, ext_header_bytes: list[bytes],
                     gain: float, read_noise_e: float,
                     dq: np.ndarray | None = None, bias_dn: float = 0.0,
                     gain_map: np.ndarray | None = None,
                     bias_e_map: np.ndarray | None = None) -> None:
    """Write one ima file through the native backend; raises on failure.

    ``gain_map`` / ``bias_e_map``: optional (h, w) per-pixel planes the
    default ERR propagates through instead of the scalar gain / mean bias
    pedestal (matching a SCI written with gain_variations / bias on).
    """
    lib = get_lib()
    reads = np.ascontiguousarray(reads_dn, np.float32)
    nr, h, w = reads.shape
    if len(ext_header_bytes) != 5 * nr:
        raise ValueError("need 5 extension headers per read")
    times = np.ascontiguousarray(read_times, np.float64)
    hdrs = (ctypes.c_char_p * len(ext_header_bytes))(*ext_header_bytes)
    lens = (ctypes.c_long * len(ext_header_bytes))(
        *[len(b) for b in ext_header_bytes])
    dq_ptr = None
    if dq is not None:
        dq = np.ascontiguousarray(dq, np.int16)
        if dq.shape != reads.shape:
            raise ValueError("dq shape must match reads")
        dq_ptr = dq.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))

    def plane(m):
        if m is None:
            return None, None
        m = np.ascontiguousarray(m, np.float32)
        if m.shape != (h, w):
            raise ValueError(f"plane shape {m.shape} != {(h, w)}")
        return m, m.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    # gm and bm keep the contiguous copies alive through the call
    gm, gm_ptr = plane(gain_map)
    bm, bm_ptr = plane(bias_e_map)
    rc = lib.wayne_write_ima(
        path.encode(), primary_bytes, len(primary_bytes), hdrs, lens,
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dq_ptr,
        nr, h, w, times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_float(gain), ctypes.c_float(read_noise_e),
        ctypes.c_float(bias_dn), gm_ptr, bm_ptr)
    if rc != 0:
        raise NativeWriterError(f"native ima writer failed on {path!r} "
                                f"(code {rc})")

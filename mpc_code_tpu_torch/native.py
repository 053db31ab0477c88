"""ctypes bindings for the native host-core library (port of ``mpc_code_tpu/native.py``).

The C++ is the repository's own ``native/hostcore.cpp`` (plain C++17, no
dependencies, C linkage), reused as it is: the doubling DARE, the
steady-state Kalman gain and the MHE's backward Riccati smoother, host
code that runs between solves.  It is not a device kernel.

The library is built with ``g++`` at first use into
``mpc_code_tpu_torch/_build/hostcore-<source hash>/`` and reused from
there; nothing is built when the module is imported, and ``native/`` is
left untouched.  Without a compiler, or if the build fails, ``available()``
is False and the callers (``estimators/mhe.py::MHERuntime``) take the same
recursion in numpy, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "hostcore.cpp")
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_LOCK = threading.Lock()

_DP = ctypes.POINTER(ctypes.c_double)


def library_path() -> Optional[str]:
    """Where the library for the current source lives (built or not);
    None when the source is missing."""
    if not os.path.exists(SOURCE):
        return None
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXXFLAGS).encode())
    return os.path.join(_PKG_DIR, "_build", f"hostcore-{h.hexdigest()[:20]}",
                        "libhostcore.so")


def _build(path: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx] + CXXFLAGS + ["-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _LOCK:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if path is None or (not os.path.exists(path) and not _build(path)):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.hc_dare.restype = ctypes.c_int
        lib.hc_dare.argtypes = [_DP, _DP, _DP, _DP, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, _DP]
        lib.hc_kalman_gain.restype = ctypes.c_int
        lib.hc_kalman_gain.argtypes = [_DP, _DP, _DP, _DP, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, _DP]
        lib.hc_riccati_smoother.restype = ctypes.c_int
        lib.hc_riccati_smoother.argtypes = [_DP, _DP, _DP, ctypes.c_int,
                                            ctypes.c_int, _DP]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the host-core library is built and loaded (building it on
    the first call)."""
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native hostcore unavailable (g++ missing or the build failed)")
    return lib


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _cptr(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def dare(A, B, Q, R, iters: int = 30) -> np.ndarray:
    """Native doubling DARE; the convention of ``ops/dare.py``."""
    lib = _lib_or_raise()
    A, B, Q, R = (_f64(a) for a in (A, B, Q, R))
    n, m = A.shape[0], B.shape[1]
    P = np.zeros((n, n), dtype=np.float64)
    rc = lib.hc_dare(_cptr(A), _cptr(B), _cptr(Q), _cptr(R), n, m, iters, _cptr(P))
    if rc != 0:
        raise ArithmeticError(f"hc_dare failed (rc={rc})")
    return P


def kalman_gain(A, C, Q, R, iters: int = 30) -> np.ndarray:
    """Native steady-state Kalman gain (reference Estimator.py:213-223)."""
    lib = _lib_or_raise()
    A, C, Q, R = (_f64(a) for a in (A, C, Q, R))
    n, p = A.shape[0], C.shape[0]
    K = np.zeros((n, p), dtype=np.float64)
    rc = lib.hc_kalman_gain(_cptr(A), _cptr(C), _cptr(Q), _cptr(R), n, p, iters,
                            _cptr(K))
    if rc != 0:
        raise ArithmeticError(f"hc_kalman_gain failed (rc={rc})")
    return K


def riccati_smoother(bigP, bigPc, bigA) -> np.ndarray:
    """Native MHE backward Riccati smoother (reference Estimator.py:654-664):
    N (n x n) priors, posteriors and state Jacobians in, the N smoothed
    covariances out."""
    lib = _lib_or_raise()
    bigP, bigPc, bigA = (_f64(np.stack(a)) for a in (bigP, bigPc, bigA))
    N, n, _ = bigP.shape
    Pis = np.zeros_like(bigP)
    rc = lib.hc_riccati_smoother(_cptr(bigP), _cptr(bigPc), _cptr(bigA), n, N,
                                 _cptr(Pis))
    if rc != 0:
        raise ArithmeticError(f"hc_riccati_smoother failed (rc={rc})")
    return Pis

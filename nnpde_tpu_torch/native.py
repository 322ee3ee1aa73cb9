"""ctypes bindings for the native C++ helpers (``native/tridiag_eigh.cpp``).

Counterpart of ``nnpde_tpu/native.py``.  The library is built on first use
when a toolchain is there (``g++ -O3 -shared -fPIC``) into this package's
build directory, ``nnpde_tpu_torch/_build/`` (beside the CUDA kernels'
library), through a temporary file renamed into place, so that concurrent
processes never load a half-written one.  Every caller has a scipy / numpy
fallback: the native path is an optimisation of a host-side float64
computation, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
SO = BUILD_DIR / "libnnpde_native.so"
SRC = _PKG.parent / "native" / "tridiag_eigh.cpp"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> bool:
    if not SRC.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, SO)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not SO.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(SO))
        lib.nnpde_tridiag_eigh.restype = ctypes.c_int
        lib.nnpde_tridiag_eigh.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def tridiag_eigh(diag: np.ndarray, offd: np.ndarray,
                 k: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """k smallest eigenpairs of the symmetric tridiagonal (diag, offd).

    Returns (evals (k,), evecs (n, k) unit-norm columns), or None when the
    native library is unavailable (callers fall back to scipy / numpy).
    """
    lib = load()
    if lib is None:
        return None
    d = np.ascontiguousarray(diag, np.float64)
    e = np.ascontiguousarray(offd, np.float64)
    n = d.shape[0]
    w = np.empty(k, np.float64)
    z = np.empty((k, n), np.float64)
    if lib.nnpde_tridiag_eigh(n, d, e, k, w, z) != 0:
        return None
    return w, z.T.copy()

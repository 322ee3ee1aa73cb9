"""Build the CUDA kernels with ``nvcc`` on first use and load them with ctypes.

The sources in ``nnpde_tpu_torch/csrc/`` have a plain C interface (no
PyTorch headers), so one ``nvcc`` call builds a shared library in seconds.
The library goes to ``nnpde_tpu_torch/_build/`` under a name that carries a
hash of the sources, so an edited source is never served from a stale
build; the compile goes to a temporary name first and is renamed into
place, so concurrent processes never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# name -> argtypes of every C entry point of fused_step.cu
_SIGNATURES = {
    # X, coef, params, layers, n_layers, act, N, T, G, partial, scratch,
    # out, smem_bytes, stream
    "fused_linear_residual_f32":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # X, params, layers, n_layers, act, N, T, G, analytic, partial, scratch,
    # out, smem_bytes, stream
    "fused_poisson_analytic_f32":
        [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "fused_drm_energy_f32":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # mode, smem_bytes, int* blocks
    "fused_blocks_per_sm": [_I, _I, _P],
}

_LIB = None
BUILD_LOG = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the "
                       "CUDA kernels of nnpde_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libfused_step_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/fused_step.cu`` unless the current build exists;
    returns the library path.  ``BUILD_LOG`` keeps nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills) and the build time."""
    import time

    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           str(CSRC / "fused_step.cu")]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOG.update(seconds=time.time() - t0, ptxas=proc.stderr)
    return lib


def load():
    """The loaded library with every entry point's argtypes declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB

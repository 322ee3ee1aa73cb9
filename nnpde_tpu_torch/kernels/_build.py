"""Build the CUDA kernels with ``nvcc`` on first use and load them with ctypes.

The sources in ``nnpde_tpu_torch/csrc/`` have a plain C interface (no
PyTorch headers).  Every ``.cu`` file is compiled to an object by its own
``nvcc`` process, all started together, and one more ``nvcc`` call links
the objects into a shared library, in seconds.  The library goes to
``nnpde_tpu_torch/_build/`` under a name that carries a hash of the
sources, so an edited source is never served from a stale build; the
build goes to a temporary directory first and the library is renamed into
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

# name -> argtypes of every C entry point of the csrc/*.cu files
_SIGNATURES = {
    # fold (the int after G): the kernel variant with the activation in the
    # products' epilogues; bf16 (after fold, where a kernel has it): the
    # bf16-dot variant; des, flags (fused_step.cu and fwdlap_backward.cu):
    # the design and the plan's residency flags
    # X, coef, params, wt, layers, n_layers, act, N, T, G, fold, bf16, des,
    # flags, partial, scratch, out, smem_bytes, stream (wt: the hidden
    # weights' transposes, read by a planned design)
    "fused_linear_residual_f32":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # X, params, wt, layers, n_layers, act, N, T, G, fold, bf16, des, flags,
    # analytic, partial, scratch, out, smem_bytes, stream
    "fused_poisson_analytic_f32":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    # X, coef, params, wt, layers, n_layers, act, N, T, G, fold, bf16, des,
    # flags, partial, scratch, out, smem_bytes, stream
    "fused_drm_energy_f32":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # mode, fold, bf16, des, smem_bytes, int* blocks
    "fused_blocks_per_sm": [_I, _I, _I, _I, _I, _P],
    # mode, layers, n_layers, T, flags -> bytes (not an error code)
    "fused_smem_bytes": [_I, _P, _I, _I, _I],
    # the tensor-core design: mode, layers, n_layers, T, flags -> bytes;
    # mode, layers, n_layers, T -> saved-stage floats per block (neither an
    # error code)
    "fused_mma_smem_bytes": [_I, _P, _I, _I, _I],
    "fused_mma_scratch_floats": [_I, _P, _I, _I],
    # fwdlap_forward.cu: streams, X, params, layers, n_layers, act, N, T, G,
    # fold, bf16, des, minb, flags, out, smem_bytes, stream, wd (minb: a row
    # kernel's register budget in blocks per SM; wd: DES_DEVW's weights)
    "fwdlap_forward_f32":
        [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    # streams, fold, bf16, des, minb, smem_bytes, int* blocks
    "fwdlap_forward_blocks_per_sm": [_I, _I, _I, _I, _I, _I, _P],
    # layers, n_layers, T, flags -> bytes (not an error code)
    "fwdlap_forward_smem_bytes": [_P, _I, _I, _I],
    # the tensor-core design of the bf16-dot mode: layers, n_layers, T,
    # flags -> bytes; layers, n_layers, T -> saved-stage floats per block
    # (0: nothing saved); neither an error code
    "fwdlap_forward_mma_smem_bytes": [_P, _I, _I, _I],
    "fwdlap_forward_mma_scratch_floats": [_P, _I, _I],
    # fwdlap_backward.cu: X, ct, params, wt, layers, n_layers, act, N, T, G,
    # fold, bf16, des, flags, partial, scratch, out, smem_bytes, stream
    "fwdlap_backward_f32":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # fold, bf16, des, smem_bytes, int* blocks
    "fwdlap_backward_blocks_per_sm": [_I, _I, _I, _I, _P],
    # layers, n_layers, T, flags -> bytes (not an error code)
    "fwdlap_backward_smem_bytes": [_P, _I, _I, _I],
    # the tensor-core design of the bf16-dot mode, as the forward's
    "fwdlap_backward_mma_smem_bytes": [_P, _I, _I, _I],
    "fwdlap_backward_mma_scratch_floats": [_P, _I, _I],
    # fused_quotient.cu: kind, lap, X, coef, params, scal, layers, n_layers,
    # act, N, T, G, flags, fold, des, minb, partial, scratch, out, smem_bytes,
    # stream, wd (des, minb: the sums kinds' design and register budget,
    # DES_DEVW for either kind; wd: DES_DEVW's weights)
    "fused_quotient_f32":
        [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P,
         _P],
    # kind, fold, des, minb, smem_bytes, int* blocks
    "fused_quotient_blocks_per_sm": [_I, _I, _I, _I, _I, _P],
    # kind, lap, layers, n_layers, T, flags -> bytes (not an error code)
    "fused_quotient_smem_bytes": [_I, _I, _P, _I, _I, _I],
    # fused_quotient_mma.cu (the bf16-dot mode): kind, lap, X, coef, params,
    # scal, layers, n_layers, act, N, T, G, flags, des, partial, scratch, out,
    # smem_bytes, stream
    "fused_quotient_mma_f32":
        [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # kind, lap, des, smem_bytes, int* blocks
    "fused_quotient_mma_blocks_per_sm": [_I, _I, _I, _I, _P],
    # kind, lap, layers, n_layers, T, flags -> bytes / scratch floats per
    # block (neither an error code)
    "fused_quotient_mma_smem_bytes": [_I, _I, _P, _I, _I, _I],
    "fused_quotient_mma_scratch_floats": [_I, _I, _P, _I, _I, _I],
    # fused_multibump.cu: seeded, n_bumps, X, coef, params, scal, layers,
    # n_layers, act, N, T, G, flags, fold, partial, scratch, out, smem_bytes,
    # stream, wd, des (wd: DEV_WEIGHTS's weights; des: the plan's design,
    # DES_DEVW and pass B's DES_BEYOND)
    "fused_multibump_f32":
        [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I],
    # seeded, fold, flags, des, smem_bytes, int* blocks
    "fused_multibump_blocks_per_sm": [_I, _I, _I, _I, _I, _P],
    # seeded, n_bumps, layers, n_layers, T, flags -> bytes (not an error code)
    "fused_multibump_smem_bytes": [_I, _I, _P, _I, _I, _I],
    # fused_multibump_mma.cu (the bf16-dot mode): seeded, n_bumps, X, coef,
    # params, scal, layers, n_layers, act, N, T, G, flags, des, partial,
    # scratch, out, smem_bytes, stream
    "fused_multibump_mma_f32":
        [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # seeded, des, smem_bytes, int* blocks
    "fused_multibump_mma_blocks_per_sm": [_I, _I, _I, _P],
    # seeded, n_bumps, layers, n_layers, T, flags -> bytes; seeded, layers,
    # n_layers, T, flags -> scratch floats per block (neither an error code)
    "fused_multibump_mma_smem_bytes": [_I, _I, _P, _I, _I, _I],
    "fused_multibump_mma_scratch_floats": [_I, _P, _I, _I, _I],
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
    return BUILD_DIR / f"libnnpde_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc process each, in parallel) and
    link them, unless the current build exists; returns the library path.
    ``BUILD_LOG`` keeps nvcc's ``-Xptxas -v`` report (registers, shared
    memory, spills) and the build time."""
    import time

    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", obj, str(src)]
            procs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        reports, failed = [], []
        for name, _, proc in procs:
            _, err = proc.communicate()
            reports.append(f"== {name}\n{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name} ({proc.returncode}):\n{err[-8000:]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        out = os.path.join(tmp, lib.name)
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", out,
                               *[obj for _, obj, _ in procs]],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr[-8000:]}")
        os.replace(out, lib)
    BUILD_LOG.update(seconds=time.time() - t0, ptxas="\n".join(reports))
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

"""Runtime helpers: device resolution, precision pinning, dispatch caps,
NaN trapping and profiler traces.

The JAX package's compilation cache has no counterpart: PyTorch runs
eagerly and the CUDA kernels are built once per process
(:mod:`nnpde_tpu_torch.kernels._build`), so
:func:`enable_compilation_cache` does nothing.
"""

from __future__ import annotations

import os

import torch


def enable_compilation_cache(path: str | None = None) -> None:
    """Does nothing.  The JAX package persists XLA's compiled programs
    across processes here; eager PyTorch compiles no program, and the CUDA
    kernels' library is built into ``nnpde_tpu_torch/_build/`` by
    :mod:`.kernels._build` on first use whatever this function does.  Kept
    so that code written against either package's ``runtime`` runs."""


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"`` -> the CUDA device, raising when there is none
    (never a silent CPU fallback); ``"cpu"`` only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nnpde_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def pin_fp32_precision() -> None:
    """Full-fp32 matmuls and convolutions: second derivatives are
    precision-sensitive (the JAX trainer pins
    ``default_matmul_precision('highest')``), and TF32 keeps ~3 digits.
    bf16 matmuls (the ``compute_dtype='bfloat16'`` phases) accumulate in
    fp32, as JAX's bf16 dots do: cuBLAS may otherwise reduce bf16 products
    in reduced precision (PyTorch's default allows it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def pallas_chunk_cap() -> int:
    """Epoch-chunk cap on the kernel path (``NNPDE_PALLAS_CHUNK_CAP``,
    0 = uncapped); the same knob as the JAX package's, default 1000."""
    cap = int(os.environ.get("NNPDE_PALLAS_CHUNK_CAP", 1000))
    return cap if cap > 0 else 1 << 30


def scan_chunk_cap() -> int:
    """Epochs per history flush in :func:`~nnpde_tpu_torch.train.fit`
    (``NNPDE_SCAN_CHUNK_CAP``, 0 = uncapped)."""
    cap = int(os.environ.get("NNPDE_SCAN_CHUNK_CAP", "0"))
    return cap if cap > 0 else 1 << 30


def enable_debug_nans(on: bool = True) -> None:
    """Opt-in NaN trapping: ``torch.autograd.set_detect_anomaly(on)``.

    What it catches: a backward function that returns NaN raises at once,
    naming the forward operation that made it, with that operation's
    traceback.  What JAX's ``jax_debug_nans`` catches that it does not: a
    NaN in a *forward* value (an evaluation, a tracked metric, a loss that
    no backward runs through), and a NaN that the hand-written kernels
    produce, since they return their gradients directly and no autograd
    function sees them.  Anomaly mode also slows every backward pass."""
    torch.autograd.set_detect_anomaly(bool(on))


def profile_trace(log_dir: str):
    """Context manager recording a ``torch.profiler`` trace (CPU, and CUDA
    where a card is present) of its body into ``log_dir`` as a Chrome /
    Perfetto JSON file (``*.pt.trace.json``, the file TensorBoard's
    profiler plugin reads), written when the block exits."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))


def force_cpu(n_devices: int = 8) -> int:
    """Make this process a CPU process: it hides the CUDA devices from it
    (``CUDA_VISIBLE_DEVICES=""``), so that ``torch.cuda.is_available()`` is
    false and the entry points run only where ``device="cpu"`` is passed
    (:func:`resolve_device` never falls back).  Call it before anything in
    the process asks for a CUDA device; once CUDA is initialised it raises.

    The JAX package's ``force_cpu`` also splits the CPU into ``n_devices``
    virtual devices for its mesh.  PyTorch has no virtual devices: a CPU
    member of a :mod:`.parallel` mesh is a process, a gloo rank of its own,
    which its launcher starts.  ``n_devices`` is checked and returned as
    the world size to start."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if torch.cuda.is_initialized():
        raise RuntimeError("force_cpu: CUDA is already initialised in this process")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    return int(n_devices)

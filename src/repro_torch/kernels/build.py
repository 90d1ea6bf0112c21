"""Build the CUDA kernels of ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (device pointers, sizes and
the stream in; ``cudaGetLastError()`` out), so it compiles with ``nvcc``
alone in seconds, without PyTorch's headers. The first call builds every
source at once, one ``nvcc`` process each, into
``build/repro_torch/<hash of sources and flags>/`` at the root of the
checkout, which ``.gitignore`` lists; later calls, and later processes on
the same checkout, load what is there.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sig_mac", "hash_table", "mvcc_validate")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("nvcc not found: the CUDA toolkit is required "
                            "to build the kernels")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.cache
def libraries() -> dict[str, ctypes.CDLL]:
    """Build (once) and load every kernel library: name -> CDLL."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp"
        log = open(out / f"{name}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for name, (proc, log, tmp) in jobs.items():
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(f"{name} (rc {rc}):\n{build_log(name)}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in SOURCES}


def build_log(name: str) -> str:
    """What nvcc printed for ``name`` (ptxas registers and shared memory)."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""


@functools.cache
def c_function(lib: str, fn: str, n_ptr: int, n_int: int):
    """``fn`` of library ``lib`` taking n_ptr pointers, n_int ints and the
    stream, returning the CUDA error code."""
    f = getattr(libraries()[lib], fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def launch(f, name: str, device: torch.device, *args) -> None:
    """Call a kernel's C entry on ``device``'s current stream; raise on a
    refused launch (it never ran, and a synchronize would not say so)."""
    with torch.cuda.device(device):
        err = f(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``t`` has the dtype, shape (None = any size), device
    and contiguous layout a kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def dispatch(device: torch.device) -> bool:
    """True when the wrapper launches its kernel (a CUDA tensor), False
    when it takes the plain version (a CPU tensor); raise otherwise."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")

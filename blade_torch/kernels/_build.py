"""Build and load the port's hand-written CUDA kernels.

All sources under ``blade_torch/csrc/`` compile with ``nvcc`` for ``sm_90a``
(one ``nvcc`` a source, in parallel) and link into ONE shared library with a
plain C interface, loaded with ``ctypes``.
The build runs at first use (never at import), writes into
``build/blade_torch_kernels/`` at the repository root, and names the library
by a hash of the sources and flags so a stale build is never loaded.

Every exported C function launches on the stream it is given and returns
``cudaGetLastError()``; :class:`CudaKernel` raises on a non-zero return and
counts successful launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["CudaKernel", "KERNELS", "library", "reset_launch_counts", "check_inputs",
           "cuda_stream", "NVCC_FLAGS", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "blade_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_checked(procs) -> None:
    """Wait for every ``(cmd, Popen)``; raise on the first failure."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError(failed)


def _build() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib_path = BUILD_DIR / f"libblade_torch_{_source_hash(sources + headers)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    # One nvcc per source, all started together, into a private directory;
    # then one link.  The library is written to a temporary name and
    # renamed, so a concurrent build never loads a half-written file.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        procs = []
        objs = []
        for src in sources:
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *compile_flags, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        _run_checked(procs)
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *objs]
        _run_checked([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.bt_error_string.argtypes = [ctypes.c_int]
            lib.bt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class CudaKernel:
    """One exported C entry point plus its launch counter.

    ``argtypes`` uses ``"p"`` for a pointer or the stream (``c_void_p``: a
    32-bit default would cut the address), ``"i"`` for int, ``"f"`` for
    float.  ``launches`` counts calls whose launch the runtime accepted.
    ``source`` is the CUDA file and ``replaces`` the ``file:line`` of the TPU
    kernel it ports.
    """

    _CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

    def __init__(self, name: str, symbol: str, argtypes: str, *,
                 source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = [self._CTYPES[a] for a in argtypes]
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().bt_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: {msg} ({err})")
        self.launches += 1


KERNELS: Dict[str, CudaKernel] = {}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def check_inputs(fn: str, *tensors, dtype) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA tensor
    of ``dtype`` on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{fn}: all inputs must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: inputs must be 16-byte aligned")


def cuda_stream(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream

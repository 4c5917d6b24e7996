"""Build and load the hand-written CUDA kernels.

Every ``*.cu`` file under ``tfimm_tpu_torch/csrc/`` is compiled by ``nvcc``
into one shared library with a plain C interface, loaded with ``ctypes``.
The build happens at the first CUDA call, never at import, so the package
imports on a machine without ``nvcc``. It is keyed by a hash of the sources
and the flags, and lands in ``tfimm_tpu_torch/_build/`` (listed in
``.gitignore``); a later process with the same sources reuses it.

A failed build raises: nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["kernel_library", "find_nvcc", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of tfimm_tpu_torch are built from source at first use")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib):
    lib.tfimm_fused_mha_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # qkv, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, H, d
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_fused_mha_fwd.restype = ctypes.c_int
    return lib


def kernel_library(verbose: bool = False):
    """The loaded kernel library, built first if this source hash has no
    library yet. ``verbose`` prints nvcc's resource report (-Xptxas -v)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_DIR / _digest()
        so = out_dir / "libtfimm_kernels.so"
        if not so.is_file():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libtfimm_kernels.{os.getpid()}.so"
            cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), *map(str, _sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
            if verbose:
                print(proc.stdout + proc.stderr, flush=True)
            os.replace(tmp, so)
        _lib = _declare(ctypes.CDLL(str(so)))
        return _lib

"""Build and load the hand-written CUDA kernels.

Every ``*.cu`` file under ``tfimm_tpu_torch/csrc/`` is compiled by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.
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
              "-Xcompiler", "-fPIC")

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
    for src in sorted(_CSRC.glob("*.cu*")):   # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib):
    geometry = ctypes.POINTER(ctypes.c_int64)  # tma.py's packed maps or NULL
    lib.tfimm_fused_mha_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # qkv, out
        geometry,  # bf16: the qkv and out tensor maps
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, H, d
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_fused_mha_fwd.restype = ctypes.c_int
    lib.tfimm_fused_mha_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, g, dqkv
        ctypes.c_void_p, ctypes.c_void_p,  # f32 scratch row sum, row delta
        geometry,  # bf16: the qkv (and dqkv) and g tensor maps
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, H, d
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_fused_mha_bwd.restype = ctypes.c_int
    lib.tfimm_convnext_mlp.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # x, shortcut
        ctypes.c_void_p, ctypes.c_void_p,  # f32 ln weight, ln bias
        ctypes.c_void_p, ctypes.c_void_p,  # w1, f32 b1
        ctypes.c_void_p, ctypes.c_void_p,  # w2, f32 b2
        ctypes.c_void_p,  # f32 gamma
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # scratch h, mean, rstd
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, C, H
        ctypes.c_float, ctypes.c_int,  # eps, dtype code
        geometry,  # bf16 TMA route: fc1's and fc2's tensor maps, or NULL
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_convnext_mlp.restype = ctypes.c_int
    lib.tfimm_window_mha.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_int64, ctypes.c_int64,  # q batch and row strides
        ctypes.c_int64, ctypes.c_int64,  # k batch and row strides
        ctypes.c_int64, ctypes.c_int64,  # v batch and row strides
        ctypes.c_void_p, ctypes.c_void_p,  # f32 bias (H, N, N), mask or NULL
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # BW, N, H, d
        ctypes.c_int,  # nb_windows of the mask
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        geometry,  # bf16 on tma.window_route: the Hopper body's maps, or NULL
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_window_mha.restype = ctypes.c_int
    lib.tfimm_window_mha_bwd.argtypes = [
        ctypes.c_void_p,  # qkv
        ctypes.c_int64, ctypes.c_int64,  # qkv batch and row strides
        ctypes.c_void_p,  # g
        ctypes.c_void_p, ctypes.c_void_p,  # f32 bias (H, N, N), mask or NULL
        ctypes.c_void_p,  # dqkv
        ctypes.c_void_p, ctypes.c_void_p,  # f32 scratch partials, dbias
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # BW, N, H, d
        ctypes.c_int, ctypes.c_int,  # nb_windows of the mask, windows per block
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        geometry,  # bf16 on tma.window_route: the Hopper body's maps, or NULL
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_window_mha_bwd.restype = ctypes.c_int
    lib.tfimm_swin_block.argtypes = [
        ctypes.c_void_p,  # x
        ctypes.c_void_p, ctypes.c_void_p,  # f32 ln1 weight, bias
        ctypes.c_void_p, ctypes.c_void_p,  # w_qkv, f32 b_qkv
        ctypes.c_void_p, ctypes.c_void_p,  # f32 bias (H, N, N), mask or NULL
        ctypes.c_void_p, ctypes.c_void_p,  # w_proj, f32 b_proj
        ctypes.c_void_p, ctypes.c_void_p,  # f32 ln2 weight, bias
        ctypes.c_void_p, ctypes.c_void_p,  # w1, f32 b1
        ctypes.c_void_p, ctypes.c_void_p,  # w2, f32 b2
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # scratch qkv, attn, x2
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # scratch hid, mean, rstd
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # BW, N, C
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H, hidden, nb_windows
        ctypes.c_float, ctypes.c_float, ctypes.c_int,  # eps, scale, dtype code
        geometry,  # bf16: qkv's, proj's, fc1's and fc2's tensor maps; f32: NULL
        geometry,  # bf16 on tma.window_route: the attention's maps, or NULL
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_swin_block.restype = ctypes.c_int
    mixes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # w_l (H, H), strides
        ctypes.c_void_p,  # b_l (H,)
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # w_w (H, H), strides
        ctypes.c_void_p,  # b_w (H,)
        ctypes.c_int,  # the mixes' dtype code
    ]
    lib.tfimm_talking_head_fwd.argtypes = [
        ctypes.c_void_p,  # qkv
        ctypes.c_int64, ctypes.c_int64,  # qkv batch and row strides
        *mixes,
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, H, d
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        geometry,  # bf16 on tma.cait_route: the Hopper body's maps, or NULL
        ctypes.c_void_p,  # with the maps: f32 log2 l for the backward, or NULL
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_talking_head_fwd.restype = ctypes.c_int
    lib.tfimm_talking_head_bwd.argtypes = [
        ctypes.c_void_p,  # qkv
        ctypes.c_int64, ctypes.c_int64,  # qkv batch and row strides
        *mixes,
        ctypes.c_void_p, ctypes.c_void_p,  # g, dqkv
        ctypes.c_void_p,  # f32 scratch (2, B, H, N): row sums l, deltas
        ctypes.c_void_p, ctypes.c_void_p,  # f32 scratch partial sums
        ctypes.c_void_p,  # f32 out: dw_l (H, H), dw_w (H, H), db_w, db_l (H,)
        ctypes.c_void_p,  # bf16 scratch of a and draw (Hopper body) or NULL
        geometry,  # bf16 on tma.cait_route: the Hopper body's maps, or NULL
        ctypes.c_void_p,  # with the maps: the forward's f32 log2 l, or NULL
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, H, d
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_talking_head_bwd.restype = ctypes.c_int
    lib.tfimm_flash_attention_relpos_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q (scaled), k, v
        ctypes.c_int64, ctypes.c_int64,  # q batch and row strides
        ctypes.c_int64, ctypes.c_int64,  # k batch and row strides
        ctypes.c_int64, ctypes.c_int64,  # v batch and row strides
        ctypes.c_void_p, ctypes.c_void_p,  # rel_h_term (B, N, gh), rel_w_term
        ctypes.c_void_p, ctypes.c_void_p,  # out, f32 lse (B, N)
        geometry,  # bf16: the q, k, v and out tensor maps
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, d
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # gh, gw, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_flash_attention_relpos_fwd.restype = ctypes.c_int
    lib.tfimm_flash_attention_relpos_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q (scaled), k, v
        ctypes.c_int64, ctypes.c_int64,  # q batch and row strides
        ctypes.c_int64, ctypes.c_int64,  # k batch and row strides
        ctypes.c_int64, ctypes.c_int64,  # v batch and row strides
        ctypes.c_void_p, ctypes.c_void_p,  # rel_h_term (B, N, gh), rel_w_term
        ctypes.c_void_p, ctypes.c_void_p,  # do, out (B, N, d)
        ctypes.c_void_p, ctypes.c_void_p,  # f32 lse (B, N), f32 delta (f32 only)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dq, dk, dv
        ctypes.c_void_p, ctypes.c_void_p,  # drh, drw
        geometry,  # bf16: the tensor maps of qs, k, v, do, out, dq, dk, dv (, rw)
        ctypes.c_void_p,  # bf16: f32 scratch (2, B, N rounded up to 64)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, d
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # gh, gw, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_flash_attention_relpos_bwd.restype = ctypes.c_int
    lib.tfimm_pvt_sra.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # x (B, N, C), kv (B, S, 2C)
        ctypes.c_int64, ctypes.c_int64,  # kv batch and row strides
        ctypes.c_void_p, ctypes.c_void_p,  # wq (C, C), f32 bq
        ctypes.c_void_p, ctypes.c_void_p,  # wp (C, C), f32 bp
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, S, C
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        geometry,  # bf16 on tma.sra_route: the x, kv, wq, wp maps and grid
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_pvt_sra.restype = ctypes.c_int
    lib.tfimm_poolformer_block.argtypes = [
        ctypes.c_void_p,  # x (B, H, W, C)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # f32 n1 w, b, ls1
        ctypes.c_void_p, ctypes.c_void_p,  # f32 n2 weight, bias
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # f32 b1, b2, ls2
        ctypes.c_void_p, ctypes.c_void_p,  # w1 (hidden, C), w2 (C, hidden)
        ctypes.c_void_p, ctypes.c_void_p,  # scratch f32 x1, hidden h
        ctypes.c_void_p,  # f32 scratch (4, B): mean1, rstd1, mean2, rstd2
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, C
        ctypes.c_int, ctypes.c_float, ctypes.c_int,  # hidden, eps, dtype code
        geometry,  # bf16 TMA route: fc1's and fc2's tensor maps, or NULL
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_poolformer_block.restype = ctypes.c_int
    lib.tfimm_convnext_block.argtypes = [
        ctypes.c_void_p,  # x (B, H, W, C)
        ctypes.c_void_p, ctypes.c_void_p,  # f32 taps (49, C), dw bias
        ctypes.c_void_p, ctypes.c_void_p,  # f32 ln weight, ln bias
        ctypes.c_void_p, ctypes.c_void_p,  # w1 (hidden, C), f32 b1
        ctypes.c_void_p, ctypes.c_void_p,  # w2 (C, hidden), f32 b2
        ctypes.c_void_p,  # f32 gamma
        ctypes.c_void_p, ctypes.c_void_p,  # scratch z (M, C), h (M, hidden)
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, C
        ctypes.c_int, ctypes.c_float, ctypes.c_int,  # hidden, eps, dtype code
        geometry,  # bf16 TMA route: fc1's and fc2's tensor maps, or NULL
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_convnext_block.restype = ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_int64)  # (B, H, N) strides of each
    lib.tfimm_flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q (scaled), k, v
        ctypes.c_void_p, ctypes.c_void_p,  # out, f32 lse (B * H, N)
        strides,  # of q, k, v, out
        geometry,  # bf16 up to d = 128: the q, k, v and out tensor maps
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B*H, H, N, d
        ctypes.c_int,  # dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_flash_attention_fwd.restype = ctypes.c_int
    lib.tfimm_flash_attention_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q (scaled), k, v
        ctypes.c_void_p, ctypes.c_void_p,  # do, out
        ctypes.c_void_p, ctypes.c_void_p,  # f32 lse, delta (B * H, N; delta not
        # read by the bf16 kernels up to d = 128)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dq, dk, dv
        strides,  # of q, k, v, do, dq, dk, dv
        geometry,  # bf16 up to d = 128: the tensor maps of q, k, v, do, out,
        # dq, dk, dv
        ctypes.c_void_p,  # and an f32 scratch (2, B * H, N rounded up to 64)
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B*H, H, N, d
        ctypes.c_int,  # dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_flash_attention_bwd.restype = ctypes.c_int
    lib.tfimm_ln_dense_fwd.argtypes = [
        ctypes.c_void_p,  # x (M, C)
        ctypes.c_void_p, ctypes.c_void_p,  # f32 gamma, beta
        ctypes.c_void_p, ctypes.c_void_p,  # w (O, C), f32 bias or NULL
        ctypes.c_void_p, ctypes.c_void_p,  # f32 scratch mean, rstd (M,)
        ctypes.c_void_p,  # out (M, O)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, C, O
        ctypes.c_float, ctypes.c_int,  # eps, dtype code
        geometry,  # bf16 TMA route: the product's tensor maps, or NULL
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_ln_dense_fwd.restype = ctypes.c_int
    lib.tfimm_ln_dense_bwd.argtypes = [
        ctypes.c_void_p,  # x (M, C)
        ctypes.c_void_p, ctypes.c_void_p,  # f32 gamma, beta
        ctypes.c_void_p, ctypes.c_void_p,  # w (O, C), g (M, O)
        ctypes.c_void_p, ctypes.c_void_p,  # f32 scratch mean, rstd (M,)
        ctypes.c_void_p,  # dx (M, C)
        ctypes.c_void_p, ctypes.c_void_p,  # f32 scratch partials, f32 out (2, C)
        ctypes.c_void_p, ctypes.c_void_p,  # f32 scratch dW, db partials
        ctypes.c_void_p, ctypes.c_void_p,  # dw (O, C), f32 db (O,)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, C, O
        ctypes.c_int, ctypes.c_int,  # dx block rows, dW row slices
        ctypes.c_float, ctypes.c_int,  # eps, dtype code
        ctypes.c_void_p, ctypes.c_void_p,  # tma route: scratch z, f32 dz
        geometry,  # bf16 on tma.ln_dense_bwd_route: the GEMMs' maps, plan
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tfimm_ln_dense_bwd.restype = ctypes.c_int
    return lib


def _run_all(cmds):
    """Start every command at once, wait for all, raise on the first that
    failed. Returns their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


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
            nvcc, pid = find_nvcc(), os.getpid()
            ptxas = ["-Xptxas", "-v"] if verbose else []
            objs = [out_dir / f"{src.stem}.{pid}.o" for src in _sources()]
            report = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj),
                                str(src)]
                               for src, obj in zip(_sources(), objs)])
            tmp = out_dir / f"libtfimm_kernels.{pid}.so"
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
            for obj in objs:
                obj.unlink()
            if verbose:
                print(report, flush=True)
            os.replace(tmp, so)
        _lib = _declare(ctypes.CDLL(str(so)))
        return _lib

"""Single-gather window (re)partitioning for Swin-style blocks; counterpart of
tfimm_tpu/ops/window_gather.py.

Everything in a Swin block outside the attention is per token, so a block
commutes with any token permutation. Going from the (B, H*W, C) feature map
to the window layout (B, nb_windows * N, C), with the cyclic pre-roll of a
shifted block, is one static permutation of the token axis, and so is the
way back; "un-window at shift s0, re-window at shift s1" between two blocks
composes into one permutation too. The index math is numpy, cached per
geometry; each permutation runs as one ``index_select`` along the token axis
with the index tensor cached on the input's device.

The JAX package pads every window from N = ws^2 rows to a multiple of 4 (a
TPU sublane alignment) and fills the pad rows through out-of-bounds indices.
The port keeps windows at N rows, so every index here is in bounds and every
permutation is a bijection.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "pack_indices",
    "unpack_indices",
    "repack_indices",
    "pack_windows",
    "unpack_windows",
    "repack_windows",
]


@functools.lru_cache(maxsize=None)
def pack_indices(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Token indices building the window layout from the flat map.

    Returns int64 (nb_windows * ws^2,): entry r is the flat map position
    (row-major over H, W) of the token at window-layout row r. Windows are
    row-major over (H // ws, W // ws), matching ``window_partition``;
    ``shift`` is the cyclic pre-roll (roll by -shift on both spatial axes).
    """
    if h % ws or w % ws:
        raise ValueError(
            f"window_gather requires ws to tile the map: got {h}x{w} with "
            f"ws={ws}")
    n = ws * ws
    wi, wj, t = np.meshgrid(np.arange(h // ws), np.arange(w // ws),
                            np.arange(n), indexing="ij")
    r, c = t // ws, t % ws
    sh = (wi * ws + r + shift) % h
    sw = (wj * ws + c + shift) % w
    return np.ascontiguousarray((sh * w + sw).reshape(-1).astype(np.int64))


@functools.lru_cache(maxsize=None)
def unpack_indices(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Inverse of :func:`pack_indices`: entry j is the window-layout row
    whose token belongs at flat map position j (window reverse and the roll
    by +shift, as one gather)."""
    fwd = pack_indices(h, w, ws, shift)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(len(fwd), dtype=np.int64)
    return inv


@functools.lru_cache(maxsize=None)
def repack_indices(h: int, w: int, ws: int, shift_from: int,
                   shift_to: int) -> np.ndarray:
    """One gather taking the window layout at ``shift_from`` to the window
    layout at ``shift_to`` (un-window and re-window composed)."""
    return np.ascontiguousarray(
        unpack_indices(h, w, ws, shift_from)[pack_indices(h, w, ws, shift_to)])


@functools.lru_cache(maxsize=None)
def _index_tensor(kind: str, device: torch.device, *geometry) -> torch.Tensor:
    fn = {"pack": pack_indices, "unpack": unpack_indices,
          "repack": repack_indices}[kind]
    return torch.from_numpy(fn(*geometry)).to(device)


def _take(x: torch.Tensor, kind: str, *geometry) -> torch.Tensor:
    return x.index_select(1, _index_tensor(kind, x.device, *geometry))


def pack_windows(x: torch.Tensor, h: int, w: int, ws: int,
                 shift: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, nb_windows * ws^2, C) window layout."""
    return _take(x, "pack", h, w, ws, shift)


def unpack_windows(x: torch.Tensor, h: int, w: int, ws: int,
                   shift: int) -> torch.Tensor:
    """Inverse of :func:`pack_windows`."""
    return _take(x, "unpack", h, w, ws, shift)


def repack_windows(x: torch.Tensor, h: int, w: int, ws: int, shift_from: int,
                   shift_to: int) -> torch.Tensor:
    """Window layout at ``shift_from`` -> window layout at ``shift_to``."""
    return _take(x, "repack", h, w, ws, shift_from, shift_to)

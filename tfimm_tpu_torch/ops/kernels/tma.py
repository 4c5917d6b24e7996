"""Tensor-map geometries of the Hopper kernels' TMA loads and stores.

A TMA tensor map describes a tensor in device memory as up to five
dimensions, innermost first: the number of elements along each (``dims``),
the byte stride of each dimension but the innermost, which is contiguous
(``strides``), and the box that one load or store moves (``box``). A box
may run past ``dims``: the elements outside read as zeros and are not
written. The kernels encode each map from the 15 int64 values of
``TensorMapGeometry.pack`` (``csrc/hopper.cuh · encode_bf16_map``), bf16
with the 128-byte swizzle, and compute each box's coordinates themselves.

Every box here is 64 columns wide (128 bytes of bf16, one swizzle row) and
64 rows deep, so one layout serves every head dim d up to 128: one column
chunk below d = 64, two above, zeros past d.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

__all__ = ["TILE", "ELEM_BYTES", "TensorMapGeometry", "geometry_array",
           "fused_mha_maps", "rows_map", "heads_map", "padded_rows",
           "packed_fused_mha_maps", "packed_rows_maps", "packed_heads_maps",
           "packed_operand_maps"]

TILE = 64
ELEM_BYTES = 2     # bf16, the only dtype the maps serve
_SLOTS = 5


@dataclass(frozen=True)
class TensorMapGeometry:
    dims: Tuple[int, ...]      # elements, innermost first
    strides: Tuple[int, ...]   # bytes, of dims[1:]
    box: Tuple[int, ...]       # elements, innermost first

    def pack(self) -> list:
        """rank, dims (5 slots), strides (4 slots), box (5 slots)."""
        rank = len(self.dims)
        pad = [0] * (_SLOTS - rank)
        return [rank, *self.dims, *pad, *self.strides, *pad, *self.box, *pad]


def geometry_array(*maps: TensorMapGeometry) -> ctypes.Array:
    """The maps packed one after another, for the C launchers."""
    values = [v for m in maps for v in m.pack()]
    return (ctypes.c_int64 * len(values))(*values)


def fused_mha_maps(b: int, n: int, nb_heads: int, d: int):
    """(qkv, out) of ``fused_mha``: qkv (B, N, 3*H*d), its last dim in
    (3, H, d) order, as (d, H, 3, N, B), so that a (64, 1, 1, 64, 1) box at
    (64 c, h, part, r, b) is columns 64 c... of rows r... of head h's q
    (part 0), k (1) or v (2) of image b; out (B, N, H*d) as (d, H, N, B)
    with a (64, 1, 64, 1) box. ``fused_mha_bwd`` reads and writes its qkv
    and dqkv through the first geometry and g = dL/dout, which has the
    output's layout, through the second."""
    e = ELEM_BYTES
    qkv = TensorMapGeometry(
        dims=(d, nb_heads, 3, n, b),
        strides=(e * d, e * nb_heads * d, 3 * e * nb_heads * d,
                 3 * e * nb_heads * d * n),
        box=(TILE, 1, 1, TILE, 1))
    out = TensorMapGeometry(
        dims=(d, nb_heads, n, b),
        strides=(e * d, e * nb_heads * d, e * nb_heads * d * n),
        box=(TILE, 1, TILE, 1))
    return qkv, out


def rows_map(shape: Tuple[int, int, int],
             stride: Tuple[int, ...]) -> TensorMapGeometry:
    """A (B, N, d) tensor of ``shape`` and element ``stride``, unit along d,
    read through its own row and batch strides, as (d, N, B): a (64, 64, 1)
    box at (64 c, r, b) is columns 64 c... of rows r... of row b."""
    b, n, d = shape
    return TensorMapGeometry(dims=(d, n, b),
                             strides=(ELEM_BYTES * stride[1],
                                      ELEM_BYTES * stride[0]),
                             box=(TILE, TILE, 1))


def heads_map(shape: Tuple[int, int, int, int],
              stride: Tuple[int, ...]) -> TensorMapGeometry:
    """A (B, H, N, d) tensor of ``shape`` and element ``stride``, unit along
    d, read through its own token, head and image strides, as (d, N, H, B):
    a (64, 64, 1, 1) box at (64 c, r, h, b) is columns 64 c... of rows r...
    of head h of image b. A (..., N, d) operand is H = 1."""
    b, h, n, d = shape
    return TensorMapGeometry(dims=(d, n, h, b),
                             strides=(ELEM_BYTES * stride[2],
                                      ELEM_BYTES * stride[1],
                                      ELEM_BYTES * stride[0]),
                             box=(TILE, TILE, 1, 1))


def padded_rows(n: int) -> int:
    """N rounded up to whole 64-row boxes: the rows of the backward kernels'
    f32 statistics scratch (``csrc/attention_bwd.cuh``)."""
    return -(-n // TILE) * TILE


# The packed maps of a call depend on its shapes and strides only, and
# building them costs more host time than the smaller kernels take on the
# card: they are kept per shape.

@functools.lru_cache(maxsize=256)
def packed_fused_mha_maps(b: int, n: int, nb_heads: int,
                          d: int) -> ctypes.Array:
    """``fused_mha_maps`` of a bf16 call, packed."""
    return geometry_array(*fused_mha_maps(b, n, nb_heads, d))


@functools.lru_cache(maxsize=256)
def packed_rows_maps(shape: Tuple[int, int, int],
                     *strides: Tuple[int, ...]) -> ctypes.Array:
    """``rows_map`` of bf16 operands of one ``shape`` with these strides,
    packed in order."""
    return geometry_array(*(rows_map(shape, s) for s in strides))


@functools.lru_cache(maxsize=256)
def packed_operand_maps(*operands: Tuple[Tuple[int, ...], Tuple[int, ...]]
                        ) -> ctypes.Array:
    """``heads_map`` of bf16 operands given as (shape, stride) pairs, each
    with its own shape, packed in order."""
    return geometry_array(*(heads_map(shape, stride)
                            for shape, stride in operands))


def packed_heads_maps(shape: Tuple[int, int, int, int],
                      *strides: Tuple[int, ...]) -> ctypes.Array:
    """``packed_operand_maps`` of operands of one ``shape`` with these
    strides."""
    return packed_operand_maps(*((shape, s) for s in strides))

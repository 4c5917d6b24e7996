"""Tensor-map geometries of the Hopper kernels' TMA loads and stores.

A TMA tensor map describes a tensor in device memory as up to five
dimensions, innermost first: the number of elements along each (``dims``),
the byte stride of each dimension but the innermost, which is contiguous
(``strides``), and the box that one load or store moves (``box``). A box
may run past ``dims``: the elements outside read as zeros and are not
written. The kernels encode each map from the 15 int64 values of
``TensorMapGeometry.pack`` (``csrc/hopper.cuh · encode_bf16_map``), bf16
with the 128-byte swizzle, and compute each box's coordinates themselves.

Every box here is 128 bytes wide, one swizzle row: 64 bf16 columns, or 32
of f32. The attention maps' boxes are 64 rows deep, so one layout serves
every head dim d up to 128: one column chunk below d = 64, two above, zeros
past d. The GEMM maps (``matrix_map``, ``gemm_maps``: ``csrc/mlp_gemm.cuh``'s
TMA + wgmma body, under ``convnext_mlp``, ``convnext_block``, ``ln_dense``'s
forward, ``swin_block`` and ``poolformer_block``) read a row-major (rows,
cols) matrix as (cols, rows) in boxes of 64 bf16 or 32 f32 columns and 64,
128, 192 or 256 rows; zeros past the rows and columns stand in for the
masked loads at the M, N and K tails. An f32 map (the f32 A of the norm
prologue, an f32 shortcut or output) is encoded as f32 by the launcher,
which knows its operands' types (``csrc/hopper.cuh · encode_map``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

__all__ = ["TILE", "ELEM_BYTES", "F32_BYTES", "SWIZZLE_BYTES",
           "TensorMapGeometry", "geometry_array",
           "fused_mha_maps", "rows_map", "heads_map", "padded_rows",
           "packed_fused_mha_maps", "packed_rows_maps", "packed_heads_maps",
           "packed_operand_maps", "GEMM_ROWS", "GEMM_WIDTHS", "LN_MAX_DEPTH",
           "LN_MAX_DEPTH_WIDE", "GemmProduct", "matrix_map", "gemm_width",
           "gemm_maps", "gemm_grid", "packed_gemm_maps", "gemm_route",
           "sm_count",
           "CAIT_KEYS", "CAIT_MAX_HEADS", "CAIT_MAX_HEAD_DIM", "cait_route",
           "cait_maps", "cait_scratch_cols", "cait_scratch_map",
           "packed_cait_maps", "window_route", "window_map", "window_maps",
           "window_group", "packed_window_maps", "window_bwd_maps",
           "packed_window_bwd_maps", "SRA_MAX_DIM", "SRA_MAX_KEYS",
           "sra_route", "sra_maps", "sra_grid", "packed_sra_maps",
           "LN_BWD_ROWS", "LN_BWD_MAX_DIM", "LN_BWD_WIDTHS",
           "ln_dense_bwd_route", "LnBwdPlan", "ln_dense_bwd_dw_costs",
           "ln_dense_bwd_plan",
           "ln_dense_bwd_maps", "packed_ln_dense_bwd_maps"]

TILE = 64
ELEM_BYTES = 2       # bf16: the attention maps and the GEMM's bf16 operands
F32_BYTES = 4        # the GEMM's f32 operands
SWIZZLE_BYTES = 128  # a box's inner extent: one 128-byte swizzle row
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


# The GEMM body (csrc/mlp_gemm.cuh · gemm_bf16_wgmma): output tiles of
# GEMM_ROWS rows (two consumer warpgroups of 64) and GEMM_WIDTHS columns,
# 192 only in the kernels declared with it (CNX_WGMMA_KERNEL_192: Swin's);
# the norm prologue keeps the affine of every k column in shared memory, up
# to LN_MAX_DEPTH columns beside 128-column tiles and LN_MAX_DEPTH_WIDE
# beside wider ones (kLnMaxDepth, kLnMaxDepthWide there).
GEMM_ROWS = 128
GEMM_WIDTHS = (128, 192, 256)
LN_MAX_DEPTH = 4096
LN_MAX_DEPTH_WIDE = 2048


class GemmProduct(NamedTuple):
    """One product out = epi(a @ b^T) of the GEMM body: a (M, K), b (N, K);
    whether the norm prologue reads a, whether a residual epilogue reads a
    shortcut; the SM count; the element bytes of a, the output and the
    shortcut (ELEM_BYTES for bf16, F32_BYTES for f32; b is bf16); whether
    its kernel has 192-column tiles."""

    m: int
    n: int
    k: int
    ln: bool
    residual: bool
    sms: int
    a_bytes: int = ELEM_BYTES
    out_bytes: int = ELEM_BYTES
    sc_bytes: int = ELEM_BYTES
    w192: bool = False


def matrix_map(rows: int, cols: int, box_rows: int,
               elem_bytes: int = ELEM_BYTES) -> TensorMapGeometry:
    """A contiguous row-major (rows, cols) matrix of ``elem_bytes``
    elements as (cols, rows): a (128 / elem_bytes, box_rows) box at (c, r)
    is columns c... (64 bf16 or 32 f32) of rows r..., zeros past either
    edge."""
    return TensorMapGeometry(dims=(cols, rows), strides=(elem_bytes * cols,),
                             box=(SWIZZLE_BYTES // elem_bytes, box_rows))


def gemm_width(m: int, n: int, k: int, ln: bool, residual: bool, sms: int,
               a_bytes: int = ELEM_BYTES, w192: bool = False) -> int:
    """Output tile columns of the product (M, K) x (N, K)^T on ``sms``
    SMs, one persistent block an SM, of a kernel with tiles of 128 and
    256 columns and, with ``w192``, 192. Under a residual epilogue the
    width up to 192 that pads N least, the narrower on a tie (its products
    are long in K, and the ring of 128-column tiles holds five stages to
    the three of 256-column ones: faster at every ConvNeXt-B stage on the
    H100; N = 192 in one 192-column tile: faster than two of 128 at
    Swin-T's stage 2, ``scripts/perf/torch_gemm_widths.py``). Else 128
    where N fits 128 columns or where the LN affine would not fit beside
    wider tiles, and otherwise the width whose rounds of tiles cost least
    (a round's time grows with the width), the wider on a tie; an f32 A
    under the norm prologue (``a_bytes`` F32_BYTES) not at 128, since each
    column tile reads it again (slower at every stage of Swin-T and
    PoolFormer-S12, ``torch_gemm_widths.py``)."""
    widths = tuple(w for w in GEMM_WIDTHS if w192 or w != 192)

    def cost(width):
        tiles = -(-m // GEMM_ROWS) * -(-n // width)
        return -(-tiles // sms) * width

    if residual:
        return min((w for w in widths if w <= 192),
                   key=lambda w: (-(-n // w) * w, w))
    if n <= 128 or (ln and k > LN_MAX_DEPTH_WIDE):
        return 128
    if ln and a_bytes == F32_BYTES:
        widths = widths[1:]
    return min(widths, key=lambda w: (cost(w), -w))


def gemm_maps(m: int, n: int, k: int, width: int, a_bytes: int = ELEM_BYTES,
              out_bytes: int = ELEM_BYTES, sc_bytes: int = None):
    """(a, b, out, shortcut) of out = epi(a @ b^T): a (M, K) in 128-row
    boxes, b (N, K) in ``width``-row boxes, out and the shortcut (M, N) in
    64-row boxes (a consumer warpgroup's rows), all contiguous, each of its
    element bytes (the shortcut's those of out where not given)."""
    sc_bytes = out_bytes if sc_bytes is None else sc_bytes
    return (matrix_map(m, k, GEMM_ROWS, a_bytes), matrix_map(n, k, width),
            matrix_map(m, n, TILE, out_bytes), matrix_map(m, n, TILE, sc_bytes))


def gemm_grid(m: int, n: int, width: int, sms: int) -> int:
    """Blocks of the persistent grid of the product (M, K) x (N, K)^T at
    ``width``-column tiles: one an SM, or one a tile where there are
    fewer."""
    return min(-(-m // GEMM_ROWS) * -(-n // width), sms)


@functools.lru_cache(maxsize=256)
def packed_gemm_maps(*products: Tuple) -> ctypes.Array:
    """Each product (a ``GemmProduct``, or its first six fields) in order,
    packed for the C launcher (``csrc/mlp_gemm.cuh · kGemmMapsSize`` values
    a product): its four ``gemm_maps`` at its ``gemm_width``, then its
    ``gemm_grid``. The SM count is read once, by the caller, for both."""
    values = []
    for product in products:
        p = GemmProduct(*product)
        width = gemm_width(p.m, p.n, p.k, p.ln, p.residual, p.sms,
                           p.a_bytes, p.w192)
        values += [v for g in gemm_maps(p.m, p.n, p.k, width, p.a_bytes,
                                        p.out_bytes, p.sc_bytes)
                   for v in g.pack()]
        values.append(gemm_grid(p.m, p.n, width, p.sms))
    return (ctypes.c_int64 * len(values))(*values)


def gemm_route(*matrices: torch.Tensor, ln_depth: int = 0,
               f32: Tuple[torch.Tensor, ...] = ()) -> bool:
    """Whether the TMA + wgmma body takes these operands (else the mma.sync
    body runs): ``matrices`` bf16 and ``f32`` (an f32 A of the norm
    prologue, an f32 shortcut or output) f32, each a non-empty contiguous
    2-D matrix (``gemm_maps`` reads them so) whose rows are a multiple of 16
    bytes (TMA's row stride: 8 bf16 or 4 f32 columns) and whose base is
    16-byte aligned; with the norm prologue over ``ln_depth`` columns, at
    most LN_MAX_DEPTH of them."""
    if ln_depth > LN_MAX_DEPTH:
        return False

    def takes(t, dtype):
        return (t.dtype == dtype and t.dim() == 2 and t.numel() > 0
                and t.is_contiguous() and t.shape[1] * t.element_size() % 16 == 0
                and t.data_ptr() % 16 == 0)

    return (all(takes(t, torch.bfloat16) for t in matrices)
            and all(takes(t, torch.float32) for t in f32))


@functools.lru_cache(maxsize=8)
def sm_count(device_index: int) -> int:
    """The SMs of CUDA device ``device_index`` (the persistent grid's
    blocks)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The talking-head attention's Hopper bodies (csrc/cait_attention.cu,
# cait_attention_bwd.cu; cait_attention_common.cuh · namespace tc): 64-row
# query tiles, stages of CAIT_KEYS keys, every head of a block in shared
# memory, up to CAIT_MAX_HEADS heads of one 64-column chunk.
CAIT_KEYS = 16
CAIT_MAX_HEADS = 8
CAIT_MAX_HEAD_DIM = TILE


def cait_route(nb_heads: int, *tensors: torch.Tensor) -> bool:
    """Whether the talking-head kernels take these operands (qkv, and g for
    the backward; the wrappers allocate out and dqkv contiguous) on their
    TMA + wgmma bodies, else the mma.sync or f32 bodies run: bf16, each
    contiguous and 16-byte aligned, qkv (B, N, 3 H d) with H <= 8 heads of
    d <= 64 (every registered CaiT below cait_m36, and the golden
    fixture's d = 8)."""
    qkv = tensors[0]
    if (qkv.dim() != 3 or nb_heads < 1 or nb_heads > CAIT_MAX_HEADS
            or qkv.shape[-1] % (3 * nb_heads)):
        return False
    d = qkv.shape[-1] // (3 * nb_heads)
    return 0 < d <= CAIT_MAX_HEAD_DIM and d % 8 == 0 and all(
        t.dtype == torch.bfloat16 and t.is_contiguous()
        and t.data_ptr() % 16 == 0 for t in tensors)


def cait_maps(b: int, n: int, nb_heads: int, d: int):
    """(rows, keys, out) of the talking-head bodies: qkv (B, N, 3*H*d) as
    ``fused_mha_maps`` reads it, in boxes of 64 rows (a block's own q or g
    tiles, and the backward's streamed ones) and of CAIT_KEYS rows (a key
    stage of one head's k or v), and out (or g) as (d, H, N, B) in 64-row
    boxes."""
    rows, out = fused_mha_maps(b, n, nb_heads, d)
    keys = TensorMapGeometry(dims=rows.dims, strides=rows.strides,
                             box=(TILE, 1, 1, CAIT_KEYS, 1))
    return rows, keys, out


def cait_scratch_cols(n: int) -> int:
    """The row length of the backward's scratch of a and draw: N rounded up
    to 8 elements, the 16 bytes TMA needs between rows."""
    return -(-n // 8) * 8


def cait_scratch_map(b: int, n: int, nb_heads: int) -> TensorMapGeometry:
    """The talking-head backward's bf16 scratch (2, B, H, N,
    ``cait_scratch_cols(N)``) of a (part 0) and draw (part 1) as (N, N, H,
    2 B): a (64, 64, 1, 1) box at (k, q, h, part * B + b) is keys k... of
    query rows q... of head h of image b; zeros past N both ways, so the
    columns past N are never read."""
    e, cols = ELEM_BYTES, cait_scratch_cols(n)
    return TensorMapGeometry(dims=(n, n, nb_heads, 2 * b),
                             strides=(e * cols, e * cols * n,
                                      e * cols * n * nb_heads),
                             box=(TILE, TILE, 1, 1))


@functools.lru_cache(maxsize=256)
def packed_cait_maps(b: int, n: int, nb_heads: int, d: int,
                     backward: bool = False) -> ctypes.Array:
    """``cait_maps`` of a bf16 call, packed; with ``backward`` the scratch
    map after them."""
    maps = cait_maps(b, n, nb_heads, d)
    if backward:
        maps = (*maps, cait_scratch_map(b, n, nb_heads))
    return geometry_array(*maps)


# The window attention's Hopper bodies (csrc/window_mha.cu,
# window_mha_bwd.cu; window_mha_common.cuh): one 64-row tile a window, one
# 64-column chunk a head; a block owns one head and a group of its windows.


def window_route(n: int, d: int, *tensors: torch.Tensor) -> bool:
    """Whether the window attention's TMA + wgmma bodies take a call with
    windows of ``n`` tokens and heads of ``d`` columns on these operands (q,
    k and v for the forward; qkv and g for the backward; the wrappers
    allocate out and dqkv contiguous), else the first bodies run: bf16,
    N <= 64 and d a multiple of 8 up to 64 (every registered Swin at window
    7, d = 32, and ``hf_swin``'s N = 16, d = 8), each operand's base on a
    16-byte boundary, its last dimension unit-stride and its other strides
    whole 16 bytes (TMA's rules; the three slices of a packed qkv keep
    them)."""
    if not (0 < n <= TILE and 0 < d <= TILE and d % 8 == 0):
        return False
    return all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
               and t.stride(-1) == 1
               and all(s * ELEM_BYTES % 16 == 0 for s in t.stride()[:-1])
               for t in tensors)


def window_map(bw: int, n: int, nb_heads: int, d: int,
               stride: Tuple[int, int]) -> TensorMapGeometry:
    """A (BW, N, H*d) operand with element strides ``stride`` (window, row;
    unit along the last dim) as (d, H, N, BW): a (64, 1, 64, 1) box at
    (0, h, 0, r) is head h of window r, zeros past d and past N."""
    e = ELEM_BYTES
    return TensorMapGeometry(dims=(d, nb_heads, n, bw),
                             strides=(e * d, e * stride[1], e * stride[0]),
                             box=(TILE, 1, TILE, 1))


def window_maps(bw: int, n: int, nb_heads: int, d: int, *strides):
    """(q, k, v) of the forward, each with its own (window, row) strides.
    The kernels write their outputs by plain stores, not through maps."""
    return tuple(window_map(bw, n, nb_heads, d, s) for s in strides)


def window_group(bw: int, nb_heads: int, sms: int) -> int:
    """Windows a block of the Hopper bodies walks: the windows of a head in
    groups, as many groups as make one block an SM at most
    (``sms // nb_heads`` a head, at least one)."""
    groups = max(1, min(bw, sms // nb_heads))
    return -(-bw // groups)


@functools.lru_cache(maxsize=256)
def packed_window_maps(bw: int, n: int, nb_heads: int, d: int,
                       q_stride: Tuple[int, int], k_stride: Tuple[int, int],
                       v_stride: Tuple[int, int], sms: int) -> ctypes.Array:
    """``window_maps`` of a bf16 forward, packed, then its
    ``window_group``."""
    maps = window_maps(bw, n, nb_heads, d, q_stride, k_stride, v_stride)
    values = [v for m in maps for v in m.pack()]
    values.append(window_group(bw, nb_heads, sms))
    return (ctypes.c_int64 * len(values))(*values)


def window_bwd_maps(bw: int, n: int, nb_heads: int, d: int,
                    qkv_stride: Tuple[int, int]):
    """(qkv, g) of the backward: qkv (BW, N, 3*H*d), its last dim in (3,
    H, d) order, through its own (window, row) strides as (d, H, 3, N, BW),
    so that a (64, 1, 1, 64, 1) box at (0, h, part, 0, r) is head h of
    window r's q (part 0), k (1) or v (2); g (BW, N, H*d) contiguous as
    ``window_map``."""
    e = ELEM_BYTES
    qkv = TensorMapGeometry(
        dims=(d, nb_heads, 3, n, bw),
        strides=(e * d, e * nb_heads * d, e * qkv_stride[1],
                 e * qkv_stride[0]),
        box=(TILE, 1, 1, TILE, 1))
    return qkv, window_map(bw, n, nb_heads, d,
                           (n * nb_heads * d, nb_heads * d))


@functools.lru_cache(maxsize=256)
def packed_window_bwd_maps(bw: int, n: int, nb_heads: int, d: int,
                           qkv_stride: Tuple[int, int]) -> ctypes.Array:
    """``window_bwd_maps`` of a bf16 backward, packed."""
    return geometry_array(*window_bwd_maps(bw, n, nb_heads, d, qkv_stride))


# pvt_sra's Hopper body (csrc/pvt_sra.cu): 64-row tiles of x, one 64 x 64
# tile each of k, v, wq and wp; a persistent block an SM walks a run of
# consecutive tiles in image order.
SRA_MAX_DIM = TILE
SRA_MAX_KEYS = TILE


def sra_route(x: torch.Tensor, kv: torch.Tensor, wq: torch.Tensor,
              wp: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether ``pvt_sra``'s TMA + wgmma body takes these operands, else the
    first bodies run: bf16; x (B, N, C) and out contiguous with C a multiple
    of 16 up to SRA_MAX_DIM; kv (B, S, 2C) with S up to SRA_MAX_KEYS, its
    rows dense and its batch and row strides whole 16 bytes; wq and wp
    contiguous; every base on a 16-byte boundary. Every registered PVT and
    PVTv2 takes it at its single-head stage 1 at 224 (C = 64, or 32 for
    pvt_v2_b0; S = 49, after the 7x7 pool too)."""
    if x.dim() != 3 or kv.dim() != 3:
        return False
    c, s = x.shape[2], kv.shape[1]
    if not (0 < c <= SRA_MAX_DIM and c % 16 == 0 and 0 < s <= SRA_MAX_KEYS):
        return False
    operands = (x, kv, wq, wp, out)
    return (all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
                for t in operands)
            and all(t.is_contiguous() for t in (x, wq, wp, out))
            and kv.stride(2) == 1
            and all(st * ELEM_BYTES % 16 == 0 for st in kv.stride()[:2]))


def sra_maps(b: int, n: int, s: int, c: int, kv_stride: Tuple[int, int]):
    """(x, kv, wq, wp) of the Hopper body: x (B, N, C) contiguous as (C, N,
    B), a (64, 64, 1) box at (0, r, b) the tile of rows r... of image b,
    zeros past N and past C; kv (B, S, 2C) through its (batch, row) element
    strides as (2C, S, B), a (64, 64, 1) box at (0, 0, b) image b's k and
    at (C, 0, b) its v, zeros past S (and past 2C: at C = 32 the v box's
    last 32 columns); wq and wp (C, C) as one 64 x 64 box each, zeros past
    C. The kernel stores the output (x's layout) through x's geometry."""
    e = ELEM_BYTES
    box = (TILE, TILE, 1)
    x = TensorMapGeometry(dims=(c, n, b), strides=(e * c, e * c * n), box=box)
    kv = TensorMapGeometry(dims=(2 * c, s, b),
                           strides=(e * kv_stride[1], e * kv_stride[0]),
                           box=box)
    w = matrix_map(c, c, TILE)
    return x, kv, w, w


def sra_grid(b: int, n: int, sms: int) -> int:
    """Blocks of the Hopper body: one an SM, or one a tile where there are
    fewer than SMs."""
    return min(b * -(-n // TILE), sms)


@functools.lru_cache(maxsize=256)
def packed_sra_maps(b: int, n: int, s: int, c: int,
                    kv_stride: Tuple[int, int], sms: int) -> ctypes.Array:
    """``sra_maps`` packed, then ``sra_grid``."""
    values = [v for m in sra_maps(b, n, s, c, kv_stride) for v in m.pack()]
    values.append(sra_grid(b, n, sms))
    return (ctypes.c_int64 * len(values))(*values)


# ln_dense's backward on Hopper (csrc/ln_dense.cu · bwd_gemm and
# ln_dense_dx_rows_kernel): the two products on 128 x width tiles, width one
# of LN_BWD_WIDTHS; dx in blocks of LN_BWD_ROWS whole rows, C up to
# LN_BWD_MAX_DIM (a warp a row, 256 columns a chunk, 4 chunks).
LN_BWD_ROWS = 64
LN_BWD_MAX_DIM = 1024
LN_BWD_WIDTHS = (128, 192, 256)
# The cost model of ln_dense_bwd_plan, in units of one 64-deep k step of a
# one-column-wide tile: a k step of a width-w tile costs w + _STEP_COST (the
# A box's load and the ring's round trip, whatever the width); an element
# of the dW partials, written once and read once by the fixed-order sum,
# costs _PART_COST (8 bytes at 3.35 TB/s, 2.4 ps, against 2.9 ns a unit).
# Fitted on an H100 by scripts/perf/torch_ln_dense_bwd_plans.py: a 128 x 128
# k step of dW took 0.56 us where a 128 x 256 one took about 0.85; without
# _STEP_COST the model picked one slice of 128-column tiles at ViT-B/16's
# LN1 -> qkv, 7% slower than two slices of 256-column ones.
_STEP_COST = 64
_PART_COST = 8e-4


def ln_dense_bwd_route(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       dx: torch.Tensor) -> bool:
    """Whether ``ln_dense``'s backward takes its TMA + wgmma body on these
    operands (x (M, C), the weight (O, C) in x's dtype, g (M, O), dx; the
    wrapper allocates the scratch), else the first body runs: bf16, each a
    non-empty contiguous matrix on a 16-byte boundary, C and O multiples of
    8 (TMA's 16-byte rows), C up to LN_BWD_MAX_DIM. ViT-B/16's and ViT-L's
    widths take it; f32, C = 100 or O = 36 and C = 3,072 do not."""
    if x.dim() != 2 or w.dim() != 2:
        return False
    (m, c), o = x.shape, w.shape[0]
    if not (m > 0 and 0 < c <= LN_BWD_MAX_DIM and c % 8 == 0
            and o > 0 and o % 8 == 0):
        return False
    return all(t.dtype == torch.bfloat16 and t.dim() == 2
               and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, w, g, dx))


class LnBwdPlan(NamedTuple):
    """The tiles of the backward's two products on ``sms`` SMs: dz's
    width and persistent blocks; dW's width, blocks, slices of M and rows
    a slice (a multiple of 64)."""

    dz_width: int
    dz_blocks: int
    dw_width: int
    dw_blocks: int
    splits: int
    per_split: int


def _rounds(tiles: int, sms: int) -> int:
    return -(-tiles // sms)


def ln_dense_bwd_dw_costs(m: int, c: int, o: int, sms: int) -> list:
    """dW = g^T z, (O, C) over M in slices: every (cost, width, splits, rows
    a slice) of the widths and slice counts (1-32), cheapest first, the
    wider and then the fewer slices on a tie; the cost is rounds x (width
    + ``_STEP_COST``) x k steps a slice plus the partials' traffic
    (``_PART_COST`` an element of (splits, O, C) f32 written and read);
    every slice at least one 64-row step and none empty. The first is the
    plan's
    (``scripts/perf/torch_ln_dense_bwd_plans.py`` times the next ones
    against it)."""
    steps = -(-m // TILE)
    costs = set()
    for width in LN_BWD_WIDTHS:
        tiles = -(-o // GEMM_ROWS) * -(-c // width)
        for s in range(1, min(32, steps) + 1):
            per_split = -(-steps // s) * TILE
            splits = -(-m // per_split)
            costs.add((_rounds(tiles * splits, sms) * (width + _STEP_COST)
                       * (per_split // TILE) + _PART_COST * splits * o * c,
                       width, splits, per_split))
    return sorted(costs, key=lambda k: (k[0], -k[1], k[2], -k[3]))


@functools.lru_cache(maxsize=256)
def ln_dense_bwd_plan(m: int, c: int, o: int, sms: int) -> LnBwdPlan:
    """dz = g w, (M, C) over depth O: the width whose rounds of 128-row tiles
    cost least (rounds x width), the wider on a tie; 192 at ViT-B/16's
    C = 768 (396 tiles: three whole rounds of 132). dW: the first of
    ``ln_dense_bwd_dw_costs``."""
    m_tiles = -(-m // GEMM_ROWS)
    dz_width = min(LN_BWD_WIDTHS, key=lambda w: (
        _rounds(m_tiles * -(-c // w), sms) * w, -w))
    _, dw_width, splits, per_split = ln_dense_bwd_dw_costs(m, c, o, sms)[0]
    dw_tiles = -(-o // GEMM_ROWS) * -(-c // dw_width) * splits
    return LnBwdPlan(dz_width, min(m_tiles * -(-c // dz_width), sms),
                     dw_width, min(dw_tiles, sms), splits, per_split)


def ln_dense_bwd_maps(m: int, c: int, o: int):
    """(dz's a, dz's b, dW's a, dW's b): g (M, O) in (64-column, 128-row)
    boxes, K-major A of dz = g w; w (O, C) in 64 x 64 boxes, an MN-major B
    (a box at (n, k) is columns n... of rows k...); g again in 64 x 64
    boxes, the M-major A of dW = g^T z (a box at (o, r) is g's columns
    o... of rows r...); z (M, C) in 64 x 64 boxes, an MN-major B. Zeros
    past every edge stand in for the tails of M, C, O and the last slice."""
    return (matrix_map(m, o, GEMM_ROWS), matrix_map(o, c, TILE),
            matrix_map(m, o, TILE), matrix_map(m, c, TILE))


@functools.lru_cache(maxsize=256)
def packed_ln_dense_bwd_maps(m: int, c: int, o: int, sms: int) -> ctypes.Array:
    """``ln_dense_bwd_maps`` packed, then the ``ln_dense_bwd_plan`` (dz's
    blocks and width, dW's blocks, width, slices and rows a slice), for
    ``csrc/ln_dense.cu · kBwdPlan``."""
    plan = ln_dense_bwd_plan(m, c, o, sms)
    values = [v for g in ln_dense_bwd_maps(m, c, o) for v in g.pack()]
    values += [plan.dz_blocks, plan.dz_width, plan.dw_blocks, plan.dw_width,
               plan.splits, plan.per_split]
    return (ctypes.c_int64 * len(values))(*values)

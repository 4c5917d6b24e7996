"""The TMA tensor maps of the Hopper kernels, emulated on the CPU.

``tfimm_tpu_torch/ops/kernels/tma.py`` computes each map's dims, byte
strides and box; the kernels (``csrc/fused_mha.cu``, ``fused_mha_bwd.cu``,
``flash_attention.cu``, ``flash_attention_relpos.cu``) pick the boxes'
coordinates. Here a box is read as TMA reads it, with ``torch.as_strided``
over the tensor's storage from the map's base and zeros wherever the box
runs past the dims, at the coordinates the kernels use. The boxes must give
exactly ``fused_mha``'s q, k and v heads (``_split_qkv``), its backward's g
heads, the flash kernel's (B, H, N, d) tiles and the rel-pos kernel's q, k
and v tiles, with zeros past N and past d; the output maps, written box by
box with the part past the dims left out, must give ``fused_mha``'s
(B, N, H*d) layout, its backward's packed dqkv and the flash kernel's
output. The hardware rules the maps must keep are checked beside them. The GEMM
maps of ``csrc/mlp_gemm.cuh`` (``convnext_mlp``, ``convnext_block``,
``ln_dense``'s forward) must tile A, B, the shortcut and the output
exactly at ragged M, N and K, and ``gemm_route`` must send each shape to
the body that takes it. The talking-head maps (``cait_maps``,
``cait_scratch_map``) must give the heads' 16-key stages and the backward
scratch's 64 x 64 tiles of a and draw, and ``cait_route`` must send each
call to the body that takes it. The window attention's maps
(``window_maps``, ``window_bwd_maps``) must give each head of each window,
its output path must write the output and the packed dqkv exactly, and
``window_route`` must send each call to the body that takes it.
``pvt_sra``'s maps (``sra_maps``) must give each block's x tiles and each
image's k and v, zeros past N, S and C, through which the four products
give the function; ``ln_dense``'s backward maps (``ln_dense_bwd_maps``)
must give every tile of dz = g w and of each slice's dW = g^T z, zeros
past M, C, O and the last slice; ``sra_route`` and ``ln_dense_bwd_route``
must send each call to the body that takes it.
"""

import itertools

import pytest
import torch

import tfimm_tpu_torch
from tfimm_tpu_torch.architectures import pvt as pvt_module
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.ops.kernels.flash_attention import _rows
from tfimm_tpu_torch.ops.kernels.fused_mha import (
    _heads,
    _merge_heads,
    _split_qkv,
)
from tfimm_tpu_torch.ops.kernels.poolformer_block import (
    poolformer_gemm_products,
)
from tfimm_tpu_torch.ops.kernels.swin_block import swin_gemm_products
from tfimm_tpu_torch.ops.kernels.pvt_sra import pvt_sra_reference
from tfimm_tpu_torch.ops.kernels.tma import (
    CAIT_KEYS,
    ELEM_BYTES,
    F32_BYTES,
    GEMM_ROWS,
    GEMM_WIDTHS,
    LN_BWD_MAX_DIM,
    LN_BWD_WIDTHS,
    LN_MAX_DEPTH,
    SWIZZLE_BYTES,
    TILE,
    cait_maps,
    cait_route,
    cait_scratch_cols,
    cait_scratch_map,
    fused_mha_maps,
    gemm_grid,
    gemm_maps,
    gemm_route,
    gemm_width,
    heads_map,
    ln_dense_bwd_dw_costs,
    ln_dense_bwd_maps,
    ln_dense_bwd_plan,
    ln_dense_bwd_route,
    matrix_map,
    packed_cait_maps,
    packed_gemm_maps,
    packed_fused_mha_maps,
    packed_heads_maps,
    packed_ln_dense_bwd_maps,
    packed_operand_maps,
    packed_rows_maps,
    packed_sra_maps,
    packed_window_bwd_maps,
    packed_window_maps,
    padded_rows,
    rows_map,
    sra_grid,
    sra_maps,
    sra_route,
    window_bwd_maps,
    window_group,
    window_maps,
    window_route,
)


def _check_rules(m, elem_bytes=ELEM_BYTES):
    """cuTensorMapEncodeTiled's rules for a tiled map of ``elem_bytes``
    elements (bf16 or f32) with the 128-byte swizzle: rank 1-5, strides
    multiples of 16 bytes, boxes of at most 256 elements, an inner box of
    16-128 bytes."""
    assert 1 <= len(m.dims) <= 5
    assert len(m.strides) == len(m.dims) - 1 and len(m.box) == len(m.dims)
    assert all(s % 16 == 0 and 0 < s < 2 ** 40 for s in m.strides)
    assert all(0 < b <= 256 for b in m.box)
    assert m.box[0] * elem_bytes % 16 == 0 and m.box[0] * elem_bytes <= 128


def _ranges(m, coords):
    """Per dimension (innermost first): the in-bounds part of the box at
    ``coords`` in the tensor and in the box."""
    lo = [max(c, 0) for c in coords]
    hi = [min(c + b, d) for c, b, d in zip(coords, m.box, m.dims)]
    return lo, hi


def _elem_strides(m, elem_bytes=ELEM_BYTES):
    return [1] + [s // elem_bytes for s in m.strides]


def tma_load(flat, m, coords, elem_bytes=ELEM_BYTES):
    """The box at ``coords`` (innermost first) of the map ``m`` of
    ``elem_bytes`` elements over the elements ``flat`` from the map's base,
    outermost dim first; elements out of bounds are zeros."""
    box = torch.zeros(m.box[::-1], dtype=flat.dtype)
    lo, hi = _ranges(m, coords)
    if any(h <= l for l, h in zip(lo, hi)):
        return box
    strides = _elem_strides(m, elem_bytes)
    view = torch.as_strided(flat, [h - l for l, h in zip(lo, hi)][::-1],
                            strides[::-1],
                            flat.storage_offset()
                            + sum(l * s for l, s in zip(lo, strides)))
    box[tuple(slice(l - c, h - c)
              for l, h, c in zip(lo, hi, coords))[::-1]] = view
    return box


def tma_store(flat, m, coords, box, elem_bytes=ELEM_BYTES):
    """Write ``box`` at ``coords`` through the map ``m`` (of ``elem_bytes``
    elements) into ``flat``, leaving out the elements out of bounds."""
    lo, hi = _ranges(m, coords)
    if any(h <= l for l, h in zip(lo, hi)):
        return
    strides = _elem_strides(m, elem_bytes)
    view = torch.as_strided(flat, [h - l for l, h in zip(lo, hi)][::-1],
                            strides[::-1],
                            flat.storage_offset()
                            + sum(l * s for l, s in zip(lo, strides)))
    view.copy_(box[tuple(slice(l - c, h - c)
                         for l, h, c in zip(lo, hi, coords))[::-1]])


def _tiles(n):
    """Row tiles a kernel touches: its blocks own 128 rows (two 64-row q
    tiles), its K/V ring walks 64-key tiles."""
    return range(2 * -(-n // (2 * TILE)))


def _chunks(d):
    return range(1 if d <= TILE else 2)


def _padded(x, rows, cols):
    """x (..., N, d) zero-padded to (..., rows, cols)."""
    out = torch.zeros(*x.shape[:-2], rows, cols, dtype=x.dtype)
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


MHA_N = [1, 17, 64, 65, 196, 197, 256, 257, 1023]
MHA_D = [8, 16, 32, 48, 64, 80, 128]
MHA_H = [1, 3, 12, 16]


@pytest.mark.parametrize("n,d", list(itertools.product(MHA_N, MHA_D)))
def test_fused_mha_boxes_give_the_heads(n, d):
    """At every H: each (64, 1, 1, 64, 1) box at (64 c, h, part, 64 r, b) is
    rows 64 r... and columns 64 c... of head h's q, k or v of image b, with
    zeros past N and d. The next image's rows (all far from zero here) never
    show up in a box that runs past N."""
    b = 2
    gen = torch.Generator().manual_seed(n * 131 + d)
    for h in MHA_H:
        qkv = (torch.randn(b, n, 3 * h * d, generator=gen) + 10.0).bfloat16()
        qkv_map, _ = fused_mha_maps(b, n, h, d)
        _check_rules(qkv_map)
        flat = qkv.reshape(-1)
        rows, cols = TILE * len(_tiles(n)), TILE * len(_chunks(d))
        for part, want in enumerate(_split_qkv(qkv, h)):
            got = torch.zeros(b, h, rows, cols, dtype=qkv.dtype)
            for bi, hi, r, c in itertools.product(range(b), range(h), _tiles(n),
                                                  _chunks(d)):
                box = tma_load(flat, qkv_map, (TILE * c, hi, part, TILE * r, bi))
                # Outermost first: (B, N, 3, H, d) = (1, 64, 1, 1, 64), so
                # shared memory holds 64 rows of 64 columns.
                assert box.shape == (1, TILE, 1, 1, TILE)
                got[bi, hi, TILE * r:TILE * (r + 1),
                    TILE * c:TILE * (c + 1)] = box[0, :, 0, 0]
            assert torch.equal(got, _padded(want.bfloat16(), rows, cols)), (
                h, part)


@pytest.mark.parametrize("n,d", [(1, 8), (17, 80), (197, 64), (257, 128),
                                 (65, 48)])
def test_fused_mha_out_boxes_write_the_merged_heads(n, d):
    """Each consumer's (64, 1, 64, 1) box at (64 c, h, 64 r, b), written with
    the part past N and d left out, lands in (B, N, H*d) exactly where
    ``fused_mha`` puts head h's rows; nothing else is written."""
    b, h = 3, 3
    gen = torch.Generator().manual_seed(n + d)
    heads = torch.randn(b, h, n, d, generator=gen).bfloat16()
    _, out_map = fused_mha_maps(b, n, h, d)
    _check_rules(out_map)
    rows, cols = TILE * len(_tiles(n)), TILE * len(_chunks(d))
    # The tiles as a consumer holds them, with garbage in the padding.
    tiles = torch.full((b, h, rows, cols), 7.0, dtype=heads.dtype)
    tiles[:, :, :n, :d] = heads
    out = torch.full((b * n * h * d + 64,), -1.0, dtype=heads.dtype)
    for bi, hi, r, c in itertools.product(range(b), range(h), _tiles(n),
                                          _chunks(d)):
        box = tiles[bi, hi, TILE * r:TILE * (r + 1), TILE * c:TILE * (c + 1)]
        tma_store(out, out_map, (TILE * c, hi, TILE * r, bi),
                  box.reshape(1, TILE, 1, TILE))
    assert torch.equal(out[:b * n * h * d].reshape(b, n, h * d),
                       _merge_heads(heads))
    assert bool((out[b * n * h * d:] == -1.0).all())


RELPOS_GRIDS = [(64, 64), (14, 14), (48, 64), (7, 7), (1, 1)]


@pytest.mark.parametrize("d", [64, 80, 8, 128])
@pytest.mark.parametrize("gh,gw", RELPOS_GRIDS)
def test_relpos_boxes_give_the_tiles(gh, gw, d):
    """q, k and v as strided views of one packed (B, N, 3 d) tensor, as a
    fused projection hands them over: each (64, 64, 1) box at (64 c, 64 r,
    b) of a view's (d, N, B) map is rows 64 r... and columns 64 c... of row
    b of that view, zeros past N and d; the out map of a contiguous
    (B, N, d) tensor writes it back."""
    b, n = 3, gh * gw
    gen = torch.Generator().manual_seed(gh * gw + d)
    packed = (torch.randn(b, n, 3 * d, generator=gen) + 10.0).bfloat16()
    views = [packed[..., j * d:(j + 1) * d] for j in range(3)]
    rows, cols = TILE * len(_tiles(n)), TILE * len(_chunks(d))
    for view in views:
        m = rows_map(view.shape, view.stride())
        _check_rules(m)
        flat = packed.reshape(-1)[view.storage_offset():]
        got = torch.zeros(b, rows, cols, dtype=view.dtype)
        for bi, r, c in itertools.product(range(b), _tiles(n), _chunks(d)):
            box = tma_load(flat, m, (TILE * c, TILE * r, bi))
            assert box.shape == (1, TILE, TILE)
            got[bi, TILE * r:TILE * (r + 1), TILE * c:TILE * (c + 1)] = box[0]
        assert torch.equal(got, _padded(view, rows, cols))

        out = torch.zeros(b, n, d, dtype=view.dtype)
        out_map = rows_map(out.shape, out.stride())
        _check_rules(out_map)
        for bi, r, c in itertools.product(range(b), _tiles(n), _chunks(d)):
            tma_store(out.reshape(-1), out_map, (TILE * c, TILE * r, bi),
                      got[bi, TILE * r:TILE * (r + 1),
                          TILE * c:TILE * (c + 1)][None])
        assert torch.equal(out, view)


@pytest.mark.parametrize("n,d", [(1, 8), (17, 80), (197, 64), (257, 128),
                                 (65, 48)])
def test_fused_mha_maps_read_g_and_write_dqkv(n, d):
    """The backward reads g through the forward's out geometry: its (64, 1,
    64, 1) boxes at (64 c, h, 64 r, b) are head h's rows of g as
    ``fused_mha_bwd_reference`` splits it (``_heads``), zeros past N and d.
    It writes dqkv through the qkv geometry: boxes of dq, dk and dv written
    at (64 c, h, part, 64 r, b) give exactly the packed layout
    ``fused_mha_bwd_reference`` returns, and nothing else."""
    b, h = 2, 3
    gen = torch.Generator().manual_seed(7 * n + d)
    g = (torch.randn(b, n, h * d, generator=gen) + 10.0).bfloat16()
    dqkv_map, g_map = fused_mha_maps(b, n, h, d)
    for m in (dqkv_map, g_map):
        _check_rules(m)
    rows, cols = TILE * len(_tiles(n)), TILE * len(_chunks(d))
    got = torch.zeros(b, h, rows, cols, dtype=g.dtype)
    for bi, hi, r, c in itertools.product(range(b), range(h), _tiles(n),
                                          _chunks(d)):
        box = tma_load(g.reshape(-1), g_map, (TILE * c, hi, TILE * r, bi))
        assert box.shape == (1, TILE, 1, TILE)
        got[bi, hi, TILE * r:TILE * (r + 1),
            TILE * c:TILE * (c + 1)] = box[0, :, 0]
    assert torch.equal(got, _padded(_heads(g, h, g.dtype), rows, cols))

    grads = [torch.randn(b, h, n, d, generator=gen).bfloat16()
             for _ in range(3)]
    dqkv = torch.full((b * n * 3 * h * d + 64,), -1.0, dtype=g.dtype)
    for part, grad in enumerate(grads):
        tiles = torch.full((b, h, rows, cols), 7.0, dtype=g.dtype)
        tiles[:, :, :n, :d] = grad
        for bi, hi, r, c in itertools.product(range(b), range(h), _tiles(n),
                                              _chunks(d)):
            box = tiles[bi, hi, TILE * r:TILE * (r + 1),
                        TILE * c:TILE * (c + 1)]
            tma_store(dqkv, dqkv_map, (TILE * c, hi, part, TILE * r, bi),
                      box.reshape(1, TILE, 1, 1, TILE))
    want = torch.cat([_merge_heads(t) for t in grads], dim=-1)
    assert torch.equal(dqkv[:b * n * 3 * h * d].reshape(b, n, 3 * h * d), want)
    assert bool((dqkv[b * n * 3 * h * d:] == -1.0).all())


FLASH_N = [1, 63, 64, 65, 127, 128, 129, 1025]
FLASH_D = [8, 64, 80, 128]


def _flash_operands(kind, b, h, n, d, gen):
    """q, k, v (B, H, N, d) as the flash wrapper hands them to the kernel:
    contiguous tensors, the strided views of a packed qkv that
    ``flash_attention_packed`` takes, or (B, N, d) tensors with H = 1."""
    if kind == "contiguous":
        return [(torch.randn(b, h, n, d, generator=gen) + 10.0).bfloat16()
                for _ in range(3)]
    if kind == "packed":
        qkv = (torch.randn(b, n, 3 * h * d, generator=gen) + 10.0).bfloat16()
        return list(qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
    return [_rows((torch.randn(b * h, n, d, generator=gen) + 10.0).bfloat16())
            for _ in range(3)]


@pytest.mark.parametrize("kind", ["contiguous", "packed", "one_head"])
@pytest.mark.parametrize("n,d", list(itertools.product(FLASH_N, FLASH_D)))
def test_flash_heads_maps_give_each_heads_tiles(kind, n, d):
    """Each operand's (64, 64, 1, 1) box at (64 c, 64 r, h, b) of its
    (d, N, H, B) map is rows 64 r... and columns 64 c... of head h of image
    b, zeros past N and d: never another head's or image's rows, which are
    all far from zero here. The output, allocated as the wrapper allocates
    it (``empty_like`` of q: (B, N, H, d) for the packed route), written box
    by box through its own map with the part past N and d left out, is
    exactly the heads' tiles and nothing else of its storage."""
    b, h = 2, 3
    gen = torch.Generator().manual_seed(n * 17 + d)
    operands = _flash_operands(kind, b, h, n, d, gen)
    shape = tuple(operands[0].shape)
    rows, cols = TILE * len(_tiles(n)), TILE * len(_chunks(d))
    for t in operands:
        m = heads_map(shape, t.stride())
        _check_rules(m)
        flat = t.untyped_storage()
        flat = torch.tensor([], dtype=t.dtype).set_(flat).reshape(-1)
        flat = flat[t.storage_offset():]
        got = torch.zeros(*shape[:2], rows, cols, dtype=t.dtype)
        for bi, hi, r, c in itertools.product(range(shape[0]), range(shape[1]),
                                              _tiles(n), _chunks(d)):
            box = tma_load(flat, m, (TILE * c, TILE * r, hi, bi))
            assert box.shape == (1, 1, TILE, TILE)
            got[bi, hi, TILE * r:TILE * (r + 1),
                TILE * c:TILE * (c + 1)] = box[0, 0]
        assert torch.equal(got, _padded(t, rows, cols))

    q = operands[0]
    out = torch.empty_like(q)
    if kind == "packed":   # o comes back in the layout of q: (B, N, H, d)
        assert out.transpose(1, 2).is_contiguous()
    want = torch.randn(shape, generator=gen).bfloat16()
    tiles = torch.full((*shape[:2], rows, cols), 7.0, dtype=want.dtype)
    tiles[..., :n, :d] = want
    storage = torch.full((out.numel() + 64,), -1.0, dtype=out.dtype)
    view = torch.as_strided(storage, out.shape, out.stride())
    out_map = heads_map(shape, out.stride())
    _check_rules(out_map)
    for bi, hi, r, c in itertools.product(range(shape[0]), range(shape[1]),
                                          _tiles(n), _chunks(d)):
        box = tiles[bi, hi, TILE * r:TILE * (r + 1), TILE * c:TILE * (c + 1)]
        tma_store(storage, out_map, (TILE * c, TILE * r, hi, bi),
                  box.reshape(1, 1, TILE, TILE))
    assert torch.equal(view, want)
    assert bool((storage[out.numel():] == -1.0).all())


def test_packed_maps_are_the_maps_in_order():
    """The int64 values the C launchers read: rank, dims, strides and box in
    5, 4 and 5 slots, map after map; cached per shape."""
    qkv_map, out_map = fused_mha_maps(2, 197, 12, 64)
    got = list(packed_fused_mha_maps(2, 197, 12, 64))
    assert got == qkv_map.pack() + out_map.pack()
    assert got[:15] == [5, 64, 12, 3, 197, 2, 128, 1536, 4608, 907776,
                        64, 1, 1, 64, 1]
    assert packed_fused_mha_maps(2, 197, 12, 64) is packed_fused_mha_maps(
        2, 197, 12, 64)
    x = torch.zeros(4, 10, 3 * 16)[..., 16:32]
    y = torch.zeros(4, 10, 16)
    packed = list(packed_rows_maps(x.shape, x.stride(), y.stride()))
    assert packed == (rows_map(x.shape, x.stride()).pack()
                      + rows_map(y.shape, y.stride()).pack())
    assert packed[:15] == [3, 16, 10, 4, 0, 0, 96, 960, 0, 0, 64, 64, 1, 0, 0]
    qkv = torch.zeros(2, 1025, 3 * 12 * 64)
    q, k = qkv.reshape(2, 1025, 3, 12, 64).permute(2, 0, 3, 1, 4)[:2]
    heads = list(packed_heads_maps(tuple(q.shape), q.stride(), k.stride()))
    assert heads == (heads_map(q.shape, q.stride()).pack()
                     + heads_map(k.shape, k.stride()).pack())
    # (d, N, H, B) with the token, head and image strides of the packed
    # rows, in bytes.
    assert heads[:15] == [4, 64, 1025, 12, 2, 0, 4608, 128, 4723200, 0,
                          64, 64, 1, 1, 0]
    assert packed_heads_maps(tuple(q.shape), q.stride()) is packed_heads_maps(
        tuple(q.shape), q.stride())


def test_heads_maps_are_operand_maps_of_one_shape():
    """``packed_heads_maps`` is ``packed_operand_maps`` with one shape: the
    same cached array; operands of two shapes (the rel-pos backward's rw
    beside (B, 1, N, d) rows) pack each map with its own dims."""
    shape = (2, 1, 4096, 64)
    strides = [(262144, 262144, 64, 1), (786432, 786432, 192, 1)]
    assert packed_heads_maps(shape, *strides) is packed_operand_maps(
        *((shape, s) for s in strides))
    rows = ((2, 1, 4096, 32), (131072, 131072, 32, 1))
    rw = ((2, 1, 4096, 64), (262144, 262144, 64, 1))
    mixed = list(packed_operand_maps(rows, rw))
    assert mixed == heads_map(*rows).pack() + heads_map(*rw).pack()
    assert mixed[1:3] == [32, 4096] and mixed[16:18] == [64, 4096]


# -- The backward kernels (csrc/attention_bwd.cuh) ---------------------------


@pytest.mark.parametrize("kind", ["contiguous", "packed", "one_head"])
@pytest.mark.parametrize("n,d", [(1, 8), (63, 64), (129, 80), (1025, 64),
                                 (65, 128)])
def test_flash_bwd_maps_read_do_and_o_and_write_the_gradients(kind, n, d):
    """The flash backward reads do and o through their own (d, N, H, B)
    maps, as the wrapper hands them over (do contiguous, o in the layout of
    q), and writes dq, dk and dv, allocated as ``empty_like`` of q, box by
    box through theirs: the boxes are each head's tiles with zeros past N
    and d, and the stores give exactly the gradients and nothing else."""
    gen = torch.Generator().manual_seed(5 * n + d)
    q = _flash_operands(kind, 2, 3, n, d, gen)[0]
    shape = tuple(q.shape)
    o = (torch.randn(shape, generator=gen) + 10.0).bfloat16()
    o = torch.empty_like(q).copy_(o)
    do = (torch.randn(shape, generator=gen) + 10.0).bfloat16()
    rows, cols = TILE * len(_tiles(n)), TILE * len(_chunks(d))
    for t in (do, o):
        m = heads_map(shape, t.stride())
        _check_rules(m)
        flat = torch.tensor([], dtype=t.dtype).set_(t.untyped_storage())
        flat = flat.reshape(-1)[t.storage_offset():]
        got = torch.zeros(*shape[:2], rows, cols, dtype=t.dtype)
        for bi, hi, r, c in itertools.product(range(shape[0]), range(shape[1]),
                                              _tiles(n), _chunks(d)):
            box = tma_load(flat, m, (TILE * c, TILE * r, hi, bi))
            got[bi, hi, TILE * r:TILE * (r + 1),
                TILE * c:TILE * (c + 1)] = box[0, 0]
        assert torch.equal(got, _padded(t, rows, cols))
    for _ in range(3):
        grad = torch.empty_like(q)
        want = torch.randn(shape, generator=gen).bfloat16()
        tiles = torch.full((*shape[:2], rows, cols), 7.0, dtype=want.dtype)
        tiles[..., :n, :d] = want
        storage = torch.full((grad.numel() + 64,), -1.0, dtype=grad.dtype)
        m = heads_map(shape, grad.stride())
        _check_rules(m)
        for bi, hi, r, c in itertools.product(range(shape[0]), range(shape[1]),
                                              _tiles(n), _chunks(d)):
            tma_store(storage, m, (TILE * c, TILE * r, hi, bi),
                      tiles[bi, hi, TILE * r:TILE * (r + 1),
                            TILE * c:TILE * (c + 1)].reshape(1, 1, TILE, TILE))
        assert torch.equal(torch.as_strided(storage, grad.shape,
                                            grad.stride()), want)
        assert bool((storage[grad.numel():] == -1.0).all())


@pytest.mark.parametrize("d", [8, 64, 80])
@pytest.mark.parametrize("gh,gw", RELPOS_GRIDS)
def test_relpos_bwd_maps_as_one_head(gh, gw, d):
    """The rel-pos backward hands its (B, N, d) operands to the shared
    kernels as (B, 1, N, d) (``_as_heads``): qs, k, v as strided views of a
    packed tensor, do, out and the gradients contiguous. Each (64, 64, 1, 1)
    box at (64 c, 64 r, 0, b) is rows 64 r... of row b, zeros past N and d;
    the gradients stored box by box are exactly the rows."""
    from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import _as_heads

    b, n = 3, gh * gw
    gen = torch.Generator().manual_seed(gh + 7 * gw + d)
    packed = (torch.randn(b, n, 3 * d, generator=gen) + 10.0).bfloat16()
    views = [packed[..., j * d:(j + 1) * d] for j in range(3)]
    dense = [(torch.randn(b, n, d, generator=gen) + 10.0).bfloat16()
             for _ in range(2)]
    rows, cols = TILE * len(_tiles(n)), TILE * len(_chunks(d))
    for t in views + dense:
        shape, stride = _as_heads(t)
        m = heads_map(shape, stride)
        _check_rules(m)
        flat = torch.tensor([], dtype=t.dtype).set_(t.untyped_storage())
        flat = flat.reshape(-1)[t.storage_offset():]
        got = torch.zeros(b, rows, cols, dtype=t.dtype)
        for bi, r, c in itertools.product(range(b), _tiles(n), _chunks(d)):
            box = tma_load(flat, m, (TILE * c, TILE * r, 0, bi))
            assert box.shape == (1, 1, TILE, TILE)
            got[bi, TILE * r:TILE * (r + 1),
                TILE * c:TILE * (c + 1)] = box[0, 0]
        assert torch.equal(got, _padded(t, rows, cols))
    grad = torch.zeros(b, n, d, dtype=torch.bfloat16)
    want = torch.randn(b, n, d, generator=gen).bfloat16()
    m = heads_map(*_as_heads(grad))
    tiles = _padded(want, rows, cols) + 0
    tiles[:, n:] = 7.0
    for bi, r, c in itertools.product(range(b), _tiles(n), _chunks(d)):
        tma_store(grad.reshape(-1), m, (TILE * c, TILE * r, 0, bi),
                  tiles[bi, TILE * r:TILE * (r + 1),
                        TILE * c:TILE * (c + 1)].reshape(1, 1, TILE, TILE))
    assert torch.equal(grad, want)


@pytest.mark.parametrize("gh", [1, 48, 64, 128])
def test_relpos_bwd_rw_boxes_at_gw_64(gh):
    """At gw = 64 launch B reads rw (B, N, 64) as a TMA box a stage: the
    (64, 64, 1, 1) box at (0, 64 t, 0, b) is rw's rows 64 t... of row b, the
    64 queries of tile t by the 64 keys of a key-grid row."""
    from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import _as_heads

    b, n = 2, gh * TILE
    rw = torch.randn(b, n, TILE, generator=torch.Generator().manual_seed(gh))
    rw = rw.bfloat16()
    m = heads_map(*_as_heads(rw))
    _check_rules(m)
    for bi, t in itertools.product(range(b), range(n // TILE)):
        box = tma_load(rw.reshape(-1), m, (0, TILE * t, 0, bi))
        assert torch.equal(box[0, 0], rw[bi, TILE * t:TILE * (t + 1)])


@pytest.mark.parametrize("n", [1, 49, 63, 64, 65, 196, 1025, 3072, 4096])
def test_backward_scratch_rows(n):
    """The wrappers' f32 statistics scratch (2, R, N rounded up to 64):
    whole 64-row boxes, so that launch B's two 256-byte bulk copies a query
    tile read rows launch A wrote (that it writes the padded rows is held
    on the card, ``test_torch_cuda.py``)."""
    from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
        stats_scratch,
    )

    n_pad = padded_rows(n)
    assert n_pad % TILE == 0 and n <= n_pad < n + TILE
    scratch = stats_scratch(3, n, "cpu")
    assert scratch.shape == (2, 3, n_pad) and scratch.dtype == torch.float32
    assert scratch.is_contiguous()


# -- The GEMM body (csrc/mlp_gemm.cuh · gemm_bf16_wgmma) ---------------------

# (M, N, K): ragged in all three (M = 3137, N = 392, K = 96), ConvNeXt-B's
# stage-3 fc1 with its rows cut, one row, K below one 64-column box, and
# ViT-B/16's LN1 -> qkv at bs2.
GEMM_SHAPES = [(3137, 392, 96), (300, 4096, 1024), (1, 8, 8), (200, 48, 24),
               (394, 2304, 768)]


def _gemm_tiles(m, n, width):
    """The (m0, n0) of every output tile of the persistent walk: the column
    tiles of a row block one after another."""
    n_tiles = -(-n // width)
    return [(t // n_tiles * GEMM_ROWS, t % n_tiles * width)
            for t in range(-(-m // GEMM_ROWS) * n_tiles)]


@pytest.mark.parametrize("width", GEMM_WIDTHS)
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_gemm_boxes_give_every_tile(m, n, k, width):
    """Per output tile and k step, the A box (128 rows at (64 kt, m0)) and
    the B box (``width`` rows at (64 kt, n0)) hold the tile's rows and k
    columns of a and b with zeros past M, N and K; their product summed
    over the k steps is the tile of a @ b^T, and nothing past M or N. Per
    consumer warpgroup, the shortcut boxes (64 rows at (n0 + 64 c, m0 + 64
    wg)) hold its rows."""
    gen = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=gen)
    b = torch.randn(n, k, generator=gen)
    sc = torch.randn(m, n, generator=gen)
    a_map, b_map, out_map, sc_map = gemm_maps(m, n, k, width)
    assert sc_map == out_map
    k_steps = -(-k // TILE)
    want = a @ b.t()
    for m0, n0 in _gemm_tiles(m, n, width):
        acc = torch.zeros(GEMM_ROWS, width)
        for kt in range(k_steps):
            a_box = tma_load(a.reshape(-1), a_map, (TILE * kt, m0))
            b_box = tma_load(b.reshape(-1), b_map, (TILE * kt, n0))
            assert a_box.shape == (GEMM_ROWS, TILE)
            assert b_box.shape == (width, TILE)
            assert torch.equal(
                a_box, _padded(a[m0:m0 + GEMM_ROWS, TILE * kt:TILE * (kt + 1)],
                               GEMM_ROWS, TILE))
            assert torch.equal(
                b_box, _padded(b[n0:n0 + width, TILE * kt:TILE * (kt + 1)],
                               width, TILE))
            acc += a_box @ b_box.t()
        rows, cols = min(GEMM_ROWS, m - m0), min(width, n - n0)
        assert torch.allclose(acc[:rows, :cols],
                              want[m0:m0 + rows, n0:n0 + cols], atol=1e-4)
        assert bool((acc[rows:] == 0).all()) and bool((acc[:, cols:] == 0).all())
        for wg in range(2):
            for c in range(min(width // TILE, -(-(n - n0) // TILE))):
                box = tma_load(sc.reshape(-1), sc_map,
                               (n0 + TILE * c, m0 + TILE * wg))
                r0, c0 = m0 + TILE * wg, n0 + TILE * c
                assert torch.equal(box, _padded(sc[r0:r0 + TILE, c0:c0 + TILE],
                                                TILE, TILE))


@pytest.mark.parametrize("width", GEMM_WIDTHS)
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_gemm_out_boxes_write_the_output_exactly(m, n, k, width):
    """Each warpgroup's 64-row boxes, stored where the kernel stores them
    (skipping a warpgroup past M and 64-column chunks at or past N), write
    every element of the (M, N) output once and nothing beyond it: the
    storage after the output keeps its sentinel."""
    out_map = gemm_maps(m, n, k, width)[2]
    storage = torch.full((m * n + 4096,), -1.0)
    count = torch.zeros(m * n + 4096)
    for m0, n0 in _gemm_tiles(m, n, width):
        for wg in range(2):
            if m0 + TILE * wg >= m:
                continue
            for c in range(min(width // TILE, -(-(n - n0) // TILE))):
                coords = (n0 + TILE * c, m0 + TILE * wg)
                r = torch.arange(TILE * TILE, dtype=torch.float32)
                rows, cols = coords[1] + r // TILE, coords[0] + r % TILE
                tma_store(storage, out_map, coords,
                          (rows * n + cols).reshape(TILE, TILE))
                tma_store(count, out_map, coords,
                          tma_load(count, out_map, coords) + 1)
    assert torch.equal(storage[:m * n], torch.arange(m * n, dtype=torch.float32))
    assert bool((count[:m * n] == 1).all()) and bool((count[m * n:] == 0).all())
    assert bool((storage[m * n:] == -1.0).all())


@pytest.mark.parametrize("width", GEMM_WIDTHS)
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_gemm_maps_keep_the_hardware_rules(m, n, k, width):
    """16-byte row strides (the route's C, H, O % 8 == 0), boxes of at most
    256 rows, a 128-byte inner box: 128 rows for A, the tile width for B,
    64 (a warpgroup's rows) for the output and the shortcut."""
    maps = gemm_maps(m, n, k, width)
    for geometry in maps:
        _check_rules(geometry)
        assert geometry.box[0] * ELEM_BYTES == 128
    assert [g.box[1] for g in maps] == [GEMM_ROWS, width, TILE, TILE]
    assert [g.dims for g in maps] == [(k, m), (k, n), (n, m), (n, m)]


# swin_block's and poolformer_block's products at Swin-T's and
# PoolFormer-S12's stage widths (C, hidden = 4 C), M cut to three row
# blocks and a ragged tail (M = 343 rows, 7 windows of 49; 392 = 8 x 7 x 7
# pixels).
_BLOCK_PRODUCTS = (
    [(f"swin C={c}", i, p) for c in (96, 192, 384)
     for i, p in enumerate(swin_gemm_products(343, c, 4 * c, 132))]
    + [(f"poolformer C={c}", i, p) for c in (64, 128, 320, 512)
       for i, p in enumerate(poolformer_gemm_products(392, c, 4 * c, 132))])


@pytest.mark.parametrize("what,index,product", [
    pytest.param(*case, id=f"{case[0]}-{case[1]}") for case in _BLOCK_PRODUCTS])
def test_f32_gemm_boxes_give_every_tile(what, index, product):
    """The maps of swin_block's and poolformer_block's products (an f32 A
    under the norm prologue, an f32 shortcut, Swin's f32 X2 output; Swin's
    qkv all bf16) at
    the width ``gemm_width`` picks: each keeps the hardware rules with
    128-byte rows (32 f32 or 64 bf16 columns); per output tile and k step
    the A boxes (two of 32 columns for an f32 A) and the B box hold the
    tile's rows and k columns with zeros past M, N and K, and their product
    summed over the k steps is the tile of a @ b^T; per consumer warpgroup
    the shortcut boxes (32 or 64 columns at n0 + c cols, m0 + 64 wg) hold
    its rows; the output boxes, stored as the kernel stores them, write
    every element of (M, N) once and nothing beyond."""
    m, n, k = product.m, product.n, product.k
    width = gemm_width(m, n, k, product.ln, product.residual, product.sms,
                       product.a_bytes, product.w192)
    maps = gemm_maps(m, n, k, width, product.a_bytes, product.out_bytes,
                     product.sc_bytes)
    sizes = (product.a_bytes, ELEM_BYTES, product.out_bytes, product.sc_bytes)
    for geometry, size, rows in zip(maps, sizes,
                                    (GEMM_ROWS, width, TILE, TILE)):
        _check_rules(geometry, size)
        assert geometry.box == (SWIZZLE_BYTES // size, rows)
    a_map, b_map, out_map, sc_map = maps
    gen = torch.Generator().manual_seed(m + n + k)
    a, b = torch.randn(m, k, generator=gen), torch.randn(n, k, generator=gen)
    sc = torch.randn(m, n, generator=gen)
    a_cols = SWIZZLE_BYTES // product.a_bytes
    sc_cols = SWIZZLE_BYTES // product.sc_bytes
    out_cols = SWIZZLE_BYTES // product.out_bytes
    want = a @ b.t()
    storage = torch.full((m * n + 4096,), -1.0)
    count = torch.zeros(m * n + 4096)
    for m0, n0 in _gemm_tiles(m, n, width):
        acc = torch.zeros(GEMM_ROWS, width)
        for kt in range(-(-k // TILE)):
            a_box = torch.cat([tma_load(a.reshape(-1), a_map,
                                        (TILE * kt + a_cols * i, m0),
                                        product.a_bytes)
                               for i in range(TILE // a_cols)], dim=1)
            b_box = tma_load(b.reshape(-1), b_map, (TILE * kt, n0))
            assert torch.equal(
                a_box, _padded(a[m0:m0 + GEMM_ROWS, TILE * kt:TILE * (kt + 1)],
                               GEMM_ROWS, TILE))
            acc += a_box @ b_box.t()
        rows, cols = min(GEMM_ROWS, m - m0), min(width, n - n0)
        assert torch.allclose(acc[:rows, :cols],
                              want[m0:m0 + rows, n0:n0 + cols], atol=1e-4)
        assert bool((acc[rows:] == 0).all()) and bool((acc[:, cols:] == 0).all())
        for wg in range(2):
            r0 = m0 + TILE * wg
            if product.residual:
                for c in range(min(width // sc_cols, -(-(n - n0) // sc_cols))):
                    c0 = n0 + sc_cols * c
                    box = tma_load(sc.reshape(-1), sc_map, (c0, r0),
                                   product.sc_bytes)
                    assert torch.equal(box, _padded(
                        sc[r0:r0 + TILE, c0:c0 + sc_cols], TILE, sc_cols))
            if r0 >= m:
                continue
            for c in range(min(width // out_cols, -(-(n - n0) // out_cols))):
                coords = (n0 + out_cols * c, r0)
                r = torch.arange(TILE * out_cols, dtype=torch.float32)
                rr, cc = coords[1] + r // out_cols, coords[0] + r % out_cols
                tma_store(storage, out_map, coords,
                          (rr * n + cc).reshape(TILE, out_cols),
                          product.out_bytes)
                tma_store(count, out_map, coords,
                          tma_load(count, out_map, coords, product.out_bytes)
                          + 1, product.out_bytes)
    assert torch.equal(storage[:m * n], torch.arange(m * n, dtype=torch.float32))
    assert bool((count[:m * n] == 1).all()) and bool((count[m * n:] == 0).all())


def test_packed_gemm_maps_are_the_maps_in_order():
    """Four geometries a product, at its width, then its grid's blocks,
    cached per shape; the C launcher reads the width as the b map's box
    rows (value 15 + 11 of a product) and the grid as its value 60."""
    products = ((25088, 2048, 512, True, False, 132),
                (25088, 512, 2048, False, True, 132),
                (200, 48, 24, True, False, 132))
    packed = list(packed_gemm_maps(*products))
    assert len(packed) == 3 * (4 * 15 + 1)
    want = []
    for m, n, k, ln, residual, sms in products:
        width = gemm_width(m, n, k, ln, residual, sms)
        for g in gemm_maps(m, n, k, width):
            want += g.pack()
        want.append(gemm_grid(m, n, width, sms))
    assert packed == want
    assert packed[:15] == [2, 512, 25088, 0, 0, 0, 1024, 0, 0, 0,
                           64, 128, 0, 0, 0]
    assert packed[15 + 11] == 256 and packed[61 + 15 + 11] == 128
    # 196 x 8 tiles and 196 x 4 on 132 SMs: a block an SM; 2 x 1: a block
    # a tile.
    assert [packed[60], packed[121], packed[182]] == [132, 132, 2]
    assert packed_gemm_maps(*products) is packed_gemm_maps(*products)
    assert matrix_map(10, 96, 64).strides == (192,)


@pytest.mark.parametrize("m,n,width,sms,blocks", [
    (401408, 512, 256, 132, 132),
    (6272, 4096, 256, 132, 132),
    (6272, 1024, 128, 132, 132),
    (12608, 2304, 256, 114, 114),   # an H100 PCIe's SM count
    (200, 48, 128, 132, 2),
    (128, 256, 256, 132, 1),
    (129, 257, 256, 132, 4),
])
def test_gemm_grid_is_a_block_an_sm_at_most(m, n, width, sms, blocks):
    assert gemm_grid(m, n, width, sms) == blocks


# On 132 SMs: (M, N, K, ln, residual, width): ConvNeXt-B's products
# (convnext_mlp's fc1 with the LN prologue, convnext_block's without),
# ViT-B/16's ln_dense and the edges, on kernels of 128 and 256 columns;
# then, on kernels with 192 too (GemmProduct.w192), swin_block's four
# products (qkv, proj, fc1 on the f32 X2, fc2) at Swin-T's stages 1-3
# bs128, as scripts/perf/torch_gemm_widths.py measured them on the H100
# (PERF.md §6): 192 for qkv and fc1 where its rounds cost least, and
# for proj and fc2 where it pads N less; fc1's f32 A never at 128 above N
# = 128. The seventh value of a 192 case is the element bytes of A.
_WIDTH_CASES = [
    (401408, 512, 128, True, False, 256),     # stage 0 fc1: equal rounds
    (401408, 512, 128, False, False, 256),    # the block's
    (401408, 128, 512, False, True, 128),     # fc2
    (25088, 2048, 512, True, False, 256),     # stage 2: 12 rounds or 24
    (25088, 512, 2048, False, True, 128),
    (6272, 4096, 1024, True, False, 256),     # stage 3: 6 rounds or 12
    (6272, 1024, 4096, False, False, 128),    # 2 rounds of 256 or 3
    (12608, 2304, 768, True, False, 256),     # ViT-B/16 LN1 -> qkv
    (12608, 3072, 3072, True, False, 128),    # the affine too deep for 256
    (200, 48, 24, True, False, 128),
]
_NARROW_WIDTH_CASES = [
    (401408, 288, 96, True, False, 192, 2),      # stage 1 qkv
    (401408, 96, 96, False, True, 128, 2),       # proj: N fits 128
    (401408, 384, 96, True, False, 192, 4),      # fc1
    (401408, 96, 384, False, True, 128, 2),      # fc2
    (100352, 576, 192, True, False, 192, 2),     # stage 2
    (100352, 192, 192, False, True, 192, 2),     # one 192 tile, not two of 128
    (100352, 768, 192, True, False, 256, 4),     # equal rounds: the wider
    (100352, 192, 768, False, True, 192, 2),
    (25088, 1152, 384, True, False, 192, 2),     # stage 3: 9 rounds or 8 of 256
    (25088, 384, 384, False, True, 128, 2),      # 3 tiles of 128 or 2 of 192
    (25088, 1536, 384, True, False, 256, 4),
    (25088, 384, 1536, False, True, 128, 2),
    (25088, 1536, 3072, True, False, 128, 4),    # the affine too deep for 192
]


@pytest.mark.parametrize("m,n,k,ln,residual,a_bytes,w192,width", [
    pytest.param(*case[:5], ELEM_BYTES, False, case[5],
                 id="-".join(map(str, case))) for case in _WIDTH_CASES] + [
    pytest.param(*case[:5], case[6], True, case[5],
                 id="-".join(map(str, case[:6])) + "-narrow")
    for case in _NARROW_WIDTH_CASES])
def test_gemm_width_picks_the_faster_tiles(m, n, k, ln, residual, a_bytes,
                                           w192, width):
    assert gemm_width(m, n, k, ln, residual, 132, a_bytes, w192) == width
    if not w192:
        assert gemm_width(m, n, k, ln, residual, 132) == width


@pytest.mark.parametrize("block,m,c,widths", [
    ("swin", 401408, 96, [192, 128, 192, 128]),
    ("swin", 100352, 192, [192, 192, 256, 192]),
    ("swin", 25088, 384, [192, 128, 256, 128]),
    ("poolformer", 401408, 64, [256, 128]),
    ("poolformer", 100352, 128, [256, 128]),
    ("poolformer", 25088, 320, [256, 128]),
    ("poolformer", 6272, 512, [256, 128]),
])
def test_block_products_take_the_measured_widths(block, m, c, widths):
    """swin_block's (qkv, proj, fc1, fc2) and poolformer_block's (fc1, fc2)
    tile widths at Swin-T's and PoolFormer-S12's stages at batch 128 on 132
    SMs: the fastest of scripts/perf/torch_gemm_widths.py's sweep on the
    H100 (PERF.md §6), fc1's f32 A never at 128 columns above N =
    128; each width one its kernel has."""
    products = (swin_gemm_products if block == "swin"
                else poolformer_gemm_products)(m, c, 4 * c, 132)
    assert [gemm_width(*p[:6], p.a_bytes, p.w192) for p in products] == widths
    assert all(p.w192 is (block == "swin") for p in products)


@pytest.mark.parametrize("a_bytes,n,k,width", [
    (ELEM_BYTES, 1280, 320, 128),   # bf16 A: the fewest rounds
    (F32_BYTES, 1280, 320, 256),    # f32 A: never 128 above N = 128
    (F32_BYTES, 128, 320, 128),     # N fits 128 columns
    (F32_BYTES, 1280, 3072, 128),   # the affine too deep for 256
])
def test_gemm_width_keeps_an_f32_a_off_128_columns(a_bytes, n, k, width):
    """The norm prologue on an f32 A (PoolFormer's fc1 on x1, Swin's on
    X2) reads A again for each column tile: above N = 128 its product
    takes wider tiles even where 128-column ones would take fewer rounds,
    unless the affine does not fit beside them."""
    assert gemm_width(25088, n, k, True, False, 132, a_bytes) == width


def _matrix(rows, cols, dtype=torch.bfloat16, offset=0):
    flat = torch.zeros(rows * cols + offset, dtype=dtype)
    return flat[offset:].view(rows, cols)


_ROUTE_CASES = [
    (128, 512, 0, torch.bfloat16, True),     # ConvNeXt-B stage 0
    (1024, 4096, 0, torch.bfloat16, True),   # stage 3
    (2048, 8192, 0, torch.bfloat16, True),   # convnext_xlarge's widest
    (96, 392, 0, torch.bfloat16, True),      # C % 64 != 0, H % 128 != 0
    (24, 96, 0, torch.bfloat16, True),       # the smallest multiple of 8s
    (12, 48, 0, torch.bfloat16, False),      # the golden fixture: 24-byte rows
    (100, 400, 0, torch.bfloat16, False),    # 200-byte rows
    (128, 36, 0, torch.bfloat16, False),     # an odd hidden width
    (128, 512, 1, torch.bfloat16, False),    # a base off 16 bytes
    (128, 512, 8, torch.bfloat16, True),     # a base 16 bytes on
    (128, 512, 0, torch.float32, False),     # f32: the FMA body
]
# x and the shortcut in f32 (PoolFormer's x1, Swin's X2), the rest bf16.
_F32_ROUTE_CASES = [
    (64, 256, 0, torch.bfloat16, True),      # PoolFormer-S12 stage 1
    (96, 384, 0, torch.bfloat16, True),      # Swin-T stage 1
    (512, 2048, 0, torch.bfloat16, True),    # PoolFormer-S12 stage 4
    (60, 240, 0, torch.bfloat16, False),     # 240-byte f32, 120-byte bf16 rows
    (6, 24, 0, torch.bfloat16, False),       # 24-byte f32 rows
    (128, 512, 1, torch.bfloat16, False),    # the f32 base off 16 bytes
    (128, 512, 4, torch.bfloat16, True),     # the f32 base 16 bytes on
    (128, 512, 0, torch.float32, False),     # f32 weights: the FMA body
]


@pytest.mark.parametrize("c,hidden,offset,dtype,route,f32", [
    pytest.param(*case, False, id=f"{case[0]}-{case[1]}-{case[2]}-dtype{i}-"
                 f"{case[4]}") for i, case in enumerate(_ROUTE_CASES)] + [
    pytest.param(*case, True, id=f"{case[0]}-{case[1]}-{case[2]}-f32-"
                 f"{case[3]}-{case[4]}".replace("torch.", ""))
    for case in _F32_ROUTE_CASES])
def test_gemm_route(c, hidden, offset, dtype, route, f32):
    """Which shapes take the TMA + wgmma body and which keep mma.sync: the
    convnext_mlp operands (x, shortcut, w1, w2, h, out) of M = 64 rows with
    x at ``offset`` elements into its storage; with ``f32``, x and the
    shortcut f32 (poolformer_block's and swin_block's f32 A and shortcut),
    passed as ``f32``."""
    if not f32:
        x = _matrix(64, c, dtype, offset)
        others = [_matrix(64, c, dtype), _matrix(hidden, c, dtype),
                  _matrix(c, hidden, dtype), _matrix(64, hidden, dtype),
                  _matrix(64, c, dtype)]
        assert gemm_route(x, *others, ln_depth=c) is route
        return
    x, sc = _matrix(64, c, torch.float32, offset), _matrix(64, c, torch.float32)
    others = [_matrix(hidden, c, dtype), _matrix(c, hidden, dtype),
              _matrix(64, hidden, dtype), _matrix(64, c, dtype)]
    assert gemm_route(*others, ln_depth=c, f32=(x, sc)) is route
    # f32 operands in the bf16 list, or bf16 ones in the f32 list, are
    # refused.
    assert not gemm_route(x, *others, ln_depth=c)
    assert not gemm_route(*others[1:], ln_depth=c, f32=(x, sc, others[0]))


def test_gemm_route_limits():
    """ln_dense's O = 36 and C = 100 keep mma.sync; the LN prologue's depth
    is bounded by its affine in shared memory; a view that is not
    contiguous or an empty matrix is refused."""
    x, w = _matrix(197, 768), _matrix(2304, 768)
    assert gemm_route(x, w, _matrix(197, 2304), ln_depth=768)
    assert not gemm_route(x, _matrix(36, 768), _matrix(197, 36), ln_depth=768)
    assert not gemm_route(_matrix(197, 100), _matrix(40, 100),
                          _matrix(197, 40), ln_depth=100)
    deep = _matrix(8, LN_MAX_DEPTH + 8)
    assert gemm_route(deep, ln_depth=0)
    assert not gemm_route(deep, ln_depth=LN_MAX_DEPTH + 8)
    assert gemm_route(_matrix(8, LN_MAX_DEPTH), ln_depth=LN_MAX_DEPTH)
    assert not gemm_route(_matrix(64, 256)[:, :128])
    assert not gemm_route(_matrix(64, 256).t())
    assert not gemm_route(_matrix(0, 128))


CAIT_N = [1, 9, 16, 17, 50, 196]


@pytest.mark.parametrize("n", CAIT_N)
@pytest.mark.parametrize("h,d", [(2, 8), (4, 48), (6, 48), (8, 48), (8, 64)])
def test_cait_key_boxes_give_the_stages(n, h, d):
    """The talking-head maps: the 64-row map is ``fused_mha``'s; each
    (64, 1, 1, 16, 1) box of the key map at (0, h, part, 16 t, b) is keys
    16 t... of head h's k (part 1) or v (part 2) of image b, zeros past N
    and d; the out map is ``fused_mha``'s."""
    b = 2
    gen = torch.Generator().manual_seed(7 * n + h + d)
    qkv = (torch.randn(b, n, 3 * h * d, generator=gen) + 10.0).bfloat16()
    rows, keys, out = cait_maps(b, n, h, d)
    assert (rows, out) == fused_mha_maps(b, n, h, d)
    _check_rules(keys)
    stages = -(-n // CAIT_KEYS)
    flat = qkv.reshape(-1)
    for part in (1, 2):
        want = _padded(_split_qkv(qkv, h)[part].bfloat16(),
                       CAIT_KEYS * stages, TILE)
        got = torch.zeros_like(want)
        for bi, hi, t in itertools.product(range(b), range(h), range(stages)):
            box = tma_load(flat, keys, (0, hi, part, CAIT_KEYS * t, bi))
            assert box.shape == (1, CAIT_KEYS, 1, 1, TILE)
            got[bi, hi, CAIT_KEYS * t:CAIT_KEYS * (t + 1)] = box[0, :, 0, 0]
        assert torch.equal(got, want), part


@pytest.mark.parametrize("n", [1, 9, 50, 64, 65, 196])
def test_cait_scratch_boxes_give_the_tiles(n):
    """The backward's scratch (2, B, H, N, cols) of a and draw: its rows are
    16-byte multiples; the (64, 64, 1, 1) box at (64 kt, 64 qt, h,
    part B + b) is query rows 64 qt... and keys 64 kt... of head h of image
    b's a or draw, zeros past N both ways, whatever the columns past N
    hold."""
    b, h = 2, 3
    cols = cait_scratch_cols(n)
    assert cols % 8 == 0 and n <= cols < n + 8
    m = cait_scratch_map(b, n, h)
    _check_rules(m)
    gen = torch.Generator().manual_seed(n)
    scratch = torch.randn(2, b, h, n, cols, generator=gen).bfloat16()
    scratch[..., n:] = float("nan")
    tiles = -(-n // TILE)
    flat = scratch.reshape(-1)
    for part, bi, hi, qt, kt in itertools.product(range(2), range(b), range(h),
                                                  range(tiles), range(tiles)):
        box = tma_load(flat, m, (TILE * kt, TILE * qt, hi, part * b + bi))
        assert box.shape == (1, 1, TILE, TILE)
        want = _padded(scratch[part, bi, hi, :, :n], TILE * tiles,
                       TILE * tiles)[TILE * qt:TILE * (qt + 1),
                                     TILE * kt:TILE * (kt + 1)]
        assert torch.equal(box[0, 0], want)


def test_packed_cait_maps_are_the_maps_in_order():
    forward = packed_cait_maps(3, 196, 8, 48)
    backward = packed_cait_maps(3, 196, 8, 48, True)
    maps = cait_maps(3, 196, 8, 48)
    assert list(forward) == [v for g in maps for v in g.pack()]
    assert list(backward) == [v for g in (*maps, cait_scratch_map(3, 196, 8))
                              for v in g.pack()]
    assert packed_cait_maps(3, 196, 8, 48) is forward   # cached per shape


def _qkv(b, n, h, d, dtype=torch.bfloat16, offset=0):
    flat = torch.zeros(b * n * 3 * h * d + offset, dtype=dtype)
    return flat[offset:].view(b, n, 3 * h * d)


@pytest.mark.parametrize("b,n,h,d,offset,dtype,route", [
    (64, 196, 8, 48, 0, torch.bfloat16, True),    # cait_s24_224
    (2, 196, 4, 48, 0, torch.bfloat16, True),     # cait_xxs
    (2, 576, 6, 48, 0, torch.bfloat16, True),     # cait_xs24_384
    (3, 16, 2, 8, 0, torch.bfloat16, True),       # the golden fixture
    (2, 50, 8, 64, 0, torch.bfloat16, True),      # the widest head dim
    (2, 784, 16, 48, 0, torch.bfloat16, False),   # cait_m48: 16 heads
    (2, 50, 10, 72, 0, torch.bfloat16, False),    # d = 72
    (2, 50, 6, 128, 0, torch.bfloat16, False),    # d = 128
    (2, 196, 8, 48, 1, torch.bfloat16, False),    # 2 bytes off 16
    (2, 196, 8, 48, 8, torch.bfloat16, True),     # 16 bytes on
    (2, 196, 8, 48, 0, torch.float32, False),     # f32: the FMA bodies
])
def test_cait_route(b, n, h, d, offset, dtype, route):
    """Which talking-head calls take the Hopper bodies: qkv alone (the
    forward) and with g (the backward)."""
    qkv = _qkv(b, n, h, d, dtype, offset)
    g = torch.zeros(b, n, h * d, dtype=dtype)
    assert cait_route(h, qkv) is route
    assert cait_route(h, qkv, g) is route


def test_cait_route_limits():
    """g off 16 bytes or not contiguous sends the backward off the route;
    so does a strided view of qkv; H above 8 or a head dim that is no
    multiple of 8 never takes it."""
    qkv = _qkv(2, 50, 8, 48)
    g = torch.zeros(2 * 50 * 384 + 1, dtype=torch.bfloat16)
    assert not cait_route(8, qkv, g[1:].view(2, 50, 384))
    assert not cait_route(8, qkv, torch.zeros(2, 50, 768,
                                              dtype=torch.bfloat16)[..., ::2])
    wide = _qkv(2, 50, 8, 48)
    assert not cait_route(8, torch.cat([wide, wide], dim=-1)[..., :3 * 384])
    assert not cait_route(9, _qkv(2, 50, 9, 48))
    assert not cait_route(4, _qkv(2, 50, 4, 12))
    assert not cait_route(8, _qkv(2, 0, 8, 48)[:, :, :5])


# The window attention's Hopper bodies: (BW, N, H, d), each window one
# 64-row tile and each head one 64-column chunk (Swin-T's d = 32, hf_swin's
# N = 16 and d = 8, d = 64 at N = 64, a ragged d = 24 and N = 7).
WINDOW_CASES = [(6, 49, 3, 32), (4, 16, 2, 8), (3, 64, 2, 64), (5, 7, 1, 24),
                (2, 49, 4, 16)]


def _window_heads(t, h):
    """(BW, N, H*d) -> (BW, H, N, d)."""
    bw, n, c = t.shape
    return t.reshape(bw, n, h, c // h).transpose(1, 2)


def _store_rows(tile, dst, base, ld, n, d):
    """The window kernels' output path: ``tile`` (64 x 64) as
    ``window_mha_common.cuh · write_tile`` leaves it in shared memory (the
    16-byte chunk c of row r at chunk position c ^ (r % 8)), then
    ``store_rows``: the chunks of its first n rows and d columns, read back
    through the same swizzle, into ``dst`` at ``base + row * ld``."""
    swizzled = torch.empty(TILE, TILE // 8, 8, dtype=tile.dtype)
    for r in range(TILE):
        for c in range(TILE // 8):
            swizzled[r, c ^ (r % 8)] = tile[r, 8 * c:8 * c + 8]
    for r in range(n):
        for c in range(d // 8):
            dst[base + r * ld + 8 * c:base + r * ld + 8 * c + 8] = \
                swizzled[r, c ^ (r % 8)]


@pytest.mark.parametrize("bw,n,h,d", WINDOW_CASES)
def test_window_boxes_give_each_window_head(bw, n, h, d):
    """The forward's q, k and v as the three slices of a packed qkv and as
    contiguous tensors: each (64, 1, 64, 1) box at (0, h, 0, r) is head h of
    window r, zeros past N and past d (the neighbouring heads and the next
    window, all far from zero here, never show up). Each window's output
    tile, with garbage past N and d, stored through its first N rows and d
    columns, gives (BW, N, H*d) exactly and nothing else."""
    c = h * d
    gen = torch.Generator().manual_seed(bw * n + d)
    qkv = (torch.randn(bw, n, 3 * c, generator=gen) + 10.0).bfloat16()
    flat = qkv.reshape(-1)
    alone = (torch.randn(bw, n, c, generator=gen) + 10.0).bfloat16()
    for operands in ([(flat[i * c:], qkv[..., i * c:(i + 1) * c])
                      for i in range(3)], [(alone.reshape(-1), alone)] * 3):
        maps = window_maps(bw, n, h, d, *(t.stride()[:2] for _, t in operands))
        assert len(maps) == 3
        for m, (base, t) in zip(maps, operands):
            _check_rules(m)
            want = _window_heads(t, h)
            for r, hi in itertools.product(range(bw), range(h)):
                box = tma_load(base, m, (0, hi, 0, r))
                assert box.shape == (1, TILE, 1, TILE)
                assert torch.equal(box[0, :, 0],
                                   _padded(want[r, hi], TILE, TILE))

    heads = torch.randn(bw, h, n, d, generator=gen).bfloat16()
    out = torch.full((bw * n * c + 64,), -1.0, dtype=heads.dtype)
    for r, hi in itertools.product(range(bw), range(h)):
        tile = torch.full((TILE, TILE), 7.0, dtype=heads.dtype)
        tile[:n, :d] = heads[r, hi]
        _store_rows(tile, out, r * n * c + hi * d, c, n, d)
    assert torch.equal(out[:bw * n * c].reshape(bw, n, c),
                       heads.transpose(1, 2).reshape(bw, n, c))
    assert bool((out[bw * n * c:] == -1.0).all())


@pytest.mark.parametrize("bw,n,h,d", WINDOW_CASES)
def test_window_bwd_boxes_read_qkv_and_g_and_write_dqkv(bw, n, h, d):
    """The backward reads qkv through its own strides (here a view with
    padded rows) as (d, H, 3, N, BW): a (64, 1, 1, 64, 1) box at
    (0, h, part, 0, r) is head h of window r's q, k or v, and g through
    (d, H, N, BW), zeros past N and d. The tiles of dq, dk and dv stored
    through their first N rows and d columns at part * C + h * d of the
    window's rows give exactly the contiguous packed dqkv and nothing
    else."""
    c = h * d
    gen = torch.Generator().manual_seed(bw * n + d + 1)
    wide = (torch.randn(bw, n, 3 * c + 8, generator=gen) + 10.0).bfloat16()
    qkv = wide[..., :3 * c]
    g = (torch.randn(bw, n, c, generator=gen) + 10.0).bfloat16()
    qkv_map, g_map = window_bwd_maps(bw, n, h, d, qkv.stride()[:2])
    for m in (qkv_map, g_map):
        _check_rules(m)
    for r, hi in itertools.product(range(bw), range(h)):
        for part in range(3):
            box = tma_load(wide.reshape(-1), qkv_map, (0, hi, part, 0, r))
            assert box.shape == (1, TILE, 1, 1, TILE)
            want = _window_heads(qkv[..., part * c:(part + 1) * c], h)
            assert torch.equal(box[0, :, 0, 0],
                               _padded(want[r, hi], TILE, TILE))
        box = tma_load(g.reshape(-1), g_map, (0, hi, 0, r))
        assert torch.equal(box[0, :, 0], _padded(_window_heads(g, h)[r, hi],
                                                 TILE, TILE))

    grads = [torch.randn(bw, h, n, d, generator=gen).bfloat16()
             for _ in range(3)]
    dqkv = torch.full((bw * n * 3 * c + 64,), -1.0, dtype=g.dtype)
    for (part, grad), r, hi in itertools.product(enumerate(grads), range(bw),
                                                 range(h)):
        tile = torch.full((TILE, TILE), 7.0, dtype=g.dtype)
        tile[:n, :d] = grad[r, hi]
        _store_rows(tile, dqkv, r * n * 3 * c + part * c + hi * d, 3 * c, n,
                    d)
    want = torch.cat([t.transpose(1, 2).reshape(bw, n, c) for t in grads],
                     dim=-1)
    assert torch.equal(dqkv[:bw * n * 3 * c].reshape(bw, n, 3 * c), want)
    assert bool((dqkv[bw * n * 3 * c:] == -1.0).all())


@pytest.mark.parametrize("bw,h,sms,group", [
    (8192, 3, 132, 187),    # Swin-T stage 1 at bs128: 44 blocks a head
    (4096, 3, 132, 94),     # its training stage 1 at bs64
    (128, 24, 132, 26),     # stage 4 at bs128: 5 blocks a head
    (64, 24, 132, 13),
    (2, 48, 132, 1),
    (10, 200, 132, 10),     # more heads than SMs: one block a head
])
def test_window_group_makes_one_block_an_sm_at_most(bw, h, sms, group):
    assert window_group(bw, h, sms) == group
    blocks = h * -(-bw // group)
    assert blocks <= max(h, sms)


def test_packed_window_maps_are_the_maps_in_order():
    rows = (49 * 288, 288)
    forward = packed_window_maps(8192, 49, 3, 32, rows, rows, rows, 132)
    maps = window_maps(8192, 49, 3, 32, rows, rows, rows)
    assert list(forward) == [v for m in maps for v in m.pack()] + [187]
    assert packed_window_maps(8192, 49, 3, 32, rows, rows, rows, 132) is forward
    backward = packed_window_bwd_maps(4096, 49, 3, 32, rows)
    assert list(backward) == [v for m in window_bwd_maps(4096, 49, 3, 32, rows)
                              for v in m.pack()]


def _window_qkv(bw, n, c, dtype=torch.bfloat16, offset=0, extra=0):
    """A packed (BW, N, 3C) qkv starting ``offset`` elements into its
    storage, its rows ``extra`` elements longer than 3C."""
    flat = torch.zeros(bw * n * (3 * c + extra) + offset, dtype=dtype)
    return flat[offset:].view(bw, n, 3 * c + extra)[..., :3 * c]


@pytest.mark.parametrize("n,c,h,offset,dtype,route", [
    (49, 96, 3, 0, torch.bfloat16, True),      # Swin-T stage 1
    (49, 192, 6, 0, torch.bfloat16, True),     # stage 2
    (49, 384, 12, 0, torch.bfloat16, True),    # stage 3
    (49, 768, 24, 0, torch.bfloat16, True),    # stage 4
    (16, 16, 2, 0, torch.bfloat16, True),      # hf_swin: N = 16, d = 8
    (64, 256, 4, 0, torch.bfloat16, True),     # N and d at 64
    (49, 96, 3, 0, torch.float32, False),      # f32: the FMA bodies
    (144, 128, 4, 0, torch.bfloat16, False),   # window 12
    (49, 216, 3, 0, torch.bfloat16, False),    # d = 72
    (49, 96, 3, 1, torch.bfloat16, False),     # 2 bytes off 16
    (49, 96, 3, 8, torch.bfloat16, True),      # 16 bytes on
])
def test_window_route(n, c, h, offset, dtype, route):
    """Which window-attention calls take the Hopper bodies: the forward's
    q, k and v (the slices of a packed qkv) and the backward's qkv and g."""
    qkv = _window_qkv(2, n, c, dtype, offset)
    g = torch.zeros(2, n, c, dtype=dtype)
    d = c // h
    assert window_route(n, d, *(qkv[..., i * c:(i + 1) * c]
                                for i in range(3))) is route
    assert window_route(n, d, qkv, g) is route


def test_window_route_limits():
    """g off 16 bytes, an operand whose last dimension is strided or whose
    rows are no whole 16 bytes, N = 65 and head dims that are no multiple
    of 8 or above 64 leave the route."""
    qkv = _window_qkv(2, 49, 96)
    g = torch.zeros(2 * 49 * 96 + 8, dtype=torch.bfloat16)
    assert window_route(49, 32, qkv, g[8:].view(2, 49, 96))
    assert not window_route(49, 32, qkv, g[1:2 * 49 * 96 + 1].view(2, 49, 96))
    strided = torch.zeros(2, 49, 192, dtype=torch.bfloat16)[..., ::2]
    assert not window_route(49, 32, strided, strided, strided)
    assert not window_route(49, 32, _window_qkv(2, 49, 96, extra=1))
    assert window_route(49, 32, _window_qkv(2, 49, 96, extra=8))
    assert not window_route(65, 32, _window_qkv(2, 65, 96))
    assert not window_route(49, 12, _window_qkv(2, 49, 96))
    assert not window_route(49, 80, _window_qkv(2, 49, 240))
    assert not window_route(49, 0, _window_qkv(2, 49, 96))


# -- pvt_sra ------------------------------------------------------------------

def _sra_operands(b, n, s, c, gen, extra=0, dtype=torch.float32):
    """x (B, N, C) and kv (B, S, 2C), kv a view of a tensor ``extra`` rows
    longer an image whose rows past S hold NaN."""
    x = torch.randn(b, n, c, generator=gen).to(dtype)
    kv = torch.full((b, s + extra, 2 * c), float("nan"), dtype=dtype)
    kv[:, :s] = torch.randn(b, s, 2 * c, generator=gen).to(dtype)
    return x, kv[:, :s]


def _sra_block_tiles(b, n, sms):
    """Each block's (image, first row) tiles, as the kernel splits the
    B * ceil(N / 64) tiles in image order among ``sra_grid`` blocks."""
    per_image = -(-n // TILE)
    tiles, blocks = b * per_image, sra_grid(b, n, sms)
    return [[divmod(t, per_image) for t in range(tiles * i // blocks,
                                                  tiles * (i + 1) // blocks)]
            for i in range(blocks)]


@pytest.mark.parametrize("b,n,s,c,extra", [
    (2, 3136, 49, 64, 0),     # pvt_v2_b2's stage 1
    (2, 3136, 49, 32, 0),     # pvt_v2_b0's: the v box runs past 2C
    (3, 77, 49, 64, 15),      # a ragged N; rows of NaN past S in memory
    (2, 33, 1, 16, 7),        # S = 1, C = 16
    (5, 130, 64, 48, 0),      # S = 64
])
def test_sra_boxes_give_the_function(b, n, s, c, extra):
    """Through the maps' boxes, at the coordinates the kernel uses: every
    tile of x is read once by one block (its block's tiles consecutive, in
    image order), with zeros past N and past C; an image's k box (0, 0, b)
    holds k in its first C columns and its v box (C, 0, b) v, zeros past S
    (the NaN rows in memory never arrive) and past 2C; wq and wp one box
    each, zeros past C. The four products over C / 16 and ceil(S / 16) k16
    steps of those boxes, keys >= S left out of the softmax, give
    ``pvt_sra_reference`` in f32 (1e-5 of max)."""
    gen = torch.Generator().manual_seed(n + s + c)
    x, kv = _sra_operands(b, n, s, c, gen, extra)
    wq = torch.randn(c, c, generator=gen) / 8
    wp = torch.randn(c, c, generator=gen) / 8
    bq, bp = torch.randn(c, generator=gen), torch.randn(c, generator=gen)
    scale = c ** -0.5
    x_map, kv_map, wq_map, wp_map = sra_maps(b, n, s, c,
                                             (kv.stride(0), kv.stride(1)))
    for m in (x_map, kv_map, wq_map):
        _check_rules(m)
        assert m.box[0] * ELEM_BYTES == SWIZZLE_BYTES
    wq_box = tma_load(wq.reshape(-1), wq_map, (0, 0))
    wp_box = tma_load(wp.reshape(-1), wp_map, (0, 0))
    assert torch.equal(wq_box, _padded(wq, TILE, TILE))
    kv_flat = torch.as_strided(kv, (kv.untyped_storage().nbytes() // 4,), (1,),
                               0)
    out = torch.full((b, n, c), float("nan"))
    seen = torch.zeros(b, -(-n // TILE), dtype=torch.int64)
    for tiles in _sra_block_tiles(b, n, 132):
        images = [img for img, _ in tiles]
        assert images == sorted(images)
        for img, r in tiles:
            seen[img, r] += 1
            r0 = r * TILE
            x_box = tma_load(x.reshape(-1), x_map, (0, r0, img))[0]
            assert torch.equal(x_box, _padded(x[img, r0:r0 + TILE], TILE,
                                              TILE))
            k_box = tma_load(kv_flat, kv_map, (0, 0, img))[0]
            v_box = tma_load(kv_flat, kv_map, (c, 0, img))[0]
            assert torch.equal(k_box[:, :c], _padded(kv[img, :, :c], TILE,
                                                     c))
            assert torch.equal(v_box, _padded(kv[img, :, c:], TILE, TILE))
            kc, ks = 16 * (c // 16), 16 * -(-s // 16)
            q = ((x_box[:, :kc] @ wq_box[:, :kc].t()
                  + _padded(bq[None], 1, TILE)) * scale)
            sc = q[:, :kc] @ k_box[:, :kc].t()
            sc[:, s:] = float("-inf")
            p = torch.softmax(sc, dim=-1)
            o = p[:, :ks] @ v_box[:ks]
            y = o[:, :kc] @ wp_box[:, :kc].t() + _padded(bp[None], 1, TILE)
            rows = min(TILE, n - r0)
            out[img, r0:r0 + rows] = y[:rows, :c]
    assert bool((seen == 1).all())
    want = pvt_sra_reference(x, kv[..., :c], kv[..., c:], wq, bq, wp, bp,
                             scale)
    assert torch.allclose(out, want, atol=1e-5 * want.abs().max().item(),
                          rtol=0)


def test_packed_sra_maps_are_the_maps_in_order():
    """The four geometries, then the grid: one block an SM, one a tile
    where there are fewer."""
    packed = list(packed_sra_maps(128, 3136, 49, 64, (49 * 128, 128), 132))
    maps = sra_maps(128, 3136, 49, 64, (49 * 128, 128))
    assert packed[:-1] == [v for m in maps for v in m.pack()]
    assert packed[-1] == 132
    assert sra_grid(1, 64, 132) == 1 and sra_grid(2, 65, 132) == 4


def _stage1_sra_calls(name, monkeypatch):
    """The operands ``pvt_sra`` gets at stage 1 of the registered model
    ``name`` in bf16 at 224 (one block a stage, switched on)."""
    calls = []

    def record(x, kv, wq, bq, wp, bp, scale):
        calls.append((x, kv, wq, wp))
        return pvt_sra_reference(x, kv[..., :x.shape[-1]],
                                 kv[..., x.shape[-1]:], wq, bq, wp, bp, scale)

    monkeypatch.setenv("TFIMM_TPU_FUSED_PVT_SRA", "1")
    monkeypatch.setattr(pvt_module, "pvt_sra", record)
    model = tfimm_tpu_torch.create_model(name, device="cpu",
                                         dtype=torch.bfloat16,
                                         nb_blocks=(1, 1, 1, 1))
    with Context(training=False):
        model.predict(torch.zeros(1, 224, 224, 3, dtype=torch.bfloat16))
    return calls


@pytest.mark.parametrize("name,c", [("pvt_v2_b2", 64), ("pvt_v2_b0", 32),
                                    ("pvt_small", 64),
                                    ("pvt_v2_b2_linear", 64)])
def test_sra_route(monkeypatch, name, c):
    """Stage 1 of pvt_v2_b2, pvt_v2_b0, pvt_small and pvt_v2_b2_linear in
    bf16 at 224 (S = 49, after the linear variant's 7x7 pool too) takes the
    route with the weights as the wrapper passes them; the same call in f32
    does not."""
    calls = _stage1_sra_calls(name, monkeypatch)
    assert len(calls) == 1
    x, kv, wq, wp = calls[0]
    assert x.shape == (1, 3136, c) and kv.shape == (1, 49, 2 * c)
    wq, wp = wq.to(x.dtype).contiguous(), wp.to(x.dtype).contiguous()
    assert sra_route(x, kv, wq, wp, torch.empty_like(x))
    f32 = [t.float() for t in (x, kv, wq, wp)]
    assert not sra_route(*f32, torch.empty_like(f32[0]))


def _bf16(*shape, offset=0):
    flat = torch.zeros(int(torch.tensor(shape).prod()) + offset,
                       dtype=torch.bfloat16)
    return flat[offset:].view(*shape)


def test_sra_route_limits():
    """S = 256 (phase 19's), C = 512, C = 72 or 8 (no multiple of 16), an
    operand one element off a 16-byte boundary, a strided x and kv rows
    that are no whole 16 bytes apart leave the route; kv as a view of a
    wider tensor with 16-byte strides stays on it."""
    def call(b=2, n=100, s=49, c=64, x_off=0, kv_extra=0, kv_off=0):
        x = _bf16(b, n, c, offset=x_off)
        kv = _bf16(b, s, 2 * c + kv_extra, offset=kv_off)[..., :2 * c]
        w = _bf16(c, c)
        return sra_route(x, kv, w, w, _bf16(b, n, c))

    assert call()
    assert call(c=16) and call(c=48) and call(s=64) and call(s=1)
    assert call(kv_extra=8) and call(x_off=8) and call(kv_off=8)
    assert not call(s=256) and not call(s=65)
    assert not call(c=512) and not call(c=72) and not call(c=8)
    assert not call(x_off=1) and not call(kv_off=1) and not call(kv_extra=1)
    x = _bf16(2, 100, 128)[..., ::2]
    kv, w = _bf16(2, 49, 128), _bf16(64, 64)
    assert not sra_route(x, kv, w, w, _bf16(2, 100, 64))
    assert not sra_route(_bf16(2, 100, 64), kv, w.t(), w, _bf16(2, 100, 64))


# -- ln_dense's backward ------------------------------------------------------

LN_BWD_SHAPES = [(197, 768, 2304), (130, 96, 40), (1, 64, 8), (300, 136, 200)]


@pytest.mark.parametrize("m,c,o", LN_BWD_SHAPES)
def test_ln_dense_bwd_boxes_give_every_tile(m, c, o):
    """At every tile width: per 128 x width tile of dz = g w and k step, the
    A box (128 rows of g at (64 kt, m0)) and the width / 64 B boxes (64
    columns of w at (n0 + 64 i, 64 kt)) hold the tile's operands with zeros
    past M, C and O, and their products summed over the k steps give the
    tile and nothing past M or C. The same for each slice of dW = g^T z:
    two A boxes of 64 columns of g at (m0 + 64 wg, row) (g^T's rows) and
    the B boxes of z, zeros past O, C and M, each slice's rows only; the
    slices' partials sum to g^T z."""
    gen = torch.Generator().manual_seed(m + c + o)
    g = torch.randn(m, o, generator=gen)
    w = torch.randn(o, c, generator=gen)
    z = torch.randn(m, c, generator=gen)
    dz_a, dz_b, dw_a, dw_b = ln_dense_bwd_maps(m, c, o)
    for geometry in (dz_a, dz_b, dw_a, dw_b):
        _check_rules(geometry)
        assert geometry.box[0] * ELEM_BYTES == SWIZZLE_BYTES
    assert [g_.box[1] for g_ in (dz_a, dz_b, dw_a, dw_b)] == [GEMM_ROWS, TILE,
                                                              TILE, TILE]
    for width in LN_BWD_WIDTHS:
        dz = torch.zeros(m, c)
        for m0, n0 in _gemm_tiles(m, c, width):
            acc = torch.zeros(GEMM_ROWS, width)
            for kt in range(-(-o // TILE)):
                a = tma_load(g.reshape(-1), dz_a, (TILE * kt, m0))
                bs = torch.cat([tma_load(w.reshape(-1), dz_b,
                                         (n0 + TILE * i, TILE * kt))
                                for i in range(width // TILE)], dim=1)
                assert torch.equal(a, _padded(
                    g[m0:m0 + GEMM_ROWS, TILE * kt:TILE * (kt + 1)],
                    GEMM_ROWS, TILE))
                assert torch.equal(bs, _padded(
                    w[TILE * kt:TILE * (kt + 1), n0:n0 + width], TILE, width))
                acc += a @ bs
            rows, cols = min(GEMM_ROWS, m - m0), min(width, c - n0)
            assert bool((acc[rows:] == 0).all())
            assert bool((acc[:, cols:] == 0).all())
            dz[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
        assert torch.allclose(dz, g @ w, atol=1e-4)
        for splits in (1, 2, 3):
            per_split = -(-(-(-m // TILE)) // splits) * TILE
            splits = -(-m // per_split)
            dw = torch.zeros(o, c)
            for split in range(splits):
                r_begin = split * per_split
                steps = -(-min(m - r_begin, per_split) // TILE)
                for m0, n0 in _gemm_tiles(o, c, width):
                    acc = torch.zeros(GEMM_ROWS, width)
                    for kt in range(steps):
                        r = r_begin + TILE * kt
                        a = torch.cat([tma_load(g.reshape(-1), dw_a,
                                                (m0 + TILE * wg, r))
                                       for wg in range(2)], dim=1)
                        bs = torch.cat([tma_load(z.reshape(-1), dw_b,
                                                 (n0 + TILE * i, r))
                                        for i in range(width // TILE)], dim=1)
                        assert torch.equal(a, _padded(
                            g[r:r + TILE, m0:m0 + GEMM_ROWS], TILE, GEMM_ROWS))
                        acc += a.t() @ bs
                    rows, cols = min(GEMM_ROWS, o - m0), min(width, c - n0)
                    dw[m0:m0 + rows, n0:n0 + cols] += acc[:rows, :cols]
            assert torch.allclose(dw, g.t() @ z, atol=1e-3)


def test_ln_dense_bwd_plan():
    """ViT-B/16's dz at 192-column tiles (396 tiles: three whole rounds of
    132 SMs); every plan: widths of the body, one block an SM at most,
    slices of whole 64-row steps that cover M with none empty."""
    assert ln_dense_bwd_plan(12608, 768, 2304, 132).dz_width == 192
    assert ln_dense_bwd_plan(12608, 768, 3072, 132).dz_width == 192
    for m, c, o in [(12608, 768, 2304), (12608, 768, 3072), (25216, 768, 3072),
                    (197, 768, 2304), (130, 96, 40), (1, 768, 256),
                    (394, 1024, 3072)]:
        plan = ln_dense_bwd_plan(m, c, o, 132)
        assert plan.dz_width in LN_BWD_WIDTHS and plan.dw_width in LN_BWD_WIDTHS
        assert 1 <= plan.dz_blocks <= 132 and 1 <= plan.dw_blocks <= 132
        assert plan.per_split % TILE == 0
        assert plan.splits * plan.per_split >= m
        assert (plan.splits - 1) * plan.per_split < m
        packed = list(packed_ln_dense_bwd_maps(m, c, o, 132))
        assert packed[:-6] == [v for g_ in ln_dense_bwd_maps(m, c, o)
                               for v in g_.pack()]
        assert packed[-6:] == [plan.dz_blocks, plan.dz_width, plan.dw_blocks,
                               plan.dw_width, plan.splits, plan.per_split]


@pytest.mark.parametrize("m,c,o", [(12608, 768, 2304), (12608, 768, 3072),
                                   (197, 96, 40)])
def test_ln_dense_bwd_dw_costs(m, c, o):
    """The dW plans ranked cheapest first, each (width, slices) once; the
    plan takes the first: at ViT-B/16's LN1 -> qkv two slices of 108
    128 x 256 tiles, at LN2 -> fc1 four slices of 192-column tiles, the
    fastest of the four plans each that the model ranked first on an H100
    (scripts/perf/torch_ln_dense_bwd_plans.py)."""
    costs = ln_dense_bwd_dw_costs(m, c, o, 132)
    assert [k[0] for k in costs] == sorted(k[0] for k in costs)
    assert len({k[1:3] for k in costs}) == len(costs)
    plan = ln_dense_bwd_plan(m, c, o, 132)
    assert costs[0][1:] == (plan.dw_width, plan.splits, plan.per_split)
    if (m, c, o) == (12608, 768, 2304):
        assert (plan.dw_width, plan.splits, plan.dw_blocks) == (256, 2, 108)
    if (m, c, o) == (12608, 768, 3072):
        assert (plan.dw_width, plan.splits) == (192, 4)


def _ln_bwd_operands(m, c, o, dtype=torch.bfloat16, offset=0):
    x = torch.zeros(m * c + offset, dtype=dtype)[offset:].view(m, c)
    w, g = torch.zeros(o, c, dtype=dtype), torch.zeros(m, o, dtype=dtype)
    return x, w, g, torch.empty_like(x)


@pytest.mark.parametrize("m,c,o,dtype,offset,route", [
    (12608, 768, 2304, torch.bfloat16, 0, True),    # ViT-B/16 LN1 -> qkv
    (12608, 768, 3072, torch.bfloat16, 0, True),    # LN2 -> fc1
    (197, 1024, 3072, torch.bfloat16, 0, True),     # ViT-L
    (197, 96, 40, torch.bfloat16, 0, True),
    (197, 768, 2304, torch.float32, 0, False),      # f32: the first body
    (130, 100, 36, torch.bfloat16, 0, False),       # C, O no multiples of 8
    (40, 3072, 64, torch.bfloat16, 0, False),       # C above the dx pass
    (197, 768, 2304, torch.bfloat16, 1, False),     # x off 16 bytes
    (197, 768, 2304, torch.bfloat16, 8, True),      # 16 bytes on
])
def test_ln_dense_bwd_route(m, c, o, dtype, offset, route):
    """Which backward calls take the Hopper body."""
    assert ln_dense_bwd_route(*_ln_bwd_operands(m, c, o, dtype, offset)) \
        is route


def test_ln_dense_bwd_route_limits():
    """C = LN_BWD_MAX_DIM stays on the route, C above it, O = 36, a g or a
    weight that is not contiguous, M = 0 and a 3-D x leave it."""
    x, w, g, dx = _ln_bwd_operands(8, LN_BWD_MAX_DIM, 64)
    assert ln_dense_bwd_route(x, w, g, dx)
    assert not ln_dense_bwd_route(*_ln_bwd_operands(8, LN_BWD_MAX_DIM + 8,
                                                    64))
    assert not ln_dense_bwd_route(*_ln_bwd_operands(8, 64, 36))
    x, w, g, dx = _ln_bwd_operands(8, 64, 64)
    assert not ln_dense_bwd_route(x, w.t(), g, dx)
    assert not ln_dense_bwd_route(x, w, g.t(), dx)
    assert not ln_dense_bwd_route(*_ln_bwd_operands(0, 64, 64))
    assert not ln_dense_bwd_route(x.view(2, 4, 64), w, g, dx)

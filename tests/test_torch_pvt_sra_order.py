"""The order of work of ``pvt_sra``'s Hopper body (``csrc/pvt_sra.cu`` on
``tma.sra_route``), emulated in plain PyTorch on the CPU, against the JAX
package's Pallas SRA kernel in interpret mode.

``kernel_order`` follows the body: x in 64-row tiles of one image, rows
past N zeros; k and v as the 64-row boxes of the kv map, rows past S zeros
whatever the memory past them holds; q = (x wq^T + bq) scale rounded to the
dtype; the scores over C, keys past S at -inf; e = 2^((s - max) log2(e))
and p = e times the reciprocal of the row sum, rounded; o = p v over whole
16-key steps, rounded; y = o wp^T + bp, rounded once. Inputs are made with
numpy from a seed, as ``tests/test_torch_pvt_sra.py`` makes them. Bars:
1e-5 in f32 and 2e-2 of the largest reference value in bf16. Two controls
must miss: v's pad rows read from memory that holds NaN there (a body
without the box's zero fill), and the pad keys left in the softmax.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.ops.pallas.pvt_sra import sra_attention_or_none

torch.set_num_threads(1)

TILE = 64


def _inputs(b, n, s, c, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return (rnd(b, n, c), rnd(b, s, c), rnd(b, s, c), rnd(c, c, scale=c ** -0.5),
            rnd(c, scale=0.1), rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1))


def _kv_in_memory(k, v, extra):
    """kv (B, S, 2C) as a view of a tensor ``extra`` rows longer an image,
    the rows past S holding NaN."""
    b, s, c = k.shape
    big = torch.full((b, s + extra, 2 * c), float("nan"), dtype=k.dtype)
    big[:, :s, :c], big[:, :s, c:] = k, v
    return big[:, :s]


def _box_rows(kv, rows, fill_past_s=True):
    """The kv map's (64-row) box of each image: kv's S rows, then zeros, or
    (without the fill) what the memory past S holds."""
    b, s, c2 = kv.shape
    if fill_past_s:
        box = torch.zeros(b, rows, c2, dtype=kv.dtype)
        box[:, :s] = kv
        return box
    return torch.as_strided(kv, (b, rows, c2), kv.stride())


def kernel_order(x, kv, wq, bq, wp, bp, scale, fill_past_s=True,
                 mask_keys=True):
    """The Hopper body's arithmetic on x (B, N, C) and kv (B, S, 2C), wq and
    wp (C, C) in the Dense layout, bq and bp f32."""
    dt, f32 = x.dtype, torch.float32
    b, n, c = x.shape
    s = kv.shape[1]
    tiles = -(-n // TILE)
    xt = torch.zeros(b, tiles * TILE, c, dtype=dt)
    xt[:, :n] = x
    xt = xt.view(b, tiles, TILE, c).to(f32)
    box = _box_rows(kv, TILE, fill_past_s).to(f32)
    k, v = box[..., :c].unsqueeze(1), box[..., c:].unsqueeze(1)
    q = ((xt @ wq.to(dt).to(f32).t() + bq) * scale).to(dt).to(f32)
    sc = q @ k.transpose(-1, -2)
    if mask_keys:
        sc[..., s:] = float("-inf")
    e = torch.exp2((sc - sc.amax(-1, keepdim=True)) * math.log2(math.e))
    p = (e * (1.0 / e.sum(-1, keepdim=True))).to(dt).to(f32)
    steps = 16 * -(-s // 16)
    o = (p[..., :steps] @ v[..., :steps, :]).to(dt).to(f32)
    y = (o @ wp.to(dt).to(f32).t() + bp).to(dt)
    return y.reshape(b, tiles * TILE, c)[:, :n]


def _jax_kernel(x, k, v, wq, bq, wp, bp, scale, dtype):
    dt = getattr(jnp, dtype)
    return np.asarray(jnp.asarray(sra_attention_or_none(
        jnp.asarray(x, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
        jnp.asarray(wq), jnp.asarray(bq), jnp.asarray(wp), jnp.asarray(bp),
        scale=scale), jnp.float32))


def _miss(got, want):
    """The error in units of 2e-2 of max|want|, NaN counting as a miss."""
    got = got.float().numpy()
    if not np.isfinite(got).all():
        return math.inf
    return np.abs(got - want).max() / (2e-2 * np.abs(want).max())


def _case(b, n, s, c, dtype, extra):
    x, k, v, wq, bq, wp, bp = _inputs(b, n, s, c, seed=n + s + c)
    scale = c ** -0.5
    want = _jax_kernel(x, k, v, wq, bq, wp, bp, scale, dtype)
    tdt = getattr(torch, dtype)
    t = torch.from_numpy
    kv = _kv_in_memory(t(k).to(tdt), t(v).to(tdt), extra)
    args = (t(x).to(tdt), kv, t(wq.T.copy()), t(bq), t(wp.T.copy()), t(bp),
            scale)
    return want, args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,s,c,extra", [
    (2, 200, 49, 64, 15),    # S = 49 padded to 64; NaN past S; ragged N
    (1, 130, 49, 32, 15),    # pvt_v2_b0's C = 32
    (2, 64, 64, 48, 0),      # S = 64: no pad key
    (1, 70, 1, 16, 3),       # one key
])
def test_kernel_order_matches_the_pallas_kernel(monkeypatch, b, n, s, c,
                                                extra, dtype):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    want, args = _case(b, n, s, c, dtype, extra)
    got = kernel_order(*args)
    assert got.dtype == args[0].dtype and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert _miss(got, want) <= 1.0


@pytest.mark.parametrize("control", ["nan_pad_rows", "pad_keys_unmasked"])
def test_controls_miss(monkeypatch, control):
    """Reading v's pad rows from memory (NaN there) gives NaN; leaving the
    pad keys in the softmax moves the result by many bars."""
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    want, args = _case(2, 200, 49, 64, "bfloat16", 15)
    kw = ({"fill_past_s": False} if control == "nan_pad_rows"
          else {"mask_keys": False})
    assert _miss(kernel_order(*args, **kw), want) > 5.0


def test_sra_parts_cuts_are_where_the_timing_script_finds_them():
    """scripts/perf/torch_sra_parts.py times pvt_sra's Hopper body with a
    part changed by replacing lines in a copy of pvt_sra.cu: each form's
    replacements apply in turn, each line there once when it is replaced."""
    import importlib.util
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    path = repo / "scripts" / "perf" / "torch_sra_parts.py"
    spec = importlib.util.spec_from_file_location("torch_sra_parts", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    code = (repo / "tfimm_tpu_torch" / "csrc" / "pvt_sra.cu").read_text()
    assert set(script.ORDER) == set(script.CUTS)
    for form, cuts in script.CUTS.items():
        text = code
        for old, new in cuts:
            assert text.count(old) == 1, (form, old)
            text = text.replace(old, new)


# -- The body's barriers ------------------------------------------------------
#
# A model of pvt_sra_wgmma_kernel's producer thread and two consumer
# warpgroups on one block, step for step as pvt_sra.cu writes them, over the
# block's [begin, end) of the B * ceil(N / 64) tiles (tma.sra_grid's blocks
# on 132 SMs). An mbarrier completes a phase when its arrivals reach its
# count and its transaction bytes are in; a wait on parity P returns once the
# phase of parity P completed (at once, on a fresh barrier, for P = 1). The
# TMA loads land in any order after they are issued. A scheduler picks what
# runs next from a seeded random stream (and two fixed biases), and the walk
# fails where nothing can run before every agent ends (a hang on the card),
# where a load is issued into a buffer a consumer still holds, or where a
# consumer reads a stage or a kv buffer that does not hold its tile's data.

STAGES = 8          # pvt_sra.cu · kStages
CONSUMERS = 2       # window_mha_common.cuh · kConsumers
WARPS = 4           # a consumer warpgroup's warps, one arrival each
SMS = 132


class _Barrier:
    def __init__(self, count):
        self.count, self.arrived, self.tx, self.phase = count, 0, 0, 0
        self.tags = set()

    def arrive(self, tx=0, tag=None):
        assert self.arrived < self.count, "an arrival past the count"
        self.arrived += 1
        self.tx += tx
        if tag is not None:
            self.tags.add(tag)
            assert len(self.tags) == 1, f"one phase, images {self.tags}"
        self._complete()

    def land(self, tx):
        self.tx -= tx
        self._complete()

    def _complete(self):
        if self.arrived == self.count and self.tx == 0:
            self.arrived, self.phase, self.tags = 0, self.phase + 1, set()

    def passed(self, parity):
        return (self.phase & 1) != parity


def _walk_block(begin, end, tiles_per_image, release_first, pick):
    """Runs one block's agents to their ends; returns "ok" or "hang"."""
    count = end - begin
    img0 = begin // tiles_per_image
    images = (end - 1) // tiles_per_image - img0 + 1
    full = [_Barrier(1) for _ in range(STAGES)]
    empty = [_Barrier(WARPS) for _ in range(STAGES)]
    kv_full = [_Barrier(1) for _ in range(2)]
    kv_empty = [_Barrier(WARPS * CONSUMERS) for _ in range(2)]
    w_full = _Barrier(1)
    ring, kv_buf = [None] * STAGES, [None] * 2
    pending = []                         # issued loads: (barrier, tx, effect)
    reading = [None] * CONSUMERS         # the stage a consumer reads
    held = [None] * CONSUMERS            # images [done, have] a consumer
                                         # reached and has not released

    def wait(bar, parity):
        return lambda: bar.passed(parity)

    def load(bar, tx, effect):
        pending.append((bar, tx, effect))

    def set_ring(st, t):
        def effect():
            ring[st] = t
        return effect

    def set_kv(buf, img):
        def effect():
            kv_buf[buf] = img
        return effect

    def producer():
        w_full.arrive(tx=2)
        load(w_full, 2, lambda: None)
        loaded = img0 - 1
        for t in range(count):
            tile = begin + t
            img = tile // tiles_per_image
            if img != loaded:
                j = img - img0
                if j >= 2:
                    yield wait(kv_empty[j & 1], ((j >> 1) & 1) ^ 1)
                for done, have in filter(None, held):
                    assert all(i & 1 != j & 1 for i in range(done, have + 1)), \
                        "k and v loaded over an image a consumer holds"
                kv_full[j & 1].arrive(tx=2)
                load(kv_full[j & 1], 2, set_kv(j & 1, img))
                loaded = img
            st = t % STAGES
            if t >= STAGES:
                yield wait(empty[st], ((t // STAGES) & 1) ^ 1)
            assert st not in reading, "x loaded over a stage being read"
            full[st].arrive(tx=1)
            load(full[st], 1, set_ring(st, t))

    def consumer(wg):
        state = {"have": -1, "done": 0}

        def reach(j):
            while state["have"] < j:
                state["have"] += 1
                have = state["have"]
                yield wait(kv_full[have & 1], (have >> 1) & 1)
                assert kv_buf[have & 1] == img0 + have, "kv_full passed early"
                held[wg] = (state["done"], have)

        def release_to(j):
            while state["done"] < j:
                yield from reach(state["done"])
                for _ in range(WARPS):
                    kv_empty[state["done"] & 1].arrive(tag=state["done"])
                state["done"] += 1
                held[wg] = (state["done"], state["have"])

        yield wait(w_full, 0)
        for t in range(wg, count, CONSUMERS):
            st = t % STAGES
            img = (begin + t) // tiles_per_image
            j = img - img0
            if release_first:
                yield from release_to(j)
            yield wait(full[st], (t // STAGES) & 1)
            assert ring[st] == t, "a stage read before its x landed"
            reading[wg] = st
            yield lambda: True               # the q product
            reading[wg] = None
            for _ in range(WARPS):
                empty[st].arrive()
            if not release_first:
                yield from release_to(j)
            yield from reach(j)
            assert kv_buf[j & 1] == img
            yield lambda: True               # s, p v and the projection
            assert kv_buf[j & 1] == img, "k and v overwritten in use"
        yield from release_to(images)
        held[wg] = None

    agents = [producer(), consumer(0), consumer(1)]
    ready = {}
    for a in agents:
        try:
            ready[a] = next(a)
        except StopIteration:
            pass
    while ready or pending:
        runnable = [a for a, ok in ready.items() if ok()]
        choices = runnable + list(range(len(pending)))
        if not choices:
            return "hang"
        choice = choices[pick(len(choices))]
        if isinstance(choice, int):
            bar, tx, effect = pending.pop(choice)
            effect()
            bar.land(tx)
            continue
        try:
            ready[choice] = next(choice)
        except StopIteration:
            del ready[choice]
    return "ok"


def _picks():
    """Three seeded random schedulers and two fixed ones (the first choice:
    the producer ahead; the last: loads and consumers ahead)."""
    for seed in range(3):
        rng = np.random.default_rng(seed)
        yield lambda k, rng=rng: int(rng.integers(k))
    yield lambda k: 0
    yield lambda k: k - 1


def _blocks(b, n):
    """The distinct (begin, end) walks of tma.sra_grid's blocks, up to the
    image a block starts in."""
    from tfimm_tpu_torch.ops.kernels.tma import sra_grid

    tiles_per_image = -(-n // TILE)
    tiles = b * tiles_per_image
    grid = sra_grid(b, n, SMS)
    seen = {}
    for blk in range(grid):
        begin, end = tiles * blk // grid, tiles * (blk + 1) // grid
        key = (begin % tiles_per_image, end - begin)
        seen.setdefault(key, (begin, end))
    return tiles_per_image, sorted(seen.values())


# (B, N, S, C) and the most tiles a block takes: one 64-row tile an image,
# three a block; pvt_v2_b2's stage 1 at bs128 (images split between
# blocks); a ragged N over few images; a block a tile.
@pytest.mark.parametrize("b,n,s,c,most", [
    (300, 49, 49, 64, 3), (300, 64, 1, 16, 3), (128, 3136, 49, 64, 48),
    (4, 3001, 49, 64, 2), (2, 33, 1, 16, 1)])
def test_barrier_walk_ends_with_every_tile_read(b, n, s, c, most):
    tiles_per_image, blocks = _blocks(b, n)
    assert max(e - bg for bg, e in blocks) == most
    for begin, end in blocks:
        for pick in _picks():
            assert _walk_block(begin, end, tiles_per_image, True, pick) == "ok"


def test_barrier_walk_control_hangs():
    """Releasing the earlier images only after the tile's x wait (the order
    that hung) cannot end with one tile an image and three a block."""
    tiles_per_image, blocks = _blocks(300, 49)
    begin, end = next(bl for bl in blocks if bl[1] - bl[0] >= 3)
    for pick in _picks():
        assert _walk_block(begin, end, tiles_per_image, False, pick) == "hang"


def test_body_releases_before_its_x_wait():
    """The model's order is the body's: pvt_sra.cu releases the images before
    a tile's (release_to(j)) before it waits for the tile's x."""
    from pathlib import Path

    code = (Path(__file__).resolve().parents[1] / "tfimm_tpu_torch" / "csrc"
            / "pvt_sra.cu").read_text()
    body = code[code.index("pvt_sra_wgmma_kernel("):]
    loop = body[body.index("for (int t = wg; t < count;"):]
    assert loop.index("release_to(j);") < loop.index("mbar_wait(&full[st]")
    assert loop.count("release_to(j);") == 1

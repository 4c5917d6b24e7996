"""swin_block and poolformer_block on ``csrc/mlp_gemm.cuh``: their sources
hold no GEMM of their own, and the order of work of their bf16 TMA + wgmma
path, emulated in plain PyTorch on the CPU, holds the JAX package's Pallas
kernels in interpret mode (``swin_block_fused``,
``poolformer_block_or_none``).

The emulations follow the kernels where they depart from the plain
versions:
- Swin: fc1's GELU in the wgmma body's form s / (1 + e^(-2u)) (``mlp_gemm.cuh
  · gelu_tanh_wgmma``), taken after fc1 is rounded to bf16; LN2 from the
  f32 X2 with each row's one-pass statistics (``kNormF32``, p.group = 1),
  X2 = x + round(P) written in f32 (``kProj``), out = X2 + (acc + b2) with
  X2 as an f32 shortcut (``kResidualF32``, gamma absent).
- PoolFormer: GN2 as the norm prologue on the f32 x1 with the statistics
  of each row's image (p.group = H * W rows), the two-pass variance of
  ``gn_stats_kernel``; the GELU in the wgmma form; out = x1 + ls2 * (acc +
  b2) with x1 as an f32 shortcut.
In f32 the FMA body keeps the plain versions' GELUs (erf for Swin, the tanh
form for PoolFormer) and the same statistics.

Bars, as max|diff| / max|JAX|: bf16 2e-2 (the kernels round at the same
places; sums run in another order and the GELU forms differ in the last
bit); f32 1e-4 for Swin (four products and two LayerNorms) and 1e-5 for
PoolFormer, as the plain versions' tests. Controls that take the wrong
statistics index (a window's or an image's statistics for Swin's rows, each
row's own for PoolFormer's GN2) must miss the bar by more than
CONTROL_FACTOR bars. Inputs are made with numpy from a seed.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfimm_tpu.architectures.swin import (
    SwinTransformerBlock as JaxSwinBlock,
    SwinTransformerConfig as JaxSwinConfig,
    window_partition as jax_window_partition,
)
from tfimm_tpu.ops.pallas.poolformer_block import poolformer_block_or_none
from tfimm_tpu.ops.pallas.swin_block import _prep_params, swin_block_fused
from tfimm_tpu_torch.ops.kernels.swin_block import SwinBlockParams
from tfimm_tpu_torch.ops.kernels.window_mha import window_mha_reference
from tfimm_tpu_torch.ops.pool import avg_pool_2d_exclude_pad

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "tfimm_tpu_torch" / "csrc"
CONTROL_FACTOR = 5.0
EPS = 1e-5


def _rel(got, want):
    got = np.asarray(got.float().numpy(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the sources -------------------------------------------------------------

# The kernels each file may keep beside the products: row statistics, and
# PoolFormer's GroupNorm statistics and pool.
OWN_KERNELS = {"swin_block.cu": {"swin_row_stats_kernel"},
               "poolformer_block.cu": {"gn_stats_kernel", "pool_x1_kernel"}}


@pytest.mark.parametrize("name", sorted(OWN_KERNELS))
def test_blocks_hold_no_gemm_of_their_own(name):
    """No mma.sync, ldmatrix or wgmma and no __global__ GEMM in the block's
    source: its products are mlp_gemm.cuh's, declared through its macros."""
    src = (CSRC / name).read_text()
    code = re.sub(r"//[^\n]*", "", src)
    for word in ("mma.sync", "ldmatrix", "wgmma.", "mma_async"):
        assert word not in code, word
    assert '#include "mlp_gemm.cuh"' in code
    assert "CNX_WGMMA_KERNEL" in code and "CNX_TILE_KERNEL" in code
    kernels = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", code))
    assert kernels == OWN_KERNELS[name]
    for symbol in ("struct GemmArgs", "MmaStage", "mma_load", "mma_store",
                   "store_out", "load_chunk", "struct Chunk"):
        assert symbol not in code, symbol


def test_swin_x2_statistics_switch_is_where_the_timing_script_finds_it():
    """scripts/perf/torch_swin_x2_stats.py builds the block with X2's
    statistics on their own launch by replacing, in a copy of the sources,
    the condition under which proj's epilogue takes them: the condition is
    in swin_block.cu once, and the launch it leaves out is there."""
    import importlib.util

    path = CSRC.parents[1] / "scripts" / "perf" / "torch_swin_x2_stats.py"
    spec = importlib.util.spec_from_file_location("torch_swin_x2_stats", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    code = re.sub(r"//[^\n]*", "", (CSRC / "swin_block.cu").read_text())
    assert code.count(script.EPILOGUE_CONDITION) == 1
    assert "if (!x2_stats)" in code


# -- Swin --------------------------------------------------------------------

def _jax_block(shift, c, heads, seed):
    """A JAX Swin block on a 14x14 map with seeded parameters: LN scales
    near 1, the bias table at std 0.3, the rest at std 0.05."""
    cfg = JaxSwinConfig(name="t", window_size=7)
    blk = JaxSwinBlock(cfg, input_size=(14, 14), embed_dim=c, nb_heads=heads,
                       drop_path_rate=0.0, shift_size=shift)
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(
        blk.init(jax.random.PRNGKey(0)))
    new = []
    for path, leaf in leaves:
        r = rng.normal(size=np.shape(leaf)).astype(np.float32)
        key = getattr(path[-1], "key", None)
        scale = {"scale": 0.1, "relative_position_bias_table": 0.3}.get(key, 0.05)
        new.append(jnp.asarray((1.0 if key == "scale" else 0.0) + scale * r))
    return blk, jax.tree_util.tree_unflatten(tree, new)


def _port_params(p):
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return SwinBlockParams(
        t(p["norm1"]["scale"]), t(p["norm1"]["bias"]),
        t(p["attn"]["qkv"]["kernel"]).t(), t(p["attn"]["qkv"]["bias"]),
        t(p["attn"]["proj"]["kernel"]).t(), t(p["attn"]["proj"]["bias"]),
        t(p["norm2"]["scale"]), t(p["norm2"]["bias"]),
        t(p["mlp"]["fc1"]["kernel"]).t(), t(p["mlp"]["fc1"]["bias"]),
        t(p["mlp"]["fc2"]["kernel"]).t(), t(p["mlp"]["fc2"]["bias"]))


def _norm_rows(x32, weight, bias, rows, two_pass=False):
    """The norm prologue over (M, C) f32 rows: statistics of each group of
    ``rows`` rows (one-pass variance max(E[x^2] - mean^2, 0) as row_stats,
    or two-pass as gn_stats), then ((x - mean) * rstd) * w + b in f32."""
    m, c = x32.shape
    g = x32.reshape(m // rows, rows * c)
    mean = g.mean(dim=1, keepdim=True)
    if two_pass:
        var = (g - mean).square().mean(dim=1, keepdim=True)
    else:
        var = torch.clamp(g.square().mean(dim=1, keepdim=True) - mean.square(),
                          min=0.0)
    z = (g - mean) * torch.rsqrt(var + EPS)
    return z.reshape(m, c) * weight + bias


def gelu_wgmma(s):
    """mlp_gemm.cuh · gelu_tanh_wgmma: s / (1 + e^(-2u))."""
    u = 0.7978845608028654 * (s + 0.044715 * s * s * s)
    return s / (1.0 + torch.exp(-2.0 * u))


def swin_kernel_order(x, params, bias, mask, nb_heads, scale, stat_rows=1):
    """swin_block as its seven launches compute it (bf16: the wgmma body's
    epilogues; f32: the FMA body's), on x (BW, N, C). ``stat_rows``: rows a
    LayerNorm statistic (the kernels' 1; a control takes more)."""
    dt = x.dtype
    bf16 = dt == torch.bfloat16
    bw, n, c = x.shape
    p = SwinBlockParams(*(t.float() if t.dim() == 1 else t.to(dt).float()
                          for t in params))
    x32 = x.float().reshape(-1, c)

    def dense(a, w, b):
        return a.float() @ w.t() + b

    h1 = _norm_rows(x32, p.ln1_w, p.ln1_b, stat_rows).to(dt)
    qkv = dense(h1, p.w_qkv, p.b_qkv).to(dt).reshape(bw, n, 3 * c)
    a = window_mha_reference(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                             bias, mask, nb_heads=nb_heads, scale=scale)
    x2 = x32 + dense(a.reshape(-1, c), p.w_proj, p.b_proj).to(dt).float()
    h2 = _norm_rows(x2, p.ln2_w, p.ln2_b, stat_rows).to(dt)
    s = dense(h2, p.w1, p.b1).to(dt).float()
    m1 = (gelu_wgmma(s) if bf16
          else torch.nn.functional.gelu(s, approximate="none")).to(dt)
    out = x2 + dense(m1, p.w2, p.b2)
    return out.to(dt).reshape(bw, n, c)


def _swin_case(shift, c, heads, dtype):
    blk, p = _jax_block(shift, c, heads, seed=c + shift)
    ss = blk.shift_size
    # Tokens of their own scale and offset, as a LayerNorm's inputs are.
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 14, 14, c)) * rng.uniform(0.5, 2.0, (2, 14, 14, 1))
         + rng.normal(size=(2, 14, 14, 1))).astype(np.float32)
    if ss:
        x = np.roll(x, (-ss, -ss), axis=(1, 2))
    wins = np.array(jax_window_partition(jnp.asarray(x), 7)).reshape(-1, 49, c)
    bias = np.array(blk._rel_bias(p))
    mask = None if blk.attn_mask is None else np.array(blk.attn_mask)
    scale = (c // heads) ** -0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = swin_block_fused(jnp.asarray(wins, jdt), _prep_params(p, c, jdt),
                            jnp.asarray(bias),
                            None if mask is None else jnp.asarray(mask),
                            nb_heads=heads, scale=scale, interpret=True)
    args = (torch.from_numpy(wins).to(tdt), _port_params(p),
            torch.from_numpy(bias),
            None if mask is None else torch.from_numpy(mask))
    return args, heads, scale, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype,bar", [("bfloat16", 2e-2), ("float32", 1e-4)])
@pytest.mark.parametrize("shift,c,heads", [(3, 96, 3), (0, 192, 6)])
def test_swin_kernel_order_matches_the_pallas_kernel(shift, c, heads, dtype,
                                                     bar):
    args, h, scale, want = _swin_case(shift, c, heads, dtype)
    got = swin_kernel_order(*args, nb_heads=h, scale=scale)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) < bar
    if dtype == "bfloat16":
        # Control: LayerNorm statistics of a whole window's rows.
        far = _rel(swin_kernel_order(*args, nb_heads=h, scale=scale,
                                     stat_rows=49), want)
        assert far > CONTROL_FACTOR * bar, far


def test_swin_wgmma_gelu_is_the_tanh_form_after_the_rounding():
    """s / (1 + e^(-2u)) is the tanh GELU: on bf16-rounded inputs both
    forms, rounded to bf16, agree but in the last bit (below 1e-6, where
    1 + tanh(u) cancels, they differ as tiny values), and they do not agree
    with the erf GELU."""
    s = torch.linspace(-8, 8, 4001).bfloat16().float()
    tanh = torch.nn.functional.gelu(s, approximate="tanh").bfloat16().float()
    wg = gelu_wgmma(s).bfloat16().float()
    erf = torch.nn.functional.gelu(s).bfloat16().float()
    assert bool(((wg - tanh).abs() <= tanh.abs() * 2.0 ** -7 + 1e-6).all())
    assert float((wg != erf).float().mean()) > 0.05


# -- PoolFormer --------------------------------------------------------------

def _pool_inputs(b, h, w, c, hidden, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    return dict(x=rnd(b, h, w, c), n1w=rnd(c, scale=0.1, shift=1.0),
                n1b=rnd(c, scale=0.1), n2w=rnd(c, scale=0.1, shift=1.0),
                n2b=rnd(c, scale=0.1), w1=rnd(c, hidden, scale=c ** -0.5),
                b1=rnd(hidden, scale=0.1),
                w2=rnd(hidden, c, scale=hidden ** -0.5), b2=rnd(c, scale=0.1),
                ls1=rnd(c, scale=0.1, shift=1.0),
                ls2=rnd(c, scale=0.1, shift=1.0))


def _pallas_pool(monkeypatch, a, dtype):
    monkeypatch.setenv("TFIMM_TPU_PALLAS_INTERPRET", "1")
    c, hidden = a["w1"].shape
    params = {"norm1": {"scale": a["n1w"], "bias": a["n1b"]},
              "norm2": {"scale": a["n2w"], "bias": a["n2b"]},
              "mlp": {"fc1": {"kernel": a["w1"].reshape(1, 1, c, hidden),
                              "bias": a["b1"]},
                      "fc2": {"kernel": a["w2"].reshape(1, 1, hidden, c),
                              "bias": a["b2"]}},
              "layer_scale_1": a["ls1"], "layer_scale_2": a["ls2"]}
    out = poolformer_block_or_none(params, jnp.asarray(a["x"],
                                                       getattr(jnp, dtype)),
                                   mlp_ratio=hidden / c)
    return np.asarray(out.astype(jnp.float32))


def pool_kernel_order(a, dtype, per_image=True):
    """poolformer_block as its five launches compute it: GN1 and the pool
    into the f32 x1 (the plain version's function), then fc1 with the GN2
    prologue on the f32 x1 rows, statistics of each row's image (two-pass,
    as gn_stats; ``per_image`` False: each row's own, the control), z
    rounded, the GELU (bf16: the wgmma form; f32: the tanh form) rounded,
    and fc2 with x1 as the f32 shortcut, rounded once."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    b, h, w, c = t["x"].shape
    xf = t["x"].to(dtype).float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + EPS) * t["n1w"] + t["n1b"]
    x1 = (xf + (avg_pool_2d_exclude_pad(y, 3) - y) * t["ls1"]).reshape(-1, c)
    z = _norm_rows(x1, t["n2w"], t["n2b"], h * w if per_image else 1,
                   two_pass=True).to(dtype)
    w1, w2 = t["w1"].to(dtype).float(), t["w2"].to(dtype).float()
    s = z.float() @ w1 + t["b1"]
    gelu = (gelu_wgmma(s) if dtype == torch.bfloat16
            else torch.nn.functional.gelu(s, approximate="tanh"))
    o = gelu.to(dtype).float() @ w2 + t["b2"]
    return (x1 + t["ls2"] * o).to(dtype).reshape(b, h, w, c)


@pytest.mark.parametrize("dtype,bar", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("b,h,w,c,hidden", [(2, 6, 5, 16, 64),
                                            (1, 12, 12, 32, 128),
                                            (3, 7, 7, 24, 48)])
def test_pool_kernel_order_matches_the_pallas_kernel(monkeypatch, b, h, w, c,
                                                     hidden, dtype, bar):
    a = _pool_inputs(b, h, w, c, hidden, seed=h * w + c)
    want = _pallas_pool(monkeypatch, a, dtype)
    got = pool_kernel_order(a, getattr(torch, dtype))
    assert _rel(got, want) < bar
    # Control: GN2 with each row's own statistics.
    far = _rel(pool_kernel_order(a, getattr(torch, dtype), per_image=False),
               want)
    assert far > CONTROL_FACTOR * bar, far

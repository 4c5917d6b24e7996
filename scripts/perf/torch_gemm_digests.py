"""Digests of the outputs of ``csrc/mlp_gemm.cuh``'s other users.

``convnext_mlp``, ``convnext_block`` and ``ln_dense``'s forward on seeded
inputs (numpy, so that every PyTorch build makes the same ones), in bf16 on
the TMA + wgmma body and off it (C = 12, or an operand off 16 bytes: the
mma.sync body) and in f32 (the FMA body): the sha256 of each output's
bytes, its first 16 hex digits. Two checkouts whose kernels compute the same
bits print the same digests on one card, so running this from each tree
shows whether a change to the shared GEMM left those outputs as they were;
``tests/test_torch_cuda.py`` holds the digests of the tree they were taken
from.

    python3 scripts/perf/torch_gemm_digests.py [--root DIR]

``--root`` imports ``tfimm_tpu_torch`` from another checkout of the repo.
Needs a CUDA card; prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]

# (kernel, shape, dtype, off16): convnext_mlp (M, C, H); convnext_block (B,
# H, W, C, hidden); ln_dense (M, C, O, bias). off16: the first operand one
# element past a 16-byte boundary.
CASES = [("convnext_mlp", (3137, 128, 512), "bfloat16", False),
         ("convnext_mlp", (1000, 512, 2056), "bfloat16", False),
         ("convnext_mlp", (200, 12, 48), "bfloat16", False),
         ("convnext_mlp", (300, 128, 512), "bfloat16", True),
         ("convnext_mlp", (600, 96, 384), "float32", False),
         ("convnext_block", (2, 28, 28, 256, 1024), "bfloat16", False),
         ("convnext_block", (2, 14, 14, 128, 512), "bfloat16", True),
         ("convnext_block", (1, 9, 13, 128, 512), "float32", False),
         ("ln_dense", (394, 768, 2304, True), "bfloat16", False),
         ("ln_dense", (197, 96, 40, False), "bfloat16", False),
         ("ln_dense", (130, 100, 36, True), "float32", False)]


def _arrays(shapes, seed):
    """Seeded f32 arrays of the given (shape, scale, shift) triples."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale + shift).astype(np.float32)
            for shape, scale, shift in shapes]


def case_inputs(kind, shape, seed):
    """The f32 numpy inputs of one case, in the kernel's argument order."""
    if kind == "convnext_mlp":
        m, c, h = shape
        return _arrays([((m, c), 1, 0), ((m, c), 1, 0), ((c,), 0.1, 1),
                        ((c,), 0.1, 0), ((h, c), c ** -0.5, 0),
                        ((h,), 0.1, 0), ((c, h), h ** -0.5, 0),
                        ((c,), 0.1, 0), ((c,), 0.1, 1)], seed)
    if kind == "convnext_block":
        b, hh, ww, c, h = shape
        return _arrays([((b, hh, ww, c), 1, 0), ((c, 1, 7, 7), 0.2, 0),
                        ((c,), 0.1, 0), ((c,), 0.1, 1), ((c,), 0.1, 0),
                        ((h, c), c ** -0.5, 0), ((h,), 0.1, 0),
                        ((c, h), h ** -0.5, 0), ((c,), 0.1, 0),
                        ((c,), 0.1, 1)], seed)
    m, c, o, bias = shape
    arrays = _arrays([((m, c), 1, 0), ((c,), 0.1, 1), ((c,), 0.1, 0),
                      ((o, c), c ** -0.5, 0), ((o,), 0.1, 0)], seed)
    return arrays if bias else arrays[:4] + [None]


def digests(device="cuda") -> dict:
    """name -> the first 16 hex digits of the output's sha256, each case
    run once on ``device``."""
    import torch

    from tfimm_tpu_torch.ops.kernels.convnext_block import convnext_block
    from tfimm_tpu_torch.ops.kernels.convnext_mlp import convnext_mlp
    from tfimm_tpu_torch.ops.kernels.ln_dense import ln_dense

    out = {}
    for i, (kind, shape, dtype, off16) in enumerate(CASES):
        dt = getattr(torch, dtype)
        # Matrices and activations in the dtype, vectors (and the taps) f32.
        args = [None if a is None else torch.from_numpy(a).to(device)
                for a in case_inputs(kind, shape, seed=100 + i)]
        args = [a if a is None or a.dim() == 1 or (kind == "convnext_block"
                                                   and a.dim() == 4 and j == 1)
                else a.to(dt) for j, a in enumerate(args)]
        if off16:
            flat = torch.empty(args[0].numel() + 1, dtype=dt, device=device)
            first = flat[1:].view(args[0].shape)
            first.copy_(args[0])
            args[0] = first
        if kind == "convnext_mlp":
            y = convnext_mlp(*args, 1e-6)
        elif kind == "convnext_block":
            y = convnext_block(*args)
        else:
            y = ln_dense(*args, eps=1e-6)
        if device != "cpu":
            torch.cuda.synchronize()
        data = y.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        name = f"{kind} {shape} {dtype}{' off16' if off16 else ''}"
        out[name] = hashlib.sha256(data).hexdigest()[:16]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_gemm_digests: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"root": str(args.root), "digests": digests()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

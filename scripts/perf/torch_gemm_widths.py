"""Device time of swin_block's and poolformer_block's launches at each GEMM
tile width.

For Swin-T's stages 1-3 and PoolFormer-S12's four stages at batch 128 (bf16,
the seeded inputs of ``chip_smoke.py``), the block runs with
``tma.gemm_width`` pinned to each width of the GEMM body in turn (128, 192
and 256 columns for Swin's products, 128 and 256 for PoolFormer's; every
product of the block at that width), then as the wrappers pick the widths.
Each launch's device time comes from ``torch.profiler``, its operands out of
L2 (a 512 MB write before each call; ``chip_smoke.cold_device_events``), as
the mean over ``--calls`` calls; beside it the whole call's CUDA-event time
out of L2 (``chip_smoke.cold_ms``). The widths that ``tma.gemm_width`` takes
for these products follow from these times (``PERF.md`` §6).

    python3 scripts/perf/torch_gemm_widths.py [--calls 3] [--root DIR]

``--root`` imports ``tfimm_tpu_torch`` and ``chip_smoke`` from another
checkout of the repo. Needs a CUDA card; prints one line a (block, stage,
width, launch) and one JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# Launches of one call, by kernel name (the first key found in a name).
SWIN_PARTS = [("row statistics of x", ("swin_row_stats_kernel<__nv_bfloat16>",)),
              ("qkv", ("swin_qkv_",)),
              ("attention", ("window_mha",)),
              ("proj", ("swin_proj_",)),
              ("row statistics of X2", ("swin_row_stats_kernel<float>",)),
              ("fc1", ("swin_fc1_",)),
              ("fc2", ("swin_fc2_",))]
POOL_PARTS = [("GN1 statistics", ("gn_stats_kernel<__nv_bfloat16>",)),
              ("pool", ("pool_x1",)),
              ("GN2 statistics", ("gn_stats_kernel<float>",)),
              ("fc1", ("pf_fc1_",)),
              ("fc2", ("pf_fc2_",))]


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


# Launches a call runs only on some shapes (proj's epilogue takes X2's
# statistics where its tiles hold whole rows).
OPTIONAL = {"row statistics of X2"}


def launches(smoke, fn, parts, calls):
    """Each launch's device ms of one call of ``fn`` out of L2 (0 for an
    optional launch the call did not run), and the name of the kernel the
    profile found for it."""
    events = smoke.cold_device_events(
        fn, calls, need=[keys for part, keys in parts if part not in OPTIONAL])
    out = {}
    for part, keys in parts:
        hits = [(name, ms) for name, ms in events
                if any(k in name for k in keys)]
        name = re.search(r"::(\w+(?:<[^()]*>)?)\(", hits[0][0]) if hits else None
        out[part] = (sum(ms for _, ms in hits) / len(hits) if hits else 0.0,
                     name.group(1) if name else "none")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--root", type=Path, default=REPO)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root))
    import torch

    import chip_smoke as smoke
    from tfimm_tpu_torch.ops.kernels import tma
    from tfimm_tpu_torch.ops.kernels.poolformer_block import poolformer_block
    from tfimm_tpu_torch.ops.kernels.swin_block import swin_block

    if not torch.cuda.is_available():
        print("torch_gemm_widths: needs a CUDA card", file=sys.stderr)
        return 1
    gpu = gpu_line()
    print(gpu, flush=True)
    pick = tma.gemm_width
    results = []

    def pinned(width):
        tma.packed_gemm_maps.cache_clear()
        tma.gemm_width = pick if width is None else (
            lambda *a, **k: width)

    def measure(block, stage, width, fn, parts):
        pinned(width)
        try:
            parts_ms = launches(smoke, fn, parts, args.calls)
            call_ms = smoke.cold_ms(fn)
        finally:
            pinned(None)
        what = "picked" if width is None else width
        for part, (ms, name) in parts_ms.items():
            print(f"{block} {stage} width {what}: {part} {ms!r} ms ({name})",
                  flush=True)
        print(f"{block} {stage} width {what}: the call {call_ms!r} ms out of "
              f"L2 (CUDA events); launches sum "
              f"{sum(ms for ms, _ in parts_ms.values())!r} ms", flush=True)
        results.append({"block": block, "stage": stage, "width": what,
                        "call_ms": call_ms,
                        "launch_ms": {p: ms for p, (ms, _) in
                                      parts_ms.items()}})

    for bw, n, c, h, side in smoke.SWIN_STAGES:
        x, _, params, bias, _ = smoke.swin_inputs(bw, n, c, h, side, False,
                                                  torch.bfloat16, 700)
        scale = (c // h) ** -0.5

        def call():
            return swin_block(x, params, bias, nb_heads=h, scale=scale)

        for width in (128, 192, 256, None):
            measure("swin_block", f"BW={bw} C={c}", width, call, SWIN_PARTS)
        del x, params, bias
    for b, hh, ww, c, hid in smoke.POOL_STAGES:
        pargs = smoke.pool_inputs(b, hh, ww, c, hid, torch.bfloat16, 2200)

        def call():
            return poolformer_block(*pargs)

        for width in (128, 256, None):
            measure("poolformer_block", f"{b}x{hh}x{ww}x{c}", width, call,
                    POOL_PARTS)
        del pargs
    print(json.dumps({"gpu": gpu, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

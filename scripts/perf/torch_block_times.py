"""Times of swin_block and poolformer_block a Swin-T and a PoolFormer-S12
bs128 request, out of L2 and back to back.

Each stage shape of ``chip_smoke.py`` (Swin-T's stages 1-3, unshifted and
shifted, and PoolFormer-S12's four stages, bf16, its seeded inputs) is timed
with that checkout's ``chip_smoke.cold_ms`` (CUDA events around each call
after a 512 MB write, the median of 10) and ``chip_smoke.cuda_time_ms`` (20
back-to-back calls, the median of 5 runs); a request's total weighs each
shape by its blocks (``SWIN_DEPTHS``, half of them shifted;
``POOL_DEPTHS``). It reads only what every checkout since the blocks were
ported has, so that a parent and a change are timed alike in one call.

    python3 scripts/perf/torch_block_times.py [--root DIR]

``--root`` imports ``tfimm_tpu_torch`` and ``chip_smoke`` from another
checkout of the repo. Needs a CUDA card; prints one line a stage and one
JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root))
    import torch

    import chip_smoke as smoke
    from tfimm_tpu_torch.ops.kernels.poolformer_block import poolformer_block
    from tfimm_tpu_torch.ops.kernels.swin_block import swin_block

    if not torch.cuda.is_available():
        print("torch_block_times: needs a CUDA card", file=sys.stderr)
        return 1
    gpu = gpu_line()
    totals = {"swin_block": {"cold_ms": 0.0, "ms": 0.0},
              "poolformer_block": {"cold_ms": 0.0, "ms": 0.0}}
    stages = {}

    def record(block, stage, fn, weight):
        t = {"cold_ms": smoke.cold_ms(fn), "ms": smoke.cuda_time_ms(fn)}
        print(f"{block} {stage}: {t['cold_ms']!r} ms out of L2, {t['ms']!r} "
              f"ms back to back", flush=True)
        stages[f"{block} {stage}"] = t
        for key in t:
            totals[block][key] += weight * t[key]

    for (bw, n, c, h, side), depth in zip(smoke.SWIN_STAGES,
                                          smoke.SWIN_DEPTHS):
        for shifted in (False, True):
            x, _, params, bias, mask = smoke.swin_inputs(
                bw, n, c, h, side, shifted, torch.bfloat16, 700)
            scale = (c // h) ** -0.5
            record("swin_block", f"BW={bw} C={c}"
                   f"{' shifted' if shifted else ''}",
                   lambda: swin_block(x, params, bias, mask, nb_heads=h,
                                      scale=scale), depth // 2)
            del x, params, bias, mask
    for (b, hh, ww, c, hid), depth in zip(smoke.POOL_STAGES,
                                          smoke.POOL_DEPTHS):
        pargs = smoke.pool_inputs(b, hh, ww, c, hid, torch.bfloat16, 2200)
        record("poolformer_block", f"{b}x{hh}x{ww}x{c}",
               lambda: poolformer_block(*pargs), depth)
        del pargs
    for block, t in totals.items():
        print(f"{block} a request: {t['cold_ms']!r} ms out of L2, "
              f"{t['ms']!r} ms back to back; on {gpu}", flush=True)
    print(json.dumps({"gpu": gpu, "root": str(args.root), "totals": totals,
                      "stages": stages}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

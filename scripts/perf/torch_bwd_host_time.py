"""Host time of one call of the PyTorch port's attention wrappers.

For ``flash_attention_relpos_bwd`` at SAM-B's global blocks (B = 12, 64 x 64,
d = 64) and windowed blocks (B = 300, 14 x 14, d = 64), for
``flash_attention_bwd`` at ViT-B/16 512x512 bs32 ((32, 12, 1025, 64) views of
a packed qkv projection), and for CaiT-S24's talking-head attention (the
forward at bs128, the backward at bs64, handed the forward's row statistics
where the wrapper takes them, as in training), all bf16 on the card: the CPU
wall of CALLS calls in a row while a sleep kernel keeps the card busy, so
that no call can wait for the card (a call that synchronises shows up as the
sleep's length, and as a round the card caught up in), and the part of it
spent inside the kernels' C entry points (tensor maps, launch attributes,
the launches). The rest is the wrapper's Python and the PyTorch calls it
makes. Medians and ranges over REPEATS rounds, in ms a call. ``host_ms`` is
the measurement; ``chip_smoke.py`` calls it too.

    python3 scripts/perf/torch_bwd_host_time.py [--root DIR] [--calls 40]
        [--repeats 7]

``--root`` imports ``tfimm_tpu_torch`` from another checkout of the repo, so
that two commits can be compared on one card. Needs a CUDA card; prints one
JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLEEP_CYCLES = 400_000_000   # about 0.2 s at the H100's clocks


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def host_ms(fn, calls: int = 40, repeats: int = 7, inside=None) -> dict:
    """Host ms of one call of ``fn`` (CALLS calls in a row behind a sleep
    kernel, REPEATS rounds): the median and range, the rounds in which the
    card finished its sleep before the last call had been issued (then the
    figure is not the host's alone) and, given ``inside``, the same of the
    time ``inside[0]`` gathers (seconds, reset each round; the C entry
    points)."""
    import torch

    entries_timed = inside is not None
    inside = inside if entries_timed else [0.0]
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls, entries, idle = [], [], 0
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        slept = torch.cuda.Event()
        slept.record()
        inside[0] = 0.0
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall = time.perf_counter() - t0
        idle += int(slept.query())   # the card caught up with the host
        torch.cuda.synchronize()
        walls.append(wall * 1e3 / calls)
        entries.append(inside[0] * 1e3 / calls)
    result = {"host_ms": statistics.median(walls),
              "host_ms_range": [min(walls), max(walls)],
              "rounds_the_card_caught_up": idle}
    if entries_timed:
        result.update(c_entry_ms=statistics.median(entries),
                      c_entry_ms_range=[min(entries), max(entries)])
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=None)
    parser.add_argument("--calls", type=int, default=40)
    parser.add_argument("--repeats", type=int, default=7)
    opts = parser.parse_args(argv)
    root = Path(opts.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_host_time: no CUDA card", file=sys.stderr)
        return 1
    from tfimm_tpu_torch.ops.kernels import cait_attention as cait
    from tfimm_tpu_torch.ops.kernels.build import kernel_library
    from tfimm_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_with_lse,
    )
    from tfimm_tpu_torch.ops.kernels.flash_attention_relpos import (
        flash_attention_relpos_bwd,
        flash_attention_relpos_with_lse,
        scale_query,
    )

    lib = kernel_library()
    inside = [0.0]

    def timed_entry(name):
        entry = getattr(lib, name)

        def call(*args):
            t0 = time.perf_counter()
            try:
                return entry(*args)
            finally:
                inside[0] += time.perf_counter() - t0

        setattr(lib, name, call)

    for name in ("tfimm_flash_attention_relpos_bwd", "tfimm_flash_attention_bwd",
                 "tfimm_talking_head_fwd", "tfimm_talking_head_bwd"):
        timed_entry(name)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()

    def relpos_case(b, gh, gw, d):
        n = gh * gw
        q, k, v = (randn(b, n, d) for _ in range(3))
        rh, rw = randn(b, n, gh, scale=0.5), randn(b, n, gw, scale=0.5)
        out, lse = flash_attention_relpos_with_lse(
            q, k, v, rh, rw, grid_size=(gh, gw), scale=d ** -0.5)
        args = (scale_query(q, d ** -0.5), k, v, rh, rw, out, lse,
                randn(b, n, d))
        return lambda: flash_attention_relpos_bwd(*args, grid_size=(gh, gw))

    def flash_case(b, h, n, d):
        qkv = randn(b, n, 3 * h * d).reshape(b, n, 3, h, d).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        out, lse = flash_attention_with_lse(q, k, v, scale=d ** -0.5)
        args = (scale_query(q, d ** -0.5), k, v, out, lse, randn(b, h, n, d))
        return lambda: flash_attention_bwd(*args)

    def cait_case(b, n, h, d, backward):
        qkv, g = randn(b, n, 3 * h * d), randn(b, n, h * d)
        mixes = (randn(h, h, scale=0.5).float(), randn(h).float(),
                 randn(h, h, scale=0.5).float(), randn(h, scale=0.02).float())
        kw = dict(nb_heads=h, scale=d ** -0.5)
        if not backward:
            return lambda: cait.talking_head_attention(qkv, *mixes, **kw)
        if "row_stats" in inspect.signature(
                cait.talking_head_attention_bwd).parameters:
            kw["row_stats"] = cait._forward(qkv, *mixes, h, d ** -0.5, True)[1]
        return lambda: cait.talking_head_attention_bwd(qkv, *mixes, g, **kw)

    cases = {
        "relpos_bwd_global (12, 64x64, 64)": relpos_case(12, 64, 64, 64),
        "relpos_bwd_windowed (300, 14x14, 64)": relpos_case(300, 14, 14, 64),
        "flash_bwd (32, 12, 1025, 64)": flash_case(32, 12, 1025, 64),
        "cait_fwd (128, 196, 8, 48)": cait_case(128, 196, 8, 48, False),
        "cait_bwd (64, 196, 8, 48)": cait_case(64, 196, 8, 48, True),
    }
    result = {"root": str(root), "gpu": gpu_line(), "calls": opts.calls,
              "repeats": opts.repeats}
    for name, fn in cases.items():
        result[name] = host_ms(fn, opts.calls, opts.repeats, inside)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Wall time of CaiT-S24's bs64 training step on the PyTorch port.

Runs ``chip_smoke.py``'s CaiT training configuration (the DeiT recipe at
batch 64, bf16 mixed precision; ``chip_smoke.cait_train_config``) through
``tfimm_tpu_torch.train.run`` for STEPS one-step epochs, and times every
step (``chip_smoke.run_watched``: the step ends by reading its loss). Then
``chip_smoke.device_split`` profiles three more steps for the device's busy
time. Prints one JSON line: every step's ms, the median and mean of steps
3 onwards, img/s from their mean, the busy ms a step and the idle share
against the median step. With ``--host-ops N`` it then runs 10 more steps
on one batch with the talking-head wrappers timed (host ms a step inside
the forward's and the backward's wrapper) and profiles 3 steps for the N
host events of most self CPU time a step (the profiler slows the host, so
compare these between commits, not with the walls).

    python3 scripts/perf/torch_cait_train_wall.py [--root DIR] [--steps 30]
        [--host-ops 0]

``--root`` runs the ``chip_smoke.py`` and ``tfimm_tpu_torch`` of another
checkout of the repo, so that two commits can be compared on one card (run
them alternately, each in its own process). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def wrapper_host_ms(problem, batch, steps: int = 10) -> dict:
    """Host ms a step inside the talking-head wrappers (the outermost call
    of each), and the steps' wall, over ``steps`` steps on ``batch``."""
    from tfimm_tpu_torch.ops.kernels import cait_attention as cait

    inside = {"forward": 0.0, "backward": 0.0}
    depth = [0]

    def timed(fn, key):
        def call(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                inside[key] += time.perf_counter() - t0
                depth[0] -= 1
        return call

    names = [(n, key) for n, key in (("talking_head_attention", "forward"),
                                     ("_forward", "forward"),
                                     ("talking_head_attention_bwd", "backward"))
             if hasattr(cait, n)]
    saved = {n: getattr(cait, n) for n, _ in names}
    for n, key in names:
        setattr(cait, n, timed(saved[n], key))
    try:
        t0 = time.perf_counter()
        for it in range(steps):
            problem.train_step(batch, it)
        wall = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(cait, n, fn)
    return {"step_ms": wall * 1e3 / steps,
            **{f"{key}_wrapper_ms": t * 1e3 / steps
               for key, t in inside.items()}}


def host_ops(problem, batch, top: int, steps: int = 3) -> list:
    """The ``top`` host events of most self CPU time a step, from one
    profile of ``steps`` steps: [name, calls a step, self CPU ms a step]."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for it in range(steps):
            problem.train_step(batch, it)
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [[e.key[:80], e.count / steps, e.self_cpu_time_total / 1e3 / steps]
            for e in rows[:top]]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=None)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--host-ops", type=int, default=0)
    opts = parser.parse_args(argv)
    root = Path(opts.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_cait_train_wall: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from tfimm_tpu_torch.ops.kernels.build import kernel_library

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    kernel_library()
    gpu = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]).splitlines()[0]
    config = chip_smoke.cait_train_config()
    config["timekeeping"]["nb_epochs"] = opts.steps
    trainer, steps, _ = chip_smoke.run_watched(config)
    step_ms = [seconds * 1e3 for _, seconds, _ in steps]
    timed = step_ms[2:]
    batch = next(iter(trainer.train_ds))
    _, groups, _ = chip_smoke.device_split(
        lambda: trainer.problem.train_step(batch, 0))
    busy_ms = sum(groups.values())
    median = statistics.median(timed)
    extra = {}
    if opts.host_ops:
        extra["wrappers"] = wrapper_host_ms(trainer.problem, batch)
        extra["host_ops"] = host_ops(trainer.problem, batch, opts.host_ops)
    print(json.dumps({
        "root": str(root), "gpu": gpu,
        "batch": chip_smoke.CAIT_TRAIN_BATCH, "step_ms": step_ms,
        "median_ms": median, "mean_ms": statistics.mean(timed),
        "img_s": chip_smoke.CAIT_TRAIN_BATCH * 1e3 / statistics.mean(timed),
        "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / median,
        "losses": [loss for loss, _, _ in steps], **extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

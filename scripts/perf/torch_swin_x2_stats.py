"""swin_block with X2's row statistics taken in proj's epilogue, against the
same block with them taken by their own launch.

In bf16, where proj's output tiles hold whole rows (Swin-T's stages 1-2),
``csrc/swin_block.cu`` has proj's epilogue write X2's row statistics and
leaves out the row-statistics launch before fc1. The other form is built
from a copy of ``tfimm_tpu_torch/csrc`` in which that condition is false
(every shape then takes the launch, as stage 3 does), in a build directory
of its own under ``tfimm_tpu_torch/_build/``. Each form runs in its own
process, in the order epilogue, launch, launch, epilogue, on the seeded
inputs of ``chip_smoke.py``: at Swin-T's stages 1-3 at batch 128 (bf16,
unshifted and shifted), each block held against its plain version, its
time out of L2 (``chip_smoke.cold_ms``) and each launch's device time out
of L2 (``chip_smoke.cold_launch_parts``); a request's total weighs each
shape by its blocks (``SWIN_DEPTHS``, half of them shifted). Stage 3 runs
the same code in both forms, a check on the noise between processes.

    python3 scripts/perf/torch_swin_x2_stats.py

Needs a CUDA card; prints one line a (form, shape) and one JSON line at the
end.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# The condition in csrc/swin_block.cu under which proj's epilogue takes the
# statistics; the launch form replaces it by false.
EPILOGUE_CONDITION = "kWgmma && wgmma_width(maps + kGemmMapsSize) >= c;"
FORMS = ("epilogue", "launch")


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def use_launch_form(build) -> None:
    """Point ``build`` at a copy of the sources in which proj's epilogue
    never takes the statistics."""
    root = build.BUILD_DIR / "x2-stats-launch"
    csrc = root / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(build._CSRC, csrc)
    src = csrc / "swin_block.cu"
    text = src.read_text()
    if text.count(EPILOGUE_CONDITION) != 1:
        raise RuntimeError(f"{src}: the epilogue condition "
                           f"{EPILOGUE_CONDITION!r} is not there once")
    src.write_text(text.replace(EPILOGUE_CONDITION, "false;"))
    build._CSRC = csrc
    build.BUILD_DIR = root / "build"


def run_form(form: str) -> int:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as smoke
    from tfimm_tpu_torch.ops.kernels import build
    from tfimm_tpu_torch.ops.kernels.swin_block import (
        swin_block,
        swin_block_reference,
    )

    if not torch.cuda.is_available():
        print("torch_swin_x2_stats: needs a CUDA card", file=sys.stderr)
        return 1
    if form == "launch":
        use_launch_form(build)
    build.kernel_library()
    shapes, total = {}, 0.0
    for (bw, n, c, h, side), depth in zip(smoke.SWIN_STAGES,
                                          smoke.SWIN_DEPTHS):
        for shifted in (False, True):
            x, _, params, bias, mask = smoke.swin_inputs(
                bw, n, c, h, side, shifted, torch.bfloat16, 700)
            scale = (c // h) ** -0.5

            def call():
                return swin_block(x, params, bias, mask, nb_heads=h,
                                  scale=scale)

            err, bar, ok = smoke.held(call(), swin_block_reference(
                x, params, bias, mask, nb_heads=h, scale=scale),
                smoke.SWIN_TOL["swin_block"]["bfloat16"])
            if not ok:
                raise RuntimeError(f"{form} form, BW={bw} C={c}: "
                                   f"max_abs_err {err} > bar {bar}")
            cold = smoke.cold_ms(call)
            events = smoke.cold_device_events(call, 3)
            stats_launched = any("swin_row_stats_kernel<float>" in name
                                 for name, _ in events)
            parts = smoke.cold_launch_parts(
                call, "swin_block", events=events,
                skip=set() if stats_launched else {smoke.SWIN_X2_STATS})
            what = f"BW={bw} C={c}{' shifted' if shifted else ''}"
            print(f"{form} {what}: {cold!r} ms out of L2; max_abs_err "
                  f"{err!r} (bar {bar!r}); launches "
                  + ", ".join(f"{p} {ms!r}" for p, ms in parts.items()),
                  flush=True)
            shapes[what] = {"cold_ms": cold, "launch_ms": parts,
                            "stats_launched": stats_launched}
            total += depth // 2 * cold
            del x, params, bias, mask
    print(json.dumps({"form": form, "cold_ms_a_request": total,
                      "shapes": shapes}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=FORMS)
    args = ap.parse_args(argv)
    if args.form:
        return run_form(args.form)
    gpu = gpu_line()
    print(gpu, flush=True)
    runs = []
    for form in ("epilogue", "launch", "launch", "epilogue"):
        proc = subprocess.run([sys.executable, __file__, "--form", form],
                              capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for run in runs:
        # Stages 1-2: two blocks each, one unshifted and one shifted.
        stages12 = sum(t["cold_ms"] for what, t in run["shapes"].items()
                       if not what.startswith("BW=512 "))
        print(f"{run['form']}: {run['cold_ms_a_request']!r} ms a request out "
              f"of L2 (stages 1-3), stages 1-2 {stages12!r} ms; on {gpu}",
              flush=True)
    print(json.dumps({"gpu": gpu, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

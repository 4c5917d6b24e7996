"""Where the time of window_mha's TMA + wgmma body goes: the whole body
against copies with one part left out.

Each form is built from a copy of ``tfimm_tpu_torch/csrc`` in which
``window_mha.cu``'s consumer loop is cut, in a build directory of its own
under ``tfimm_tpu_torch/_build/``:

- ``full``: the body as it is (held against the plain version);
- ``loads``: each consumer releases a stage as soon as it has arrived, so
  only the producer's TMA loads run;
- ``no_softmax``: the exponentials, the row sums and p's scaling left out
  (p is the raw score);
- ``no_output``: o neither written to the warpgroup's tile nor stored.

The cut forms compute garbage; only their times mean something. Each form
runs in its own process, in the order full, loads, no_softmax, no_output,
full, on the seeded inputs of ``chip_smoke.py``, and times ``window_mha``
with its operands out of L2 (``chip_smoke.cold_ms``) at Swin-T's stage 1
(BW = 8192, C = 96, H = 3: 64-byte rows of a head) and stage 4 (BW = 128,
C = 768, H = 24) at batch 128, unshifted, and at BW = 8192, C = 128, H = 2
(d = 64: 128-byte rows).

    python3 scripts/perf/torch_window_parts.py

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
# The lines of csrc/window_mha.cu that the cut forms change (each must be
# there once): the consumer's wait for a stage, the softmax, and o's way
# out.
WAIT = "    hopper::mbar_wait(&full[st], (t / kStages) & 1);\n"
RELEASE = ("    __syncwarp();\n"
           "    if (lane == 0) hopper::mbar_arrive(&empty[st]);\n"
           "    continue;\n")
SOFTMAX = ("    wtc::softmax_tile(s, bm, a.scale_log2, row < a.n, "
           "row + 8 < a.n);\n")
WRITE = "    wtc::write_tile(out_s, o, 1.f, tid);\n"
STORE = ("    wtc::store_rows(out_s, a.out + (int64_t)r * a.n * a.c + h * a.d, "
         "a.c, a.n,\n                    a.d, tid);\n")
CUTS = {"full": [],
        "loads": [(WAIT, WAIT + RELEASE)],
        "no_softmax": [(SOFTMAX, "")],
        "no_output": [(WRITE, ""), (STORE, "")]}
ORDER = ("full", "loads", "no_softmax", "no_output", "full")
# (name, BW, C, H) at N = 49, no mask.
SHAPES = [("stage 1", 8192, 96, 3), ("stage 4", 128, 768, 24),
          ("d = 64", 8192, 128, 2)]


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def cut_sources(build, form: str) -> None:
    """Point ``build`` at a copy of the sources with ``form``'s cuts."""
    root = build.BUILD_DIR / f"window-parts-{form}"
    csrc = root / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(build._CSRC, csrc)
    src = csrc / "window_mha.cu"
    text = src.read_text()
    for old, new in CUTS[form]:
        if text.count(old) != 1:
            raise RuntimeError(f"{src}: {old!r} is not there once")
        text = text.replace(old, new)
    src.write_text(text)
    build._CSRC = csrc
    build.BUILD_DIR = root / "build"


def run_form(form: str) -> int:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as smoke
    from tfimm_tpu_torch.ops.kernels import build
    from tfimm_tpu_torch.ops.kernels.window_mha import (
        window_mha,
        window_mha_reference,
    )

    if not torch.cuda.is_available():
        print("torch_window_parts: needs a CUDA card", file=sys.stderr)
        return 1
    if form != "full":
        cut_sources(build, form)
    build.kernel_library()
    times = {}
    for name, bw, c, h in SHAPES:
        _, qkv, _, bias, _ = smoke.swin_inputs(bw, 49, c, h, 0, False,
                                               torch.bfloat16, 600)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        scale = (c // h) ** -0.5

        def call():
            return window_mha(q, k, v, bias, nb_heads=h, scale=scale)

        if form == "full":
            err, bar, ok = smoke.held(call(), window_mha_reference(
                q, k, v, bias, nb_heads=h, scale=scale),
                smoke.SWIN_TOL["window_mha"]["bfloat16"])
            if not ok:
                raise RuntimeError(f"{name}: max_abs_err {err} > bar {bar}")
        times[name] = smoke.cold_ms(call)
        print(f"{form} {name} (BW={bw} C={c} H={h}): {times[name]!r} ms out "
              f"of L2", flush=True)
        del qkv, q, k, v, bias
    print(json.dumps({"form": form, "cold_ms": times}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=tuple(CUTS))
    args = ap.parse_args(argv)
    if args.form:
        return run_form(args.form)
    gpu = gpu_line()
    print(gpu, flush=True)
    runs = []
    for form in ORDER:
        proc = subprocess.run([sys.executable, __file__, "--form", form],
                              capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"gpu": gpu, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

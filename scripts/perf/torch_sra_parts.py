"""Where the time of pvt_sra's TMA + wgmma body goes, and how its output
should leave: the body against copies with one part changed.

Each form is ``csrc/pvt_sra.cu`` (with its headers) copied and changed,
built alone by nvcc into a library of its own under
``tfimm_tpu_torch/_build/sra-parts-<form>/`` (ptxas' register and spill
report printed), whose ``tfimm_pvt_sra`` then stands in for the kernel
library's:

- ``full``: the body as it is (y's tile out by one TMA store a tile);
- ``plain_stores``: y's tile out by plain 16-byte stores of its rows below
  N, as window_mha.cu's outputs leave;
- ``loads``: each consumer releases a stage as soon as it has landed, so
  only the producer's TMA loads run;
- ``no_output``: y written to the warpgroup's tile but never stored.

``full`` and ``plain_stores`` are held against the plain version (2e-2 of
max); the cut forms compute garbage and only their times mean something.
Each form runs in its own process, in the order full, plain_stores, loads,
no_output, plain_stores, full, on ``chip_smoke.py``'s seeded inputs, and
times ``pvt_sra`` with its operands out of L2 (``chip_smoke.cold_ms``) at
pvt_v2_b2's stage 1 (B = 128, N = 3136, S = 49, C = 64) and pvt_v2_b0's
(C = 32).

    python3 scripts/perf/torch_sra_parts.py

Needs a CUDA card and nvcc; prints one line a (form, shape) and one JSON
line at the end.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
ARGS = "  int64_t tiles;        // B * tiles_per_image\n  float scale;\n};\n"
WAIT = "    hopper::mbar_wait(&full[st], (t / kStages) & 1);\n"
RELEASE = ("    __syncwarp();\n"
           "    if (lane == 0) hopper::mbar_arrive(&empty[st]);\n"
           "    continue;\n")
TMA_STORE = ("    if (tid == 0) {\n"
             "      hopper::tma_store_3d(&out_map, out_s, 0, r0, (int)img);\n"
             "      hopper::tma_store_commit();\n"
             "    }\n")
PLAIN_STORE = ("    wtc::store_rows(out_s, a.out + (img * a.n + r0) * a.c, a.c,\n"
               "                    min(wtc::kTile, a.n - r0), a.c, tid);\n")
INIT = ("  const TcArgs a = {p.bq, p.bp, p.n, p.s, p.c, tiles_per_image, tiles,\n"
        "                    p.scale};\n")
CUTS = {
    "full": [],
    "plain_stores": [
        (ARGS, "  int64_t tiles;        // B * tiles_per_image\n"
               "  float scale;\n  bf16* out;\n};\n"),
        (TMA_STORE, PLAIN_STORE),
        (INIT, "  const TcArgs a = {p.bq, p.bp, p.n, p.s, p.c, tiles_per_image, "
               "tiles,\n                    p.scale, static_cast<bf16*>(p.out)};\n"),
    ],
    "loads": [(WAIT, WAIT + RELEASE)],
    "no_output": [(TMA_STORE, "")],
}
ORDER = ("full", "plain_stores", "loads", "no_output", "plain_stores", "full")
HELD = ("full", "plain_stores")
# (name, B, N, S, C)
SHAPES = [("pvt_v2_b2 stage 1", 128, 3136, 49, 64),
          ("pvt_v2_b0 stage 1", 128, 3136, 49, 32)]


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def form_library(build, form: str):
    """``tfimm_pvt_sra`` of ``form``'s copy of pvt_sra.cu, built alone."""
    root = build.BUILD_DIR / f"sra-parts-{form}"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    for src in [build._CSRC / "pvt_sra.cu", *build._CSRC.glob("*.cuh")]:
        shutil.copy(src, root / src.name)
    src = root / "pvt_sra.cu"
    text = src.read_text()
    for old, new in CUTS[form]:
        if text.count(old) != 1:
            raise RuntimeError(f"{src}: {old!r} is not there once")
        text = text.replace(old, new)
    src.write_text(text)
    so = root / "libsra.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-shared", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-4000:])
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines[:-2]):
        if "Function properties for" in line and "pvt_sra_wgmma" in line:
            print(f"ptxas {form}: {lines[i + 2].strip()}; "
                  f"{lines[i + 1].strip()}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.tfimm_pvt_sra.argtypes = build.kernel_library().tfimm_pvt_sra.argtypes
    lib.tfimm_pvt_sra.restype = ctypes.c_int
    return lib


class _Library:
    """The kernel library with ``tfimm_pvt_sra`` replaced."""

    def __init__(self, lib, sra):
        self._lib, self.tfimm_pvt_sra = lib, sra

    def __getattr__(self, name):
        return getattr(self._lib, name)


def run_form(form: str) -> int:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as smoke
    from tfimm_tpu_torch.ops.kernels import build
    from tfimm_tpu_torch.ops.kernels.pvt_sra import pvt_sra, pvt_sra_reference

    if not torch.cuda.is_available():
        print("torch_sra_parts: needs a CUDA card", file=sys.stderr)
        return 1
    lib = build.kernel_library()
    build._lib = _Library(lib, form_library(build, form).tfimm_pvt_sra)
    times = {}
    for name, b, n, s, c in SHAPES:
        x, kv, wq, bq, wp, bp = smoke.sra_inputs(b, n, s, c, torch.bfloat16,
                                                 700)
        scale = c ** -0.5

        def call():
            return pvt_sra(x, kv, wq, bq, wp, bp, scale)

        if form in HELD:
            err, bar, ok = smoke.held(call(), pvt_sra_reference(
                x, kv[..., :c], kv[..., c:], wq, bq, wp, bp, scale),
                smoke.SRA_TOL["bfloat16"])
            if not ok:
                raise RuntimeError(f"{form} {name}: max_abs_err {err} > bar "
                                   f"{bar}")
        times[name] = smoke.cold_ms(call)
        print(f"{form} {name} (B={b} N={n} S={s} C={c}): {times[name]!r} ms "
              f"out of L2", flush=True)
        del x, kv
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

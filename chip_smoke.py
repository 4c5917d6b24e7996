#!/usr/bin/env python3
"""Smoke run of tfimm_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It needs no JAX and no network. Phases, each of
which ends the run with a non-zero exit code on failure:

1. Environment: torch/CUDA/nvcc versions, the card's name and power limit;
   build the CUDA kernels from ``tfimm_tpu_torch/csrc`` and time the build.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path and at the edges of its coverage, in bf16 (tolerance
   2e-2) and f32 with TF32 off (1e-5); kernel and plain times at the ViT-B
   shape (CUDA events, median of 50 runs after warm-up).
3. The main path: ``create_model("vit_base_patch16_224")`` in bf16 with
   seeded random weights answers 5 requests of 128 uint8 NHWC images through
   ``create_preprocessing`` and ``model.predict``. Every request must launch
   the fused_mha kernel once per block; outputs must be finite and agree
   with the same weights run in f32 through the plain attention.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MODEL = "vit_base_patch16_224"
BATCH = 128
REQUESTS = 5
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# (B, N, H, d): ViT-B/16's attention, odd H (vit_tiny), a small d, d = 80
# (vit_huge) with N below one tile.
MHA_SHAPES = [(128, 197, 12, 64), (2, 197, 3, 64), (2, 50, 4, 32),
              (2, 17, 16, 80)]


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (proc.stdout + proc.stderr).strip()


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median of ``iters`` single-launch times, CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mha_input(b, n, h, d, dtype, seed, clamp=False):
    """Seeded normal qkv (B, N, 3*H*d) on the card. With ``clamp``, query 0
    of every head points along keys 3 and 5, so that two of its scores land
    near 160, far above the softmax clamp of 80."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, n, 3, h, d, generator=g, device="cuda")
    if clamp:
        x[:, 0, 0] = 20.0 * (x[:, 3, 1] + x[:, 5, 1])
    return x.reshape(b, n, 3 * h * d).to(dtype)


def phase_kernels(report):
    import torch

    from tfimm_tpu_torch.ops.kernels.fused_mha import fused_mha, fused_mha_reference

    cases = [(shape, False) for shape in MHA_SHAPES]
    cases.append(((2, 197, 12, 64), True))
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for i, ((b, n, h, d), clamp) in enumerate(cases):
            qkv = mha_input(b, n, h, d, dtype, seed=i, clamp=clamp)
            scale = d ** -0.5
            out = fused_mha(qkv, h, scale)
            ref = fused_mha_reference(qkv, h, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            finite = bool(torch.isfinite(out).all())
            print(f"fused_mha {str(dtype):15s} B={b} N={n} H={h} d={d}"
                  f"{' clamp' if clamp else ''}: max_abs_err={err!r} "
                  f"tol={tol} {'ok' if ok and finite else 'FAIL'}", flush=True)
            check(ok and finite, f"fused_mha disagrees with its plain version "
                  f"({dtype}, {(b, n, h, d)}, clamp={clamp}): {err}")
            if dtype == torch.bfloat16 and (b, n, h, d) == MHA_SHAPES[0]:
                report["max_abs_err"] = err
                report["ms"] = cuda_time_ms(lambda: fused_mha(qkv, h, scale))
                report["plain_ms"] = cuda_time_ms(
                    lambda: fused_mha_reference(qkv, h, scale))
                print(f"fused_mha bf16 {MHA_SHAPES[0]}: kernel "
                      f"{report['ms']!r} ms, plain {report['plain_ms']!r} ms",
                      flush=True)


def seeded_state_dict(model, seed: int):
    """Every parameter drawn from a seeded normal, in f32 on the CPU: the
    norm weights around 1, the rest with std 0.02. The heads, which start at
    zero, then give non-zero logits."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        r = torch.randn(p.shape, generator=g)
        is_norm_weight = name.endswith("weight") and "norm" in name
        sd[name] = 1.0 + 0.1 * r if is_norm_weight else 0.02 * r
    return sd


def phase_slice(report, gpu_line):
    import torch

    import tfimm_tpu_torch as tfm
    from tfimm_tpu_torch.ops.kernels import dispatch

    model = tfm.create_model(MODEL, device="cuda", dtype=torch.bfloat16, seed=0)
    sd = seeded_state_dict(model, seed=0)
    model.load_state_dict(sd)
    pp = tfm.create_preprocessing(MODEL, dtype=torch.bfloat16, device="cuda")
    nb_blocks = model.cfg.nb_blocks
    g = torch.Generator(device="cuda").manual_seed(1)
    requests = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    seconds, outputs = [], []
    for img in requests:
        before = dispatch.launch_counts["fused_mha"]
        t0 = time.perf_counter()
        logits = model.predict(pp(img))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rose = dispatch.launch_counts["fused_mha"] - before
        check(rose == nb_blocks,
              f"fused_mha launched {rose} times in one request, expected {nb_blocks}")
        check(tuple(logits.shape) == (BATCH, model.cfg.nb_classes),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        check(bool(logits.abs().max() > 0), "all-zero logits")
        outputs.append(logits)
    report["launches"] = dispatch.launch_counts["fused_mha"]
    check(report["launches"] == REQUESTS * nb_blocks,
          f"fused_mha launches {report['launches']} != {REQUESTS * nb_blocks}")
    img_s = [BATCH / s for s in seconds[1:]]
    print(f"slice {MODEL} bs{BATCH} bf16: request seconds {seconds!r}", flush=True)
    print(f"slice {MODEL} bs{BATCH} bf16: {statistics.median(img_s)!r} img/s "
          f"(median of requests 2-{REQUESTS}) on {gpu_line}", flush=True)

    # The same weights in f32 through the plain attention: capturing the
    # attention weights makes every block decline the fused kernel.
    x = requests[0]
    with torch.inference_mode():
        feats = model.forward(pp(x), features_only=True)
    model32 = tfm.create_model(MODEL, device="cuda", dtype=torch.float32, seed=0)
    model32.load_state_dict(sd)
    pp32 = tfm.create_preprocessing(MODEL, dtype=torch.float32, device="cuda")
    before = dispatch.launch_counts["fused_mha"]
    with torch.inference_mode():
        ref_logits, ref_feats = model32(pp32(x), return_features=True)
    check(dispatch.launch_counts["fused_mha"] == before,
          "the f32 reference went through the kernel")
    for name, got, want in (("forward_features", feats, ref_feats["features"]),
                            ("logits", outputs[0], ref_logits)):
        rel = ((got.float() - want).abs().max() / want.abs().max()).item()
        print(f"slice {name}: bf16 kernel path vs f32 plain path rel err "
              f"{rel!r} (bar 5e-2)", flush=True)
        check(rel < 5e-2, f"{name} rel err {rel} >= 5e-2")


def main() -> int:
    if not (REPO / "tfimm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(tfimm_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    from tfimm_tpu_torch.ops.kernels import build

    try:
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda}", flush=True)
        print(run([build.find_nvcc(), "--version"]).splitlines()[-1], flush=True)
        gpu_line = run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).splitlines()[0]
        print(gpu_line, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
        t0 = time.perf_counter()
        build.kernel_library(verbose=True)
        print(f"kernel build {time.perf_counter() - t0!r} s", flush=True)

        report = {"name": "fused_mha", "route": "cuda",
                  "source": "tfimm_tpu_torch/csrc/fused_mha.cu",
                  "replaces": "tfimm_tpu/ops/pallas/fused_mha.py:136"}
        phase_kernels(report)
        phase_slice(report, gpu_line)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernel = {k: report[k] for k in ("name", "route", "source", "replaces",
                                     "launches", "max_abs_err", "ms", "plain_ms")}
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

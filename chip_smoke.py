#!/usr/bin/env python3
"""Smoke run of tfimm_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It needs no JAX and no network. Phases, each of
which ends the run with a non-zero exit code on failure:

1. Environment: torch/CUDA/nvcc versions, the card's name and power limit;
   build the CUDA kernels from ``tfimm_tpu_torch/csrc`` and time the build.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path and at the edges of its coverage, in bf16 and in f32
   with TF32 off: ``fused_mha`` within 2e-2 (bf16) and 1e-5 (f32),
   ``fused_mha_bwd`` within 2e-2 and 1e-4 of the largest plain value.
   Kernel and plain times at the ViT-B shapes (CUDA events, median of 50
   runs after warm-up).
3. The serving path: ``create_model("vit_base_patch16_224")`` in bf16 with
   seeded random weights answers 5 requests of 128 uint8 NHWC images through
   ``create_preprocessing`` and ``model.predict``. Every request must launch
   the fused_mha kernel once per block; outputs must be finite and agree
   with the same weights run in f32 through the plain attention.
4. The training path: ``tfimm_tpu_torch.train.run`` trains ViT-B/16 at batch
   64 in bf16 mixed precision with AdamW for 6 steps on one fixed synthetic
   batch. Every step must launch fused_mha and its backward once per block,
   every loss must be finite and the last below the first. With seeded
   weights, one step's loss and gradients through the bf16 kernels must
   agree with the same weights in f32 through the plain attention. Then the
   step time, a ``torch.profiler`` split of the step's device time, and
   ``time_model(..., target="backprop", batch_size=64)``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
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
# The backward's bar is relative to the largest plain value: in bf16 the
# kernel rounds p and ds to bf16 before their products; in f32 it sums in
# another order.
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# (B, N, H, d): ViT-B/16's attention, odd H (vit_tiny), a small d, d = 80
# (vit_huge) with N below one tile.
EDGE_SHAPES = [(2, 197, 3, 64), (2, 50, 4, 32), (2, 17, 16, 80)]
MHA_SHAPES = [(128, 197, 12, 64), *EDGE_SHAPES]
TRAIN_BATCH = 64
TRAIN_STEPS = 6
BWD_SHAPES = [(TRAIN_BATCH, 197, 12, 64), *EDGE_SHAPES]
CLAMP_SHAPE = (2, 197, 12, 64)
# Device-time groups of a training step, by kernel name (first match).
KERNEL_GROUPS = [("fused_mha_bwd", ("fused_mha_bwd",)),
                 ("fused_mha fwd", ("fused_mha_fwd",)),
                 ("GEMMs (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet", "splitk")),
                 ("optimizer (foreach)", ("multi_tensor_apply",)),
                 ("memcpy/memset", ("memcpy", "memset"))]
OTHER_KERNELS = "elementwise, LayerNorm, reductions"


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
    cases.append((CLAMP_SHAPE, True))
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


def unmasked_bwd(qkv, g, nb_heads, scale):
    """The plain backward in f32 with the clamp mask left out: dqkv
    (B, N, 3*H*d) in the packed layout, as f32."""
    import torch

    b, n, three_d = qkv.shape
    d = three_d // 3 // nb_heads
    q, k, v = qkv.float().reshape(b, n, 3, nb_heads, d).permute(2, 0, 3, 1, 4)
    g = g.float().reshape(b, n, nb_heads, d).transpose(1, 2)
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    e = torch.exp(torch.clamp(s, max=80.0))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = scale * torch.matmul(ds, k)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q)
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(
        b, n, three_d)


def phase_backward_kernel(report):
    import torch

    from tfimm_tpu_torch.ops.kernels.fused_mha import (
        fused_mha_bwd,
        fused_mha_bwd_reference,
    )

    cases = [(shape, False) for shape in BWD_SHAPES]
    cases.append((CLAMP_SHAPE, True))
    for dtype in (torch.bfloat16, torch.float32):
        tol = BWD_TOL[str(dtype).split(".")[1]]
        for i, ((b, n, h, d), clamp) in enumerate(cases):
            qkv = mha_input(b, n, h, d, dtype, seed=100 + i, clamp=clamp)
            gen = torch.Generator(device="cuda").manual_seed(200 + i)
            g = torch.randn(b, n, h * d, generator=gen, device="cuda").to(dtype)
            scale = d ** -0.5
            got = fused_mha_bwd(qkv, g, h, scale).float()
            ref = fused_mha_bwd_reference(qkv, g, h, scale).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            bar = tol * ref.abs().max().item()
            ok = err <= bar and bool(torch.isfinite(got).all())
            note = ""
            if clamp:
                # Two of query 0's scores sit far above the clamp, where the
                # mask zeroes the score cotangent. Without the mask the
                # gradient would be another one: it must fail the same bar.
                far = (got - unmasked_bwd(qkv, g, h, scale)).abs().max().item()
                ok = ok and far > bar
                note = f" clamp (unmasked backward off by {far!r})"
            print(f"fused_mha_bwd {str(dtype):15s} B={b} N={n} H={h} d={d}"
                  f"{note}: max_abs_err={err!r} bar={bar!r} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"fused_mha_bwd disagrees with its plain version "
                  f"({dtype}, {(b, n, h, d)}, clamp={clamp}): {err} > {bar}")
            if dtype == torch.bfloat16 and (b, n, h, d) == BWD_SHAPES[0]:
                report["max_abs_err"] = err
                report["ms"] = cuda_time_ms(lambda: fused_mha_bwd(qkv, g, h, scale))
                report["plain_ms"] = cuda_time_ms(
                    lambda: fused_mha_bwd_reference(qkv, g, h, scale))
                print(f"fused_mha_bwd bf16 {BWD_SHAPES[0]}: kernel "
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


def phase_slice(reports, gpu_line):
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
    launches = dispatch.launch_counts["fused_mha"]
    bwd_launches = dispatch.launch_counts["fused_mha_bwd"]
    reports["fused_mha"]["launches_by_path"] = {"serve": launches}
    reports["fused_mha_bwd"]["launches_by_path"] = {"serve": bwd_launches}
    check(launches == REQUESTS * nb_blocks,
          f"fused_mha launches {launches} != {REQUESTS * nb_blocks}")
    check(bwd_launches == 0,
          f"serving launched fused_mha_bwd {bwd_launches} times")
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


def train_config() -> dict:
    """ViT-B/16 at batch 64, bf16 mixed precision, AdamW at lr 1e-4, 6
    epochs of one step each on the same 64 synthetic images."""
    data = {"batch_size": TRAIN_BATCH, "nb_samples": TRAIN_BATCH,
            "input_size": (224, 224), "nb_classes": 1000, "seed": 0}
    return {
        "trainer_class": "Trainer",
        "trainer": {"validation_before_training": False,
                    "display_loss_every_it": 1},
        "problem_class": "ClassificationProblem",
        "problem": {"model_class": "ModelFactory",
                    "model": {"model_name": MODEL},
                    "optimizer_class": "OptimizerFactory",
                    "optimizer": {"optimizer": "adamw",
                                  "lr_schedule_class": "LRConstFactory",
                                  "lr_schedule": {"lr": 1e-4}},
                    "mixed_precision": True},
        "train_dataset_class": "SyntheticDataset", "train_dataset": data,
        "timekeeping_class": "Timekeeping",
        "timekeeping": {"nb_epochs": TRAIN_STEPS, "batch_size": TRAIN_BATCH,
                        "nb_samples_per_epoch": TRAIN_BATCH},
        "device": "cuda",
    }


def device_split(fn, steps: int = 3):
    """``torch.profiler`` over ``steps`` calls of ``fn``: the wall time of a
    call under the profiler and its device time by kernel group (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), OTHER_KERNELS)
        groups[group] = groups.get(group, 0.0) + evt.time_range.elapsed_us() / 1e3
    return wall_ms / steps, {g: ms / steps for g, ms in groups.items()}


def phase_train(reports, gpu_line):
    import torch

    import tfimm_tpu_torch.train as ttrain
    from tfimm_tpu_torch.ops.kernels import dispatch
    from tfimm_tpu_torch.parallel.step import cross_entropy_loss
    from tfimm_tpu_torch.utils.profile import time_model

    # Watch every step the trainer takes: its loss, its wall time (the step
    # ends by reading the loss, which synchronises) and its kernel launches.
    steps = []
    problem_cls = ttrain.ClassificationProblem
    train_step = problem_cls.train_step

    def watched_step(self, data, it):
        before = dict(dispatch.launch_counts)
        t0 = time.perf_counter()
        out = train_step(self, data, it)
        steps.append((out[0], time.perf_counter() - t0,
                      {k: dispatch.launch_counts[k] - before[k] for k in before}))
        return out

    problem_cls.train_step = watched_step
    try:
        dispatch.reset_launch_counts()
        trainer = ttrain.run(train_config(), parse_cmdline_args=False)
        counts = dict(dispatch.launch_counts)
    finally:
        problem_cls.train_step = train_step
    problem = trainer.problem
    nb_blocks = problem.model.cfg.nb_blocks
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} training steps, "
          f"expected {TRAIN_STEPS}")
    for it, (loss, seconds, rose) in enumerate(steps):
        print(f"train step {it}: loss {loss!r}, {seconds!r} s, launches {rose}",
              flush=True)
        check(rose == {"fused_mha": nb_blocks, "fused_mha_bwd": nb_blocks},
              f"step {it} launched {rose}, expected {nb_blocks} of each kernel")
        check(math.isfinite(loss), f"step {it}: loss {loss}")
    check(steps[-1][0] < steps[0][0],
          f"the loss did not fall: {steps[0][0]} -> {steps[-1][0]}")
    for name, report in reports.items():
        report["launches_by_path"]["train"] = counts[name]
    # The rate is all the images of steps 2-N over all their time, so that a
    # stall in any step counts; the median step is kept beside it.
    timed = [s for _, s, _ in steps[1:]]
    step_s = sum(timed) / len(timed)
    print(f"train {MODEL} bs{TRAIN_BATCH} bf16 mixed precision adamw: "
          f"{TRAIN_BATCH * len(timed) / sum(timed)!r} img/s ({len(timed)} steps "
          f"2-{TRAIN_STEPS} in {sum(timed) * 1e3!r} ms; median step "
          f"{statistics.median(timed) * 1e3!r} ms, slowest "
          f"{max(timed) * 1e3!r} ms) on {gpu_line}", flush=True)

    # One step's loss and gradients with seeded weights: bf16 through the
    # kernels against f32 through the plain attention (capturing the
    # attention weights makes every block decline the kernels).
    model, pp = problem.model, problem.preprocessing
    model.load_state_dict(seeded_state_dict(model, seed=1))
    model.train()
    images, labels = next(iter(trainer.train_ds))
    images = torch.as_tensor(images, device="cuda")
    labels = torch.as_tensor(labels, device="cuda")
    names = ("blocks.0.attn.qkv.weight", "head.weight")

    def loss_and_grads(x, return_features):
        model.zero_grad(set_to_none=True)
        before = dict(dispatch.launch_counts)
        out = model(x, return_features=return_features)
        logits = out[0] if return_features else out
        loss = cross_entropy_loss(logits.float(), labels)
        loss.backward()
        rose = {k: dispatch.launch_counts[k] - before[k] for k in before}
        params = dict(model.named_parameters())
        return loss.item(), {n: params[n].grad.float() for n in names}, rose

    loss_k, grads_k, rose = loss_and_grads(pp(images).to(torch.bfloat16), False)
    check(rose == {"fused_mha": nb_blocks, "fused_mha_bwd": nb_blocks},
          f"the bf16 step launched {rose}")
    loss_r, grads_r, rose = loss_and_grads(pp(images), True)
    check(rose == {"fused_mha": 0, "fused_mha_bwd": 0},
          f"the f32 reference went through the kernels: {rose}")
    rel = abs(loss_k - loss_r) / abs(loss_r)
    print(f"train loss: bf16 kernel path {loss_k!r} vs f32 plain path "
          f"{loss_r!r}, rel err {rel!r} (bar 2e-2)", flush=True)
    check(rel < 2e-2, f"loss rel err {rel} >= 2e-2")
    for name in names:
        ref = grads_r[name]
        rel = ((grads_k[name] - ref).abs().max() / ref.abs().max()).item()
        print(f"train grad {name}: max|diff| / max|ref| {rel!r} (bar 1e-1)",
              flush=True)
        check(rel < 1e-1, f"{name} gradient rel err {rel} >= 1e-1")
        check(ref.abs().max().item() > 0, f"{name}: zero reference gradient")

    batch = (images.cpu().numpy(), labels.cpu().numpy())
    wall_ms, groups = device_split(lambda: problem.train_step(batch, 0))
    busy_ms = sum(groups.values())
    # The profiler slows the host down, so the idle share is taken against
    # the mean step time of steps 2-N measured without it.
    print(f"train step profile: device busy {busy_ms!r} ms per step; wall "
          f"{wall_ms!r} ms under the profiler, {step_s * 1e3!r} ms without; "
          f"device idle share {1.0 - busy_ms / (step_s * 1e3)!r}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"train step profile: {group}: {ms!r} ms per step", flush=True)

    img_s = time_model(MODEL, target="backprop", batch_size=TRAIN_BATCH,
                       samples=3)
    print(f"time_model {MODEL} backprop bs{TRAIN_BATCH} bf16: {img_s!r} img/s "
          f"on {gpu_line}", flush=True)


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

        reports = {
            "fused_mha": {"name": "fused_mha", "route": "cuda",
                          "source": "tfimm_tpu_torch/csrc/fused_mha.cu",
                          "replaces": "tfimm_tpu/ops/pallas/fused_mha.py:136"},
            "fused_mha_bwd": {"name": "fused_mha_bwd", "route": "cuda",
                              "source": "tfimm_tpu_torch/csrc/fused_mha_bwd.cu",
                              "replaces": "tfimm_tpu/ops/pallas/fused_mha.py:267"},
        }
        phase_kernels(reports["fused_mha"])
        phase_backward_kernel(reports["fused_mha_bwd"])
        phase_slice(reports, gpu_line)
        phase_train(reports, gpu_line)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for report in reports.values():
        report["launches"] = sum(report["launches_by_path"].values())
        kernels.append({k: report[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

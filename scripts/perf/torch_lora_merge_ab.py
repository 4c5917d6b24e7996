"""A/B of LoRA's Dense merge on the card, in one process.

``layers.merge_kernel`` merges a Dense weight in one ``addmm``; the other
form is three ops (B @ A, times the scaling, plus W). In turns (base,
three ops, addmm, addmm, three ops, base): the img/s of 7 LoRA-ConvNeXt-B
bs128 bf16 requests (median of requests 2-8; ``chip_smoke.lora_state_dict``'s
weights) through ``convnext_mlp`` and through ``convnext_block``, the
device busy time and wall of one request under the profiler, and the
median of LoRA fine-tuning steps 2-5 (f32 parameters, a bs64 batch in bf16,
AdamW through ``lora_optimizer``); the base ConvNeXt-B's img/s for scale.

    python3 scripts/perf/torch_lora_merge_ab.py

Run from the root of a checkout on a machine with a CUDA card.
"""
import functools
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
import tfimm_tpu_torch as tfm  # noqa: E402
from tfimm_tpu_torch.architectures import lora  # noqa: E402
from tfimm_tpu_torch.architectures.lora import layers  # noqa: E402
from tfimm_tpu_torch.ops.kernels import build  # noqa: E402

RANK, ALPHA = 4, 4.0
REQUESTS = 8
TRAIN_BATCH = 64
TRAIN_STEPS = 5


def three_op(weight, lora_a, lora_b, scaling):
    """The merge as three ops on a Dense weight; a conv's as before."""
    if weight.dim() != 2:
        return ADDMM(weight, lora_a, lora_b, scaling)
    return weight + scaling * (lora_b @ lora_a).to(weight.dtype)


ADDMM = layers.merge_kernel


def serve(model, pp, requests, switch):
    """img/s, median of requests 2-8, with TFIMM_TPU_FUSED_CONVNEXT=switch."""
    os.environ["TFIMM_TPU_FUSED_CONVNEXT"] = switch
    seconds = []
    for img in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict(pp(img))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return statistics.median(img.shape[0] / s for s in seconds[1:])


def fine_tuning_ms(model, opt, batch, labels, drop):
    """ms a step, median of steps 2-5."""
    seconds = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(
            model(batch, generator=drop).float(), labels)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return statistics.median(seconds[1:]) * 1e3


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.kernel_library()
    kw = dict(lora_rank=RANK, lora_alpha=ALPHA)
    model = lora.create_model("convnext_base", device="cuda",
                              dtype=torch.bfloat16, seed=0, **kw)
    sd = cs.lora_state_dict(model, 45)
    model.load_state_dict(sd)
    base = tfm.create_model("convnext_base", device="cuda",
                            dtype=torch.bfloat16, seed=0)
    base.load_state_dict({k: v for k, v in sd.items() if "lora" not in k})
    pp = tfm.create_preprocessing("convnext_base", dtype=torch.bfloat16,
                                  device="cuda")
    g = torch.Generator(device="cuda").manual_seed(45)
    requests = [torch.randint(0, 256, (128, 224, 224, 3), generator=g,
                              device="cuda", dtype=torch.uint8)
                for _ in range(REQUESTS)]
    train = lora.create_model("convnext_base", device="cuda",
                              dtype=torch.float32, seed=0, **kw)
    train.load_state_dict(sd)
    train.train()
    opt = lora.lora_optimizer(
        functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=0.05),
        train, trainable_layers=[train.cfg.classifier])
    batch = pp(requests[0][:TRAIN_BATCH])
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=g,
                           device="cuda")
    drop = torch.Generator(device="cuda").manual_seed(47)
    gpu = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0]
    for name, merge in (("base", None), ("3op", three_op), ("addmm", ADDMM),
                        ("addmm", ADDMM), ("3op", three_op), ("base", None)):
        if merge is None:
            print(f"AB base convnext_mlp {serve(base, pp, requests, '0')!r} "
                  f"img/s, convnext_block {serve(base, pp, requests, '1')!r} "
                  f"img/s on {gpu}", flush=True)
            continue
        layers.merge_kernel = merge
        mlp = serve(model, pp, requests, "0")
        blk = serve(model, pp, requests, "1")
        os.environ["TFIMM_TPU_FUSED_CONVNEXT"] = "0"
        wall, groups, _ = cs.device_split(
            lambda: model.predict(pp(requests[1])), steps=2)
        step = fine_tuning_ms(train, opt, batch, labels, drop)
        print(f"AB {name}: convnext_mlp {mlp!r} img/s, convnext_block "
              f"{blk!r} img/s; mlp request busy {sum(groups.values())!r} ms "
              f"of wall {wall!r} ms under the profiler; fine-tuning step "
              f"{step!r} ms (median of steps 2-5) on {gpu}", flush=True)


if __name__ == "__main__":
    main()

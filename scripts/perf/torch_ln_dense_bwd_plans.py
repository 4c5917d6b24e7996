"""ln_dense's backward on its TMA + wgmma body under the dW plans that
``tma.ln_dense_bwd_dw_costs`` ranks first to fourth: does the cost model's
choice (the first) hold on the card?

At ViT-B/16's two bs64 shapes, (M, C, O) = (12608, 768, 2304) and
(12608, 768, 3072), each plan (dW's tile width, slices of M, rows a slice)
is put in the place of ``tma.ln_dense_bwd_plan``'s dW part, its five
outputs are held against ``ln_dense_bwd_reference`` at ``chip_smoke.py``'s
bars, and the backward is timed with its operands out of L2
(``chip_smoke.cold_ms``), in the order first, second, third, fourth,
fourth, third, second, first, so that each plan has two readings in one
process.

    python3 scripts/perf/torch_ln_dense_bwd_plans.py

Needs a CUDA card and nvcc; prints the card, one line a reading and one
JSON line at the end.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PLANS = 4


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as smoke
    import tfimm_tpu_torch.ops.kernels.ln_dense
    from tfimm_tpu_torch.ops.kernels import tma

    # The package exports the function ln_dense under the module's name.
    ln_mod = sys.modules["tfimm_tpu_torch.ops.kernels.ln_dense"]

    if not torch.cuda.is_available():
        print("torch_ln_dense_bwd_plans: needs a CUDA card", file=sys.stderr)
        return 1
    gpu = gpu_line()
    print(gpu, flush=True)
    sms = tma.sm_count(0)
    chosen = tma.ln_dense_bwd_plan

    def use(plan):
        tma.ln_dense_bwd_plan = ln_mod.ln_dense_bwd_plan = (
            lambda m, c, o, s: plan)
        tma.packed_ln_dense_bwd_maps.cache_clear()

    results = []
    try:
        for i, (m, c, o) in enumerate(smoke.LN_DENSE_TRAIN):
            x, gamma, beta, w, _, gy = smoke.ln_dense_inputs(
                m, c, o, torch.bfloat16, 3150 + i)
            want = ln_mod.ln_dense_bwd_reference(x, gamma, beta, w, gy, True,
                                                 smoke.LN_DENSE_EPS)
            base = chosen(m, c, o, sms)
            plans = []
            for cost, width, splits, per_split in tma.ln_dense_bwd_dw_costs(
                    m, c, o, sms)[:PLANS]:
                tiles = -(-o // tma.GEMM_ROWS) * -(-c // width) * splits
                plans.append((cost, base._replace(
                    dw_width=width, dw_blocks=min(tiles, sms), splits=splits,
                    per_split=per_split)))
            assert plans[0][1] == base, (plans[0], base)

            def call():
                return ln_mod.ln_dense_bwd(x, gamma, beta, w, gy, True,
                                           smoke.LN_DENSE_EPS)

            times = {k: [] for k in range(len(plans))}
            for k in [*range(len(plans)), *reversed(range(len(plans)))]:
                cost, plan = plans[k]
                use(plan)
                got = call()
                for j, (a, r) in enumerate(zip(got, want)):
                    tol = (smoke.LN_DENSE_TOL if j == 0
                           else smoke.LN_DENSE_SUM_TOL)["bfloat16"]
                    err, bar, ok = smoke.held(a, r, tol)
                    if not ok:
                        raise RuntimeError(f"{(m, c, o)} {plan}: output {j} "
                                           f"{err} > {bar}")
                ms = smoke.cold_ms(call)
                times[k].append(ms)
                print(f"(M, C, O) = ({m}, {c}, {o}) plan {k + 1} (model cost "
                      f"{cost!r}; dW width {plan.dw_width}, {plan.splits} "
                      f"slices of {plan.per_split} rows, {plan.dw_blocks} "
                      f"blocks): {ms!r} ms out of L2", flush=True)
            results.append({"shape": [m, c, o], "plans": [
                {"rank": k + 1, "cost": cost, "dw_width": plan.dw_width,
                 "splits": plan.splits, "per_split": plan.per_split,
                 "dw_blocks": plan.dw_blocks, "cold_ms": times[k]}
                for k, (cost, plan) in enumerate(plans)]})
            del x, gamma, beta, w, gy, want
    finally:
        tma.ln_dense_bwd_plan = ln_mod.ln_dense_bwd_plan = chosen
        tma.packed_ln_dense_bwd_maps.cache_clear()
    print(json.dumps({"gpu": gpu, "sms": sms, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

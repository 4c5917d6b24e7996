"""Which shapes and layouts ``torch._int_mm`` takes on the card.

    python3 scripts/perf/torch_int_mm_limits.py

Calls ``torch._int_mm(a, b)`` with int8 ``a`` (M, K) and ``b`` (K, N),
``b`` either the transpose of a contiguous (N, K) matrix (the layout
``tfimm_tpu_torch.quant.int_mm`` hands it) or contiguous, at a few shapes
around the limits, and prints one JSON line: each case, whether it ran and
equalled the int64 product, or the first line of its error. Needs a CUDA
card; the card's name and power limit are printed first.
"""

import json
import subprocess
import sys

import torch

CASES = [(17, 8, 8), (16, 8, 8), (1, 8, 8), (32, 12, 8), (32, 8, 12),
         (32, 100, 36), (25216, 768, 2304), (17, 768, 2304)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_int_mm_limits: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator().manual_seed(0)
    out = []
    for m, k, n in CASES:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        want = (a.long() @ w.long().t()).int()
        for layout, b in (("transposed", w.cuda().t()),
                          ("contiguous", w.t().contiguous().cuda())):
            try:
                got = torch._int_mm(a.cuda(), b).cpu()
                result = "equal" if torch.equal(got, want) else "differs"
            except RuntimeError as e:
                result = "refused: " + str(e).strip().splitlines()[0][:160]
            out.append({"m": m, "k": k, "n": n, "b": layout,
                        "result": result})
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

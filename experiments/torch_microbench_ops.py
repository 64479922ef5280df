"""Per-op cost of the recurrence's primitive patterns on one CUDA GPU (E1).

    python experiments/torch_microbench_ops.py [--reps N]

The port's counterpart of experiments/microbench_ops.py: for each of
int32, int16, float32 and bfloat16 and each pattern (addmax, select,
roll_lane, roll_sub), the E1 kernel (swtpu_torch/ops/csrc/microbench.cu)
runs 2,000 and 20,000 steps of 8 dependent ops on a [512, 128] array; the
difference of the two device times (CUDA events, the mean of --reps
calls after a warm-up) over 18,000 x 8 ops is one op's cost, so fixed launch
costs cancel.  Prints ns/op and Telem/s (elements of the array updated per
second) per case, each line with the card's name and power limit.  The
kernel keeps the array in registers on one SM (16-bit types) or a cluster
of two (32-bit types); see the source's head note for the layout.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

LO, HI = 2000, 20000  # steps (microbench_ops.py:68)


def inputs(dtype_name: str):
    """The reference's input on the card: a [512, 128] array of 0-4 from
    seed 0 in the named dtype."""
    import numpy as np
    import torch
    from swtpu_torch.ops.microbench import DTYPES, SHAPE

    x0 = np.random.default_rng(0).integers(0, 5, SHAPE).astype(np.float32)
    return torch.from_numpy(x0).to(DTYPES[dtype_name]).cuda()


def run(card: str, reps: int = 3, lo: int = LO, hi: int = HI):
    """Time all 16 (dtype, pattern) cases; prints one line each and returns
    [{dtype, pattern, lo_ms, hi_ms, ns_per_op, telem_per_s}]."""
    from swtpu_torch.ops.microbench import DTYPES, OPS_PER_STEP, PATTERNS, SHAPE, microbench_ops
    from swtpu_torch.utils.timing import cuda_ms

    rows = []
    for name in DTYPES:
        x = inputs(name)
        for pattern in PATTERNS:
            t_lo = cuda_ms(lambda: microbench_ops(x, pattern, lo), reps)
            t_hi = cuda_ms(lambda: microbench_ops(x, pattern, hi), reps)
            per_op = (t_hi - t_lo) * 1e-3 / ((hi - lo) * OPS_PER_STEP)
            elems = SHAPE[0] * SHAPE[1]
            row = dict(dtype=name, pattern=pattern, lo_ms=t_lo, hi_ms=t_hi,
                       ns_per_op=per_op * 1e9, telem_per_s=elems / per_op / 1e12)
            print(f"E1 {name:9s} {pattern:10s}: {row['ns_per_op']:8.2f} ns/op -> "
                  f"{row['telem_per_s']:6.3f} Telem/s ({lo} steps {t_lo:.3f} ms, {hi} "
                  f"steps {t_hi:.3f} ms) | {card}", flush=True)
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    from experiments.torch_shootout import card_line

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 1
    card = card_line()
    print(card, flush=True)
    run(card, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

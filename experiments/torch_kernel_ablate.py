"""Where the cycles of the wavefront step go on one CUDA GPU (E2).

    python experiments/torch_kernel_ablate.py [S] [dtype] [--reps N]

The port's counterpart of experiments/kernel_ablate.py: the E2 kernel
(swtpu_torch/ops/csrc/microbench.cu) runs B2's step on S streams (default
512) with the state in `dtype` (int32, int16, float32 or bfloat16;
default int32) in five variants, minimal, arith, norolls, nosel and full
(only full is a correct score), at 64 and 512 chunks of 32 steps; the
difference of the two device times (CUDA events, the mean of --reps calls
after a warm-up; default 20, since the shorter run of minimal and norolls
takes ~40 us, of the order of the launches' jitter) over the steps between
them is one step's cost.  Prints ns/step and Gcell/s (128 x S cells a
step) per variant, each line with the card's name and power limit.  Inputs
follow the reference: codes 0-3 from seed 0, no read starts.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CHUNKS = (64, 512)  # kernel_ablate.py:159
ORDER = ("minimal", "arith", "norolls", "nosel", "full")  # kernel_ablate.py:160


def inputs(S: int, T: int):
    """The reference's inputs on the card: qT [128, S] and a stream [T, S]
    of codes 0-3 from seed 0."""
    import numpy as np
    import torch
    from swtpu_torch.ops.microbench import LANES

    rng = np.random.default_rng(0)
    qT = rng.integers(0, 4, (LANES, S)).astype(np.int8)
    stream = rng.integers(0, 4, (T, S)).astype(np.int8)
    return torch.from_numpy(qT).cuda(), torch.from_numpy(stream).cuda()


def run(card: str, S: int = 512, dtype_name: str = "int32", reps: int = 20):
    """Time the five variants; prints one line each and returns
    [{dtype, variant, S, lo_ms, hi_ms, ns_per_step, gcell_per_s}]."""
    from swtpu_torch.ops.microbench import DTYPES, LANES, STEP_CHUNK, stream_ablate
    from swtpu_torch.utils.timing import cuda_ms

    dtype = DTYPES[dtype_name]
    T_lo, T_hi = (c * STEP_CHUNK for c in CHUNKS)
    small, big = inputs(S, T_lo), inputs(S, T_hi)
    rows = []
    for variant in ORDER:
        t_lo = cuda_ms(lambda: stream_ablate(*small, variant, dtype), reps)
        t_hi = cuda_ms(lambda: stream_ablate(*big, variant, dtype), reps)
        per_step = (t_hi - t_lo) * 1e-3 / (T_hi - T_lo)
        row = dict(dtype=dtype_name, variant=variant, S=S, lo_ms=t_lo, hi_ms=t_hi,
                   ns_per_step=per_step * 1e9, gcell_per_s=LANES * S / per_step / 1e9)
        print(f"E2 {dtype_name} {variant:8s}: {row['ns_per_step']:8.2f} ns/step -> "
              f"{row['gcell_per_s']:7.1f} Gcell/s (S={S}, T {T_lo}: {t_lo:.4f} ms, "
              f"T {T_hi}: {t_hi:.4f} ms) | {card}", flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("S", type=int, nargs="?", default=512)
    ap.add_argument("dtype", nargs="?", default="int32",
                    choices=["int32", "int16", "float32", "bfloat16"])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    from experiments.torch_shootout import card_line

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 1
    card = card_line()
    print(card, flush=True)
    run(card, args.S, args.dtype, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

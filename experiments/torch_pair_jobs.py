"""score_pairs' long-query jobs on the stream backend, timed so that two
trees compare in one call.

    python experiments/torch_pair_jobs.py [--root DIR] [--tag NAME] [--walls N] [--seed S]

Runs the package of the checkout at --root (default: this one; unpack a
parent with `git archive` into build/, which git ignores) on data made
from --seed with the root's chip_smoke.py (its query_pairs and case
constants):
  - (s): LADDER_S, 16 distinct queries of 2,049-4,095 bases x 64 targets
    of 513-2,048 (every 16th a window of its query), at score width 12
    and exact, through ScoreBank(backend="stream", device="cuda");
  - (j): J_SHORT + J_LONG at width 12 (2,048 short queries x 8 targets,
    and 16 long queries of 410-512 bases x 64 targets), and its 1,024
    long pairs alone.
For each, the wall of --walls warm calls (median and all), the B3
launches of a call, and over one more call, with a CUDA event recorded on
the launching stream just before and just after every B3 launch
(swtpu_torch.ops.stream.stream_chained_cuda wrapped here, in both trees
alike): B3's device span (the first launch's start event to the last
launch's end event), the union of the launches' intervals (busy), their
sum and the median launch, and the peak device memory of the call.  A
digest of the scores lets two trees' lines be held equal.  Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def union_ms(intervals):
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package to run")
    ap.add_argument("--tag", default="this", help="label of every line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--walls", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)  # the kernels build under the checkout's own build/
    import numpy as np
    import torch
    from chip_smoke import J_LONG, J_SHORT, J_WIDTH, LADDER_S, LADDER_WIDTH, query_pairs
    from swtpu_torch import SWConfig, ScoreBank
    from swtpu_torch.ops import stream as st

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    tag = args.tag

    real = st.stream_chained_cuda
    marks = []

    def traced(*a, **kw):
        """stream_chained_cuda between two timing events on the current
        stream; the wrapper counts its launch on this function, which
        takes its name in the module."""
        before = torch.cuda.Event(enable_timing=True)
        before.record()
        out = real(*a, **kw)
        after = torch.cuda.Event(enable_timing=True)
        after.record()
        marks.append((before, after))
        return out

    def case(label, bank, queries, targets):
        def run():
            return bank.score_pairs(queries, targets)

        res = run()
        walls = []
        for _ in range(args.walls):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        traced.launches = 0
        st.stream_chained_cuda = traced
        marks.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            again = run()
            torch.cuda.synchronize()
        finally:
            st.stream_chained_cuda = real
            real.launches += traced.launches
        if not np.array_equal(again.scores, res.scores):
            print(f"{tag} {label}: scores differ between calls")
            raise SystemExit(1)
        ref = marks[0][0]
        spans = [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in marks]
        device = max(b for _, b in spans) - min(a for a, _ in spans)
        each = [b - a for a, b in spans]
        digest = hashlib.sha256(res.scores.tobytes()).hexdigest()[:12]
        print(f"{tag} {label} | wall median {statistics.median(walls):.2f} ms (runs "
              f"{', '.join(f'{w:.2f}' for w in walls)}) | B3 launches a call "
              f"{traced.launches} ({len(marks)} traced), device "
              f"span {device:.3f} ms, busy {union_ms(spans):.3f} ms, sum {sum(each):.3f} ms, "
              f"median launch {statistics.median(each):.4f} ms | peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB | scores {digest}", flush=True)

    rng = np.random.default_rng([args.seed, 18])
    _, nq, per, qr, tr, self_every, least = LADDER_S
    s_queries, s_targets = query_pairs(rng, nq, per, qr, tr, self_every, (least, tr[1]))
    for width in (LADDER_WIDTH, None):
        bank = ScoreBank(SWConfig(score_width=width), backend="stream", device="cuda")
        case(f"(s) {'exact' if width is None else f'W={width}'}", bank, s_queries, s_targets)
    _, nq, per, qr, tr, _ = J_SHORT
    queries, targets = query_pairs(rng, nq, per, qr, tr)
    n_long, per_long, qr_long, tr_long, every = J_LONG
    longs, ltargets = query_pairs(rng, n_long, per_long, qr_long, tr_long, every)
    bank = ScoreBank(SWConfig(score_width=J_WIDTH), backend="stream", device="cuda")
    case(f"(j) W={J_WIDTH}", bank, queries + longs, targets + ltargets)
    case(f"(j) W={J_WIDTH} long pairs alone", bank, longs, ltargets)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

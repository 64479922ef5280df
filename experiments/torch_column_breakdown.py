"""Where the time of swtpu_torch's bucketed column path goes, on one CUDA GPU.

    python experiments/torch_column_breakdown.py [--seed N] [--reps N]

For chip_smoke.py's three bucketed cases at their shapes (data from
--seed): (f) a 128-base query against 262,144 ragged reads of 24-256
bases, (g) a 512-base query against 65,536 reads of 128 bases, and (h)
score_pairs at score width 12 on 65,536 pairs of 24-512 bases:
  - per-stage host-clock medians of one ScoreBank(backend="pallas") call
    taken apart, with a device synchronise after each stage, summed over
    the call's batches: plan + pack (host), H2D, kernels (B4, or the B5
    chain's tiles, with the sentinel padding before them), D2H + scatter;
  - the device busy share of one whole call under torch.profiler (device
    time of kernels and copies / host wall time).
Prints the card's name and power limit first; every number is this run's.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

STAGES = ("pack", "h2d", "kernel", "d2h", "total")


def stages_ms(bank, reps, query=None, db=None, queries=None, targets=None):
    """Median ms of each stage over `reps` warm runs."""
    import numpy as np
    import torch
    from swtpu_torch.ops.column import sw_scores_column

    kw = {}
    if bank.config.score_width is not None:
        kw = dict(state_dtype="int16_biased", score_width=bank.config.score_width)
    n = len(db.lens) if queries is None else len(queries)
    parts = {k: [] for k in STAGES}
    for rep in range(reps + 1):  # the first run warms up
        acc = dict.fromkeys(STAGES, 0.0)
        scores = np.zeros(n, np.int32)
        t_start = t_prev = time.perf_counter()
        batches = (bank._bucket_batches(query, db) if queries is None
                   else bank._pair_batches(queries, targets))
        for b in batches:
            t1 = time.perf_counter()  # packing runs inside the generator
            dq, dt = (torch.from_numpy(a).to(bank.device) for a in (b.q, b.t))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            s = sw_scores_column(dq, dt, bank.config.penalties, **kw)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            live = b.ids >= 0
            scores[b.ids[live]] = s.cpu().numpy()[live]
            t4 = time.perf_counter()
            for k, a, z in zip(STAGES, (t_prev, t1, t2, t3), (t1, t2, t3, t4)):
                acc[k] += (z - a) * 1e3
            t_prev = t4
        acc["total"] = (t_prev - t_start) * 1e3
        if rep:
            for k in STAGES:
                parts[k].append(acc[k])
    return {k: statistics.median(v) for k, v in parts.items()}


def busy_share(run):
    """(device ms of kernels and copies, host wall ms) of one profiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    dev_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return dev_us / 1e3, wall * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    from chip_smoke import F_CASE, H_CASE, LONG_CASES, make_db, make_pairs
    from swtpu_torch import SWConfig, ScoreBank

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    rng = np.random.default_rng([args.seed, 3])
    bank = ScoreBank(SWConfig(), backend="pallas", device="cuda")
    g_name, g_n, (g_lo, g_hi), g_q = LONG_CASES[1]  # (e)'s shape
    for name, n, (lo, hi), qlen in (F_CASE, ("g_bucketed_q512", g_n, (g_lo, g_hi), g_q)):
        db = make_db(rng, n, lo, hi)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        med = stages_ms(bank, args.reps, query=query, db=db)
        dev_ms, wall_ms = busy_share(lambda: bank.score_database(query, db))
        print(f"{name} medians of {args.reps}: "
              + " ".join(f"{k}={v:.2f}ms" for k, v in med.items())
              + f" | profiled call: device {dev_ms:.2f} ms of wall {wall_ms:.2f} ms"
              f" = {dev_ms / wall_ms:.1%} busy", flush=True)
    name, n, (lo, hi), width = H_CASE
    queries, targets = make_pairs(rng, n, lo, hi)
    wbank = ScoreBank(SWConfig(score_width=width), device="cuda")
    med = stages_ms(wbank, args.reps, queries=queries, targets=targets)
    dev_ms, wall_ms = busy_share(lambda: wbank.score_pairs(queries, targets))
    print(f"{name} medians of {args.reps}: "
          + " ".join(f"{k}={v:.2f}ms" for k, v in med.items())
          + f" | profiled call: device {dev_ms:.2f} ms of wall {wall_ms:.2f} ms"
          f" = {dev_ms / wall_ms:.1%} busy", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

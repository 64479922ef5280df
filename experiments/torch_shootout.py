"""Kernel shootout on one CUDA GPU: column (B4) vs lane-major (B6) vs wavefront.

    python experiments/torch_shootout.py [--seed N] [--reps N]

The port's counterpart of experiments/shootout.py.  65,536 random pairs
of 128 x 128 bases (1.07 G cells) and the reference's small run of 8,192
pairs, made from --seed:
  - sw_scores_column (B4: a warp per pair), sw_scores_lane (B6: a thread
    per pair) and the streamed wavefront (pack_streams at S = 256 and 512
    streams, once on the host, then sw_scores_stream_strip at rows 1),
    each timed warm with CUDA events (swtpu_torch.utils.timing.cuda_ms:
    the mean of --reps calls after one);
  - each contestant's time and GCUPS at both sizes, and the reference's
    figure, (big - small cells) / (big - small time);
  - like with like: B4 and B6 give the same scores on all 65,536 pairs,
    and the wavefront (one query, q[0], against every target) gives B4's
    scores on (q[0], t[i]) for every i.  (The reference's spot check
    compares wavefront scores of (q[0], t[i]) with column scores of
    (q[i], t[i]): different pairs.)
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

M = N = 128  # query and target bases
BIG, SMALL = 65536, 8192  # pairs (shootout.py:38)
STREAMS = (256, 512)  # the wavefront's physical streams (shootout.py:70)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def make_pairs(seed: int):
    """BIG random pairs, q [BIG, 128] and t [BIG, 128] int8 on the card
    (codes 0-3, no padding: every cell is real)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (BIG, M)).astype(np.int8)
    t = rng.integers(0, 4, (BIG, N)).astype(np.int8)
    return torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()


def wavefront_batches(q, t, n_pairs):
    """{S: (the batch of q[0] against t[:n_pairs] packed on S streams at
    rows 1, the same batch on the card)}: packed once on the host, as the
    reference does."""
    from swtpu_torch.bank.streams import batch_to_device, pack_streams

    query = q[0].cpu().numpy()
    targets = t[:n_pairs].cpu().numpy()
    out = {}
    for S in STREAMS:
        b = pack_streams(query, targets, n_streams=S, rows=1)
        out[S] = (b, batch_to_device(b, q.device))
    return out


def contestants(q, t, n_pairs):
    """(name, call) of each contestant on the first n_pairs pairs."""
    from swtpu_torch.ops.column import sw_scores_column
    from swtpu_torch.ops.lane import sw_scores_lane
    from swtpu_torch.ops.stream import sw_scores_stream_strip

    qs, ts = q[:n_pairs].contiguous(), t[:n_pairs].contiguous()
    out = [
        ("column B4", lambda: sw_scores_column(qs, ts)),
        ("lane B6", lambda: sw_scores_lane(qs, ts)),
    ]
    for S, (_, d) in wavefront_batches(q, t, n_pairs).items():
        out.append((f"wavefront S={S} rows=1",
                    lambda d=d: sw_scores_stream_strip(d.q, d.stream, rows=1)))
    return out


def race(q, t, card, reps):
    """Time every contestant at BIG and SMALL pairs; prints one line each
    and returns [{name, big_ms, small_ms, gcups_big, gcups_small,
    gcups_diff}]."""
    from swtpu_torch.utils.timing import cuda_ms

    cells, cells_s = BIG * M * N, SMALL * M * N
    big, small = contestants(q, t, BIG), contestants(q, t, SMALL)
    rows = []
    for (name, run), (_, run_s) in zip(big, small):
        tb, ts = cuda_ms(run, reps), cuda_ms(run_s, reps)
        row = dict(name=name, big_ms=tb, small_ms=ts, gcups_big=cells / tb / 1e6,
                   gcups_small=cells_s / ts / 1e6,
                   gcups_diff=(cells - cells_s) / (tb - ts) / 1e6 if tb > ts else None)
        diff = f"{row['gcups_diff']:.1f}" if row["gcups_diff"] else "n/a"
        print(f"shootout {name}: {BIG} pairs {tb:.4f} ms ({row['gcups_big']:.1f} GCUPS), "
              f"{SMALL} pairs {ts:.4f} ms ({row['gcups_small']:.1f} GCUPS), big - small "
              f"{diff} GCUPS | {card}", flush=True)
        rows.append(row)
    return rows


def check_like_with_like(q, t):
    """B4 == B6 on every pair; the wavefront on (q[0], t[i]) == B4 on
    (q[0], t[i]) for every i, at each stream count.  Raises on a mismatch;
    returns the number of pairs each check covered."""
    import numpy as np
    from swtpu_torch.bank.streams import gather_stream_scores
    from swtpu_torch.ops.column import sw_scores_column
    from swtpu_torch.ops.lane import sw_scores_lane
    from swtpu_torch.ops.stream import sw_scores_stream_strip

    col = sw_scores_column(q, t).cpu().numpy()
    lane = sw_scores_lane(q, t).cpu().numpy()
    if not np.array_equal(col, lane):
        k = int(np.flatnonzero(col != lane)[0])
        raise AssertionError(f"pair {k}: B4 {col[k]}, B6 {lane[k]}")
    q0 = q[0].expand(q.shape[0], -1).contiguous()
    want = sw_scores_column(q0, t).cpu().numpy()
    for S, (b, d) in wavefront_batches(q, t, q.shape[0]).items():
        strip = sw_scores_stream_strip(d.q, d.stream, rows=1).cpu().numpy()
        got = gather_stream_scores(strip, b)
        if not np.array_equal(got, want):
            k = int(np.flatnonzero(got != want)[0])
            raise AssertionError(f"S={S} target {k}: wavefront {got[k]}, B4 {want[k]}")
    return dict(b4_b6_pairs=len(col), wavefront_pairs=len(want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 1
    card = card_line()
    print(card, flush=True)
    q, t = make_pairs(args.seed)
    race(q, t, card, args.reps)
    n = check_like_with_like(q, t)
    print(f"shootout like with like: B4 == B6 on all {n['b4_b6_pairs']} pairs, "
          f"wavefront == B4 on (q[0], t[i]) for all {n['wavefront_pairs']} targets "
          f"at S = {', '.join(map(str, STREAMS))} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

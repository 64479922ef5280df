"""B3's long-query chains timed so that two trees compare in one call.

    python experiments/torch_chain_b3.py [--root DIR] [--tag NAME] [--reps N] [--seed S]
                                         [--sixteen]

Runs the package of the checkout at --root (default: this one; unpack a
parent with `git archive` into build/, which git ignores) on data made
from --seed with the root's chip_smoke.py (its case constants and
builders), so that a tree whose chain runs a launch a tile and one whose
chain runs in one launch see the same inputs:
  - (d) and (e): chip_smoke's LONG_CASES, a 256-base query against 262,144
    reads of 24-256 bases (K = 2) and a 512-base one against 65,536 reads
    of 128 (K = 4); (q): a 4,095-base query against 65,536 reads of 128
    (K = 32); each case's batch packed as ScoreBank packs it (512 streams,
    rows 16) and its chain (swtpu_torch.ops.stream._long_strip) run
    exact and at score width 12;
  - (s): LADDER_S's 16 distinct queries of 2,049-4,095 bases x 64
    targets of 513-2,048 through ScoreBank(backend="stream").score_pairs,
    exact and at score width 12;
  - (j): J_SHORT + J_LONG at width 12 (2,048 short queries x 8 targets,
    and 16 long queries of 410-512 bases x 64 targets), and its 1,024
    long pairs alone.
--sixteen times instead the 16-bit states' chains: (d) and (e) packed at
rows 8 (the 16-bit states refuse 16) and run exact in int32 and in each
of chip_smoke's SIXTEEN_BIT modes (int16, uint16 at +5/0 and +5/-4 with no
gap cost, bfloat16) at its penalties, then (d) and (e) at rows 16 in int32
(the 32-bit chain beside them); a tree whose 16-bit chain runs a launch a
tile (and shifts on the host) against one whose chain is one launch.
For each: the chain's time (CUDA events around `reps` warm calls,
median), or for (s) the call's wall (host clock, median); the host's
dispatch (the time until the call returns, before the card finishes; for
(s) the time in the bank's job dispatch); the B3 launches of a call; over
one more call, with a CUDA event recorded on the launching stream just
before and just after every B3 launch (both wrappers, where the tree has
them, wrapped here alike): B3's device span, the union of the launches'
intervals (busy) and the median launch; the peak device memory of a call;
and a digest of the strip or the scores, so that two trees' lines can be
held equal.  Prints the card's name and power limit first.
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
WIDTH = 12
Q_CASE = ("q_chain", 65536, (128, 128), 4095)


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
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sixteen", action="store_true",
                    help="only the 16-bit states' chains at (d) and (e), rows 8")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)  # the kernels build under the checkout's own build/
    import numpy as np
    import torch
    from chip_smoke import (
        J_LONG, J_SHORT, J_WIDTH, LADDER_S, LONG_CASES, SIXTEEN_BIT, long_batch, make_db,
        query_pairs,
    )
    from swtpu_torch import DEFAULT_PENALTIES, Penalties, SWConfig, ScoreBank
    from swtpu_torch.ops import stream as st

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    tag = args.tag
    # B3's wrappers in this tree: the whole chain (where it exists) and a tile
    names = [n for n in ("stream_chain_cuda", "stream_chained_cuda") if hasattr(st, n)]
    marks = []

    def traced(real):
        def call(*a, **kw):
            """The wrapper between two timing events on the current stream;
            the wrapper counts its launch on this function, which takes its
            name in the module."""
            before = torch.cuda.Event(enable_timing=True)
            before.record()
            out = real(*a, **kw)
            after = torch.cuda.Event(enable_timing=True)
            after.record()
            marks.append((before, after))
            return out
        call.launches = 0
        return call

    def b3_launches():
        return sum(getattr(st, n).launches for n in names)

    def trace(run):
        """run() once with every B3 launch between events: (its result,
        launches, device span, busy, median launch, peak GB)."""
        reals = {n: getattr(st, n) for n in names}
        marks.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches = b3_launches()
        for n in names:
            setattr(st, n, traced(reals[n]))
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            for n in names:
                reals[n].launches += getattr(st, n).launches
                setattr(st, n, reals[n])
        ref = marks[0][0]
        spans = [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in marks]
        return (out, b3_launches() - launches,
                max(b for _, b in spans) - min(a for a, _ in spans), union_ms(spans),
                statistics.median(b - a for a, b in spans),
                torch.cuda.max_memory_allocated() / 1e9)

    def report(label, ms, dispatch, traced_call, digest, unit):
        _, launches, span, busy, median, peak = traced_call
        print(f"{tag} {label} | {unit} median {statistics.median(ms):.3f} ms (runs "
              f"{', '.join(f'{x:.3f}' for x in ms)}) | host dispatch median "
              f"{statistics.median(dispatch):.3f} ms | B3 launches a call {launches}, "
              f"device span {span:.3f} ms, busy {busy:.3f} ms, median launch "
              f"{median:.4f} ms | peak device memory {peak:.3f} GB | digest {digest}",
              flush=True)

    def chain_case(label, q, sk, width, rows=16, penalties=DEFAULT_PENALTIES, **mode):
        def run():
            return st._long_strip(q, sk, penalties, rows, score_width=width, **mode)

        strip = run()
        torch.cuda.synchronize()
        ms, dispatch = [], []
        for _ in range(args.reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            run()
            dispatch.append((time.perf_counter() - t0) * 1e3)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        traced_call = trace(run)
        if not torch.equal(traced_call[0], strip):
            print(f"{tag} {label}: strips differ between calls")
            raise SystemExit(1)
        digest = hashlib.sha256(strip.cpu().numpy().tobytes()).hexdigest()[:12]
        report(label, ms, dispatch, traced_call, digest, "chain")

    def pairs_case(label, bank, queries, targets):
        def run():
            return bank.score_pairs(queries, targets)

        res = run()
        dispatch_long = bank._dispatch_long
        spent = []

        def timed_dispatch(*a, **kw):
            t0 = time.perf_counter()
            out = dispatch_long(*a, **kw)
            spent.append(time.perf_counter() - t0)
            return out

        walls, dispatch = [], []
        bank._dispatch_long = timed_dispatch
        try:
            for _ in range(args.reps):
                spent.clear()
                t0 = time.perf_counter()
                run()
                walls.append((time.perf_counter() - t0) * 1e3)
                dispatch.append(sum(spent) * 1e3)
        finally:
            bank._dispatch_long = dispatch_long
        traced_call = trace(run)
        if not np.array_equal(traced_call[0].scores, res.scores):
            print(f"{tag} {label}: scores differ between calls")
            raise SystemExit(1)
        digest = hashlib.sha256(res.scores.tobytes()).hexdigest()[:12]
        report(label, walls, dispatch, traced_call, digest, "wall")

    rng = np.random.default_rng([args.seed, 19])
    if args.sixteen:
        for name, n, (lo, hi), qlen in LONG_CASES:
            db = make_db(rng, n, lo, hi)
            query = rng.integers(0, 4, size=qlen).astype(np.int8)
            for rows in (8, 16):
                q, sk = long_batch(query, db, rows, 512)
                T, N = sk.shape
                head = f"{name} [{T}, {N}] K={q.shape[1] // 128} rows={rows}"
                chain_case(f"{head} int32", q, sk, None, rows)
                for label, dtype, pen in SIXTEEN_BIT if rows == 8 else ():
                    chain_case(f"{head} {label}", q, sk, None, rows, Penalties(*pen),
                               state_dtype=dtype)
                del q, sk
            del db
        return 0
    for name, n, (lo, hi), qlen in (*LONG_CASES, Q_CASE):
        db = make_db(rng, n, lo, hi)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        q, sk = long_batch(query, db, 16, 512)
        T, N = sk.shape
        for width in (None, WIDTH):
            chain_case(f"{name} [{T}, {N}] K={q.shape[1] // 128} "
                       f"{'exact' if width is None else f'W={width}'}", q, sk, width)
        del q, sk, db
    _, nq, per, qr, tr, self_every, least = LADDER_S
    queries, targets = query_pairs(rng, nq, per, qr, tr, self_every, (least, tr[1]))
    for width in (None, WIDTH):
        bank = ScoreBank(SWConfig(score_width=width), backend="stream", device="cuda")
        pairs_case(f"(s) {'exact' if width is None else f'W={width}'}", bank, queries,
                   targets)
    _, nq, per, qr, tr, _ = J_SHORT
    queries, targets = query_pairs(rng, nq, per, qr, tr)
    n_long, per_long, qr_long, tr_long, every = J_LONG
    longs, ltargets = query_pairs(rng, n_long, per_long, qr_long, tr_long, every)
    bank = ScoreBank(SWConfig(score_width=J_WIDTH), backend="stream", device="cuda")
    pairs_case(f"(j) W={J_WIDTH}", bank, queries + longs, targets + ltargets)
    pairs_case(f"(j) W={J_WIDTH} long pairs alone", bank, longs, ltargets)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

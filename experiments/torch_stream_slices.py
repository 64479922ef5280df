"""The wavefront kernels (B1, B2, B3) over their time-slice counts, on one
CUDA GPU.

    python experiments/torch_stream_slices.py [--root DIR] [--tag NAME]

Times stream_strip_cuda / stream_chained_cuda (CUDA events, mean of warm
calls) at the wrapper's slice count ("default") and at fixed counts, on:
short streams like chip_smoke.py's phase 3 (~1,600 steps: rows 16, rows 4
at segments 4, rows 1 in both forms, one chained tile at rows 16); E2's
comparison strip (rows 1, [4096, 512], 1 % of chars start a read); the
shootout's rows-1 strip; and cases (a)-(d) of chip_smoke.py at their
geometry.  --root runs the package of another checkout of the repo (a
parent commit's tree, say) so that two trees are compared within one
call; a tree whose wrappers take no `slices` is timed at its default only.
Where the wrappers take `score_width` and `state_dtype`, (a) and (d)'s tile
are timed again in the W = 12 wrap-parity and float32 state modes; where
they take the 16-bit states, (a) and (d)'s tile at rows 8 in int32, int16,
uint16 (at penalties it can hold: +5/-4, no gap cost) and bfloat16, the
16-bit states over slice counts around the wrapper's; and where the column
wrappers take `state_dtype`, the column kernels at chip_smoke.py's (f)
buckets (B4) and (g) tiles (B5) in int32, float32 and int16.  --only
states times just those state-mode lines and (a)/(d) at rows 16 (the
comparison of two trees' state modes, P E E P in one call); --only b1
times B1 at (a), (b), (c) and chip_smoke.py's (r) (16,384 reads of
513-2,048 bases, rows 16) and B2 (the shootout's rows-1 strip in both
forms, E2's comparison strip) over wide sweeps of slice counts, the
default passing the batch's longest read where the tree's wrapper takes
it (`longest_read`); --only b1_16 times B1 in the 16-bit states (int16,
uint16, bfloat16) beside int32 at (a) at rows 8 and 4 and at (c)
(segments 2, rows 8), at the default passing the batch's longest read
and at a few fixed counts.
Each line ends with a digest of the outputs: equal digests across trees
and counts mean bit-equal strips.  Prints the card's name and power limit
first; every number is this run's.
"""

from __future__ import annotations

import argparse
import inspect
import os
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose swtpu_torch and chip_smoke.py to run")
    ap.add_argument("--tag", default="this", help="label of every line")
    ap.add_argument("--only", choices=("all", "states", "b1", "b1_16"), default="all",
                    help="states: only (a)/(d) at rows 16 and the state-mode lines; "
                    "b1: only B1 at (a)-(c) and (r) and B2, over wide slice sweeps; "
                    "b1_16: only B1 in the 16-bit states at (a) rows 8 and 4 and (c)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)  # the kernels build under the checkout's own build/

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 1
    from chip_smoke import laid_out_batch, long_batch, make_db
    from swtpu_torch import DEFAULT_PENALTIES as P
    from swtpu_torch.ops import stream as st
    from swtpu_torch.utils.timing import cuda_ms

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    sliced = "slices" in inspect.signature(st.stream_strip_cuda).parameters
    modes = "score_width" in inspect.signature(st.stream_strip_cuda).parameters
    # (label, wrapper keywords, boundary zero of a chained tile)
    mode_runs = [("W=12", dict(score_width=12), 1 << 11),
                 ("float32", dict(state_dtype="float32"), 0)] if modes else []
    # rows 8 in int32 and the 16-bit states (which refuse rows 16)
    P16 = type(P)(5, -4, 0, 0)  # uint16 holds no negative gap penalty
    runs_16 = [("int32", P, {}), ("int16", P, dict(state_dtype="int16")),
               ("uint16", P16, dict(state_dtype="uint16")),
               ("bfloat16", P, dict(state_dtype="bfloat16"))
               ] if "int16" in getattr(st, "STATE_DTYPES", {}) else []

    def digest(outs):
        h = 0
        for x in outs:
            x = x.long().flatten()
            w = torch.arange(1, x.numel() + 1, device=x.device) % 1000003
            h = (h * 1000033 + int((x * w).sum())) % (1 << 48)
        return h

    def report(name, fn, counts, reps=10):
        digests, parts = set(), []
        for c in [None, *counts] if sliced else [None]:
            kw = {} if c is None else dict(slices=c)
            out = fn(**kw)
            digests.add(digest(out if isinstance(out, tuple) else (out,)))
            ms = cuda_ms(lambda: fn(**kw), reps)
            parts.append(f"{'default' if c is None else c}:{ms:.4f}")
        print(f"{args.tag} {name} | ms at slices " + " ".join(parts)
              + f" | digest {'/'.join(f'{d:012x}' for d in sorted(digests))}", flush=True)

    def tile0(query, db, rows):
        q, sk = long_batch(query, db, rows, 512)
        qk = st._q_kernel_layout(q[:, :128], 1, rows).to(torch.int8).contiguous()
        z = torch.zeros(tuple(sk.shape), dtype=torch.int32, device="cuda")
        return qk, sk, z

    if args.only == "b1":
        b1_sweeps(report, P)
        return 0
    if args.only == "b1_16":
        b1_16bit(report, runs_16)
        return 0
    rng = np.random.default_rng(1)
    short = args.only == "all"
    for seg, rows in ((1, 16), (4, 4), (1, 1)) if short else ():
        db = make_db(rng, 512 * seg * 10, 24, 256)
        query = rng.integers(0, 4, size=128 // seg).astype(np.int8)
        qk, sk = laid_out_batch(query, db, seg, rows, 512)
        report(f"short seg={seg} rows={rows} [{sk.shape[0]}, {sk.shape[1]}]",
               lambda **kw: st.stream_strip_cuda(qk, sk, P, seg, rows, **kw), [1, 2])
        if rows == 1:
            report(f"short ripple-H seg={seg} [{sk.shape[0]}, {sk.shape[1]}]",
                   lambda **kw: st.stream_strip_cuda(qk, sk, P, seg, 1, False, **kw), [1, 2])
    if short:
        short_cases(rng, report, tile0, P)
    rng = np.random.default_rng(7)
    query = rng.integers(0, 4, size=128).astype(np.int8)
    db_a = make_db(rng, 262144, 128, 128)
    qk, sk = laid_out_batch(query, db_a, 1, 16, 512)
    report(f"(a) rows=16 [{sk.shape[0]}, 512]",
           lambda **kw: st.stream_strip_cuda(qk, sk, P, 1, 16, **kw), [1], reps=5)
    for label, mode, _ in mode_runs:
        report(f"(a) rows=16 {label} [{sk.shape[0]}, 512]",
               lambda **kw: st.stream_strip_cuda(qk, sk, P, 1, 16, **mode, **kw), [1], reps=5)
    del qk, sk
    # the 16-bit states around the wrapper's slice count: its choice for one
    # stream a thread (16 here) and for two (33), and multiples between
    counts_16 = [1, 8, 16, 24, 33, 48, 66]
    if runs_16:
        qk, sk = laid_out_batch(query, db_a, 1, 8, 512)
        for label, pen, mode in runs_16:
            report(f"(a) rows=8 {label} [{sk.shape[0]}, 512]",
                   lambda **kw: st.stream_strip_cuda(qk, sk, pen, 1, 8, **mode, **kw),
                   counts_16 if mode else [1], reps=5)
        del qk, sk
    del db_a
    query_d = rng.integers(0, 4, size=256).astype(np.int8)
    db_d = make_db(rng, 262144, 24, 256)
    qk, sk, z = tile0(query_d, db_d, 16)
    report(f"(d) tile 0 rows=16 [{sk.shape[0]}, 512]",
           lambda **kw: st.stream_chained_cuda(qk, sk, z, z, z, P, 16, **kw), [1], reps=5)
    for label, mode, zero in mode_runs:
        b = torch.full_like(z, zero)
        report(f"(d) tile 0 rows=16 {label} [{sk.shape[0]}, 512]",
               lambda **kw: st.stream_chained_cuda(qk, sk, b, b, b, P, 16, **mode, **kw), [1],
               reps=5)
    del qk, sk, z
    if runs_16:
        qk, sk, z = tile0(query_d, db_d, 8)
        for label, pen, mode in runs_16:
            report(f"(d) tile 0 rows=8 {label} [{sk.shape[0]}, 512]",
                   lambda **kw: st.stream_chained_cuda(qk, sk, z, z, z, pen, 8, **mode, **kw),
                   counts_16 if mode else [1], reps=5)
        del qk, sk, z
    del db_d
    column_states(args.tag, digest)
    return 0


def column_states(tag, digest):
    """B4 at chip_smoke.py's (f) buckets and B5 at (g)'s tiles in each
    column state the tree's wrappers take, as ScoreBank packs them."""
    import numpy as np
    from chip_smoke import F_CASE, LONG_CASES, column_batches, make_db, run_column_chain
    from swtpu_torch import SWConfig, ScoreBank
    from swtpu_torch.ops import column as col
    from swtpu_torch.utils.timing import cuda_ms

    if "state_dtype" not in inspect.signature(col.column_scores_cuda).parameters:
        return
    states = [s for s in ("int32", "float32", "int16") if s in col.STATE_CODES]
    bank = ScoreBank(SWConfig(), backend="pallas", device="cuda")
    name, n, (lo, hi), qlen = F_CASE
    rng = np.random.default_rng(11)
    db = make_db(rng, n, lo, hi)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    for q, t in column_batches(bank, query, db):
        parts, digests = [], set()
        for dtype in states:
            digests.add(digest((col.column_scores_cuda(q, t, state_dtype=dtype),)))
            ms = cuda_ms(lambda: col.column_scores_cuda(q, t, state_dtype=dtype), 5)
            parts.append(f"{dtype}:{ms:.4f}")
        print(f"{tag} (f) B4 bucket {t.shape[1]} [{q.shape[0]} pairs, query {q.shape[1]}] | "
              f"ms {' '.join(parts)} | digest "
              f"{'/'.join(f'{d:012x}' for d in sorted(digests))}", flush=True)
    name, n, (lo, hi), qlen = LONG_CASES[1]  # (g) takes (e)'s reads and query
    db = make_db(rng, n, lo, hi)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    (q, t), = column_batches(bank, query, db)
    parts, digests = [], set()
    for dtype in states:
        _, tiles = run_column_chain(q, t, None, col.column_chained_cuda, dtype)
        digests.add(digest(tiles[-1][1]))
        ms = [cuda_ms(lambda: col.column_chained_cuda(*a), 5) for a, _ in tiles]
        parts.append(f"{dtype}:{'/'.join(f'{x:.4f}' for x in ms)}")
    print(f"{tag} (g) B5 tiles [{q.shape[0]} pairs, {t.shape[1]} columns] | ms a tile "
          f"{' '.join(parts)} | digest {'/'.join(f'{d:012x}' for d in sorted(digests))}",
          flush=True)


def b1_sweeps(report, P):
    """B1 at (a), (b), (c) and (r) and B2 at the shootout's strip (both
    forms) and E2's comparison, over wide sweeps of slice counts."""
    import inspect

    import numpy as np
    import torch
    from chip_smoke import LADDER_R, laid_out_batch, make_db
    from experiments import torch_shootout as so
    from swtpu_torch.ops import stream as st

    takes_longest = "longest_read" in inspect.signature(st.stream_strip_cuda).parameters

    def longest(db):
        return dict(longest_read=int(db.lens.max())) if takes_longest else {}

    cases = [("(a)", np.random.default_rng(7), 262144, (128, 128), 128, 1, 16, [1, 16, 33]),
             ("(b)", np.random.default_rng(9), 262144, (24, 256), 32, 4, 4,
              [1, 4, 8, 12, 16, 24, 33, 48, 66]),
             ("(c)", np.random.default_rng(19), 65536, (24, 256), 64, 2, 8,
              [1, 4, 8, 12, 16, 24, 33, 48]),
             ("(r)", np.random.default_rng(10), LADDER_R[1], LADDER_R[2], LADDER_R[3], 1, 16,
              [1, 4, 6, 8, 10, 12, 16, 20, 24, 33, 48, 66])]
    for name, rng, n, (lo, hi), qlen, seg, rows, counts in cases:
        db = make_db(rng, n, lo, hi)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        qk, sk = laid_out_batch(query, db, seg, rows, 512)
        lr = longest(db)
        report(f"B1 {name} seg={seg} rows={rows} [{sk.shape[0]}, {sk.shape[1]}] longest read "
               f"{int(db.lens.max())}",
               lambda **kw: st.stream_strip_cuda(qk, sk, P, seg, rows, **lr, **kw), counts,
               reps=5)
        del qk, sk
    qs, ts = so.make_pairs(0)
    _, d = so.wavefront_batches(qs, ts, so.BIG)[512]
    qk, sk = st._to_kernel_layout(d.q, d.stream, 1, 1)
    for form, tail_acc in (("tail-acc", True), ("ripple-H", False)):
        report(f"B2 shootout {form} rows=1 [{sk.shape[0]}, 512]",
               lambda **kw: st.stream_strip_cuda(qk, sk, P, 1, 1, tail_acc, **kw),
               [1, 2, 4, 8, 16, 33])
    r2 = np.random.default_rng([0, 4])  # chip_smoke.py's E2 comparison, seed 0
    qT = torch.from_numpy(r2.integers(0, 4, (128, 512)).astype(np.int8)).cuda()
    s2 = r2.integers(0, 4, (4096, 512)).astype(np.int8)
    s2[r2.random(s2.shape) < 0.01] |= 8
    s2 = torch.from_numpy(s2).cuda()
    report("B2 E2 comparison rows=1 [4096, 512]",
           lambda **kw: st.stream_strip_cuda(qT, s2, P, 1, 1, **kw), [1, 2, 4, 8])


def b1_16bit(report, runs_16):
    """B1 in each 16-bit state beside int32 at (a) at rows 8 and 4 and at
    (c) (segments 2, rows 8), the batch as ScoreBank packs it, the default
    count from the batch's longest read where the tree's wrapper takes it."""
    import numpy as np
    from chip_smoke import laid_out_batch, make_db
    from swtpu_torch.ops import stream as st

    takes_longest = "longest_read" in inspect.signature(st.stream_strip_cuda).parameters
    cases = [("(a)", np.random.default_rng(7), 262144, (128, 128), 128, 1, (8, 4)),
             ("(c)", np.random.default_rng(19), 65536, (24, 256), 64, 2, (8,))]
    for name, rng, n, (lo, hi), qlen, seg, rows_list in cases:
        db = make_db(rng, n, lo, hi)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        lr = dict(longest_read=int(db.lens.max())) if takes_longest else {}
        for rows in rows_list:
            qk, sk = laid_out_batch(query, db, seg, rows, 512)
            for label, pen, mode in runs_16:
                report(f"B1 {name} seg={seg} rows={rows} {label} [{sk.shape[0]}, "
                       f"{sk.shape[1]}] longest read {int(db.lens.max())}",
                       lambda **kw: st.stream_strip_cuda(qk, sk, pen, seg, rows, **mode, **lr,
                                                         **kw),
                       [8, 16, 33, 66], reps=5)
            del qk, sk


def short_cases(rng, report, tile0, P):
    """The short streams, E2's comparison strip, the shootout's rows-1
    strip and cases (b) and (c) over slice counts."""
    import numpy as np
    import torch
    from chip_smoke import laid_out_batch, make_db
    from experiments import torch_shootout as so
    from swtpu_torch.ops import stream as st

    qk, sk, z = tile0(rng.integers(0, 4, size=256).astype(np.int8),
                      make_db(rng, 5120, 24, 256), 16)
    report(f"short chained tile rows=16 [{sk.shape[0]}, 512]",
           lambda **kw: st.stream_chained_cuda(qk, sk, z, z, z, P, 16, **kw), [1, 2])

    r2 = np.random.default_rng([0, 4])  # chip_smoke.py's E2 comparison, seed 0
    qT = torch.from_numpy(r2.integers(0, 4, (128, 512)).astype(np.int8)).cuda()
    s2 = r2.integers(0, 4, (4096, 512)).astype(np.int8)
    s2[r2.random(s2.shape) < 0.01] |= 8
    s2 = torch.from_numpy(s2).cuda()
    report("E2 comparison rows=1 [4096, 512]",
           lambda **kw: st.stream_strip_cuda(qT, s2, P, 1, 1, **kw), [1, 2, 3, 4])

    qs, ts = so.make_pairs(0)
    _, d = so.wavefront_batches(qs, ts, so.BIG)[512]
    qk, sk = st._to_kernel_layout(d.q, d.stream, 1, 1)
    report(f"shootout rows=1 [{sk.shape[0]}, 512]",
           lambda **kw: st.stream_strip_cuda(qk, sk, P, 1, 1, **kw), [1, 4, 8, 16])

    rng = np.random.default_rng(9)
    for name, n, qlen, seg, rows in (("(b)", 262144, 32, 4, 4), ("(c)", 65536, 64, 2, 8)):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        qk, sk = laid_out_batch(query, make_db(rng, n, 24, 256), seg, rows, 512)
        report(f"{name} seg={seg} rows={rows} [{sk.shape[0]}, {sk.shape[1]}]",
               lambda **kw: st.stream_strip_cuda(qk, sk, P, seg, rows, **kw), [1, 4, 8, 16],
               reps=5)


if __name__ == "__main__":
    raise SystemExit(main())

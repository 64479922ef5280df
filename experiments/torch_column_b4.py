"""B4, the column scores kernel, at the main path's shapes, timed so that
two trees compare in one call.

    python experiments/torch_column_b4.py [--root DIR] [--tag NAME] [--reps N]

Runs the package of the checkout at --root (default: this one; unpack a
parent with `git archive` into build/, which git ignores) on data made
from --seed:
  - (f)'s bucket batches (chip_smoke.py's F_CASE: a 128-base query against
    262,144 reads of 24-256 bases, as ScoreBank packs them) in int32,
    float32, W = 12 and int16 state;
  - (h)'s pair batches of queries up to 256 bases (H_CASE: score_pairs at
    score width 12), at W = 12;
  - the shootout's 65,536 random pairs of 128 x 128, int32;
  - the long-gap pairs of swtpu_torch/testing/gaps.py (this tree's file),
    4,096 at m = 32, 128 and 256, int32;
  - B5 on (g)'s two tiles, int32;
  - the walls of (f)'s score_database and (h)'s score_pairs, median of
    --walls warm calls;
  - the registers, spill bytes and resident blocks an SM of B4's
    instantiation at query widths 8-256 in each state, and of B5's.
A kernel row gives the wrapper's mean time over --reps calls (CUDA events
around the calls, swtpu_torch.utils.timing.cuda_ms), the mean device time
a call of the same calls captured in one CUDA graph and replayed back to
back (this tree's swtpu_torch.utils.timing.graph_ms: the kernel's own time
where the wrapper's host work outlasts it), and a digest of the scores, so
that two trees' lines can be held equal.  Prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def own_module(name, *path):
    """A module of this tree by file, whatever tree --root puts first on
    the path (a parent may lack it)."""
    spec = importlib.util.spec_from_file_location(name, HERE.joinpath(*path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digest(x):
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:12]


def wall_ms(run, n):
    run()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), walls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package to run")
    ap.add_argument("--tag", default="this", help="label of every line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--walls", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)  # the kernels build under the checkout's own build/
    import numpy as np
    import torch
    from chip_smoke import (
        F_CASE, H_CASE, LONG_CASES, column_batches, make_db, make_pairs, run_column_chain,
    )
    from swtpu_torch import SWConfig, ScoreBank
    from swtpu_torch.ops import column as col
    from swtpu_torch.utils.timing import cuda_ms

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    gaps = own_module("long_gaps", "swtpu_torch", "testing", "gaps.py")
    timing = own_module("own_timing", "swtpu_torch", "utils", "timing.py")
    tag = args.tag

    def device_ms(fn, reps):
        return timing.graph_ms(fn, reps)

    def row(case, mode, q, t, **kw):
        fn = lambda: col.column_scores_cuda(q, t, **kw)  # noqa: E731
        ms = cuda_ms(fn, args.reps)
        dev = device_ms(fn, args.reps)
        (B, m), n = q.shape, t.shape[1]
        print(f"{tag} {case} {mode} [{B} pairs, {m} x {n}] | wrapper {ms:.4f} ms, device "
              f"{dev:.4f} ms | scores {digest(fn())}", flush=True)

    modes = {"int32": {}, "float32": dict(state_dtype="float32"),
             "W=12": dict(score_width=12), "int16": dict(state_dtype="int16")}
    rng = np.random.default_rng([args.seed, 2])
    bank = ScoreBank(SWConfig(), backend="pallas", device="cuda")
    name, n_reads, (lo, hi), qlen = F_CASE
    db = make_db(rng, n_reads, lo, hi)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    for q, t in column_batches(bank, query, db):
        for mode, kw in modes.items():
            row(f"(f) bucket {t.shape[1]}", mode, q, t, **kw)
    name, n_pairs, (lo, hi), width = H_CASE
    queries, targets = make_pairs(rng, n_pairs, lo, hi)
    wbank = ScoreBank(SWConfig(score_width=width), device="cuda")
    for b in wbank._pair_batches(queries, targets):
        if b.q.shape[1] <= col.QUERY_TILE:
            q, t = col.pad_column_batch(torch.from_numpy(b.q).cuda(),
                                        torch.from_numpy(b.t).cuda(), col.T_CHUNK)
            row(f"(h) group {q.shape[1]} x {t.shape[1]}", f"W={width}", q, t,
                score_width=width)
    shoot = np.random.default_rng(args.seed)
    q = torch.from_numpy(shoot.integers(0, 4, (65536, 128)).astype(np.int8)).cuda()
    t = torch.from_numpy(shoot.integers(0, 4, (65536, 128)).astype(np.int8)).cuda()
    row("shootout", "int32", q, t)
    for m in (32, 128, 256):
        q, t = (torch.from_numpy(x).cuda()
                for x in gaps.long_gap_pairs(np.random.default_rng([args.seed, m]), 4096, m))
        row(f"long gaps m={m}", "int32", q, t)
    g_name, g_n, (g_lo, g_hi), g_q = LONG_CASES[1]
    g_db = make_db(rng, g_n, g_lo, g_hi)
    g_query = rng.integers(0, 4, size=g_q).astype(np.int8)
    (gq, gt), = column_batches(bank, g_query, g_db)
    _, tiles = run_column_chain(gq, gt, None, col.column_chained_cuda)
    for p, (a, outs) in enumerate(tiles):
        fn = lambda: col.column_chained_cuda(*a)  # noqa: E731
        print(f"{tag} (g) B5 tile {p} int32 [{gq.shape[0]} pairs, {gt.shape[1]} columns] | "
              f"wrapper {cuda_ms(fn, args.reps):.4f} ms, device {device_ms(fn, args.reps):.4f} "
              f"ms | h {digest(outs[0])}", flush=True)
    for label, kw in modes.items():
        parts = []
        for m in (8, 16, 32, 64, 128, 256):
            regs, spill, blocks = col.column_kernel_info(m, **kw)
            parts.append(f"m={m}: {regs} registers, {spill} spill bytes, {blocks} blocks an SM")
        print(f"{tag} B4 {label} | " + "; ".join(parts), flush=True)
    regs, spill, blocks = col.column_kernel_info(tile=True)
    print(f"{tag} B5 tile int32 | {regs} registers, {spill} spill bytes, {blocks} blocks an SM",
          flush=True)
    f_wall, f_walls = wall_ms(lambda: bank.score_database(query, db), args.walls)
    h_wall, h_walls = wall_ms(lambda: wbank.score_pairs(queries, targets), args.walls)
    print(f"{tag} walls | (f) score_database {f_wall:.2f} ms (runs "
          f"{', '.join(f'{w:.2f}' for w in f_walls)}); (h) score_pairs W={width} "
          f"{h_wall:.2f} ms (runs {', '.join(f'{w:.2f}' for w in h_walls)}); scores "
          f"{digest(torch.from_numpy(bank.score_database(query, db).scores))} "
          f"{digest(torch.from_numpy(wbank.score_pairs(queries, targets).scores))}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

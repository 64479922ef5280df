"""B4 and B5, the column kernels, at the main path's shapes, timed so
that two trees compare in one call.

    python experiments/torch_column_b4.py [--root DIR] [--tag NAME] [--reps N] [--only b5]

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
  - B5 on (g)'s two tiles in int32, float32 and W = 12; on (q)'s 16
    tiles (chip_smoke.py's LADDER_Q: a 4,095-base query against 65,536
    reads of 128, [65,536 pairs, 4,096 x 128]) in int32; on (s)'s biased
    group (LADDER_S: 16 queries of 2,049-4,095 x 64 targets of 513-2,048
    at W = 12, [1,024 pairs, 4,096 x 2,048]); each tile timed, the median
    tile and the chain (_chained_call) too;
  - B5 on (s)'s shape without its windows (the random pairs alone: a
    grid of one wave takes its slowest warp's time);
  - the wall of (s)'s score_pairs on the column path, at W = 12;
  - the walls of (f)'s score_database and (h)'s score_pairs, median of
    --walls warm calls;
  - the registers, spill bytes and resident blocks an SM of B4's
    instantiation at query widths 8-256 in each state, and of B5's in each
    one-value state.
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
    ap.add_argument("--only", choices=("b5",), help="b5: the B5 rows and (s)'s wall alone")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)  # the kernels build under the checkout's own build/
    import numpy as np
    import torch
    from chip_smoke import (
        F_CASE, H_CASE, LADDER_Q, LADDER_S, LADDER_WIDTH, LONG_CASES, column_batches,
        make_db, make_pairs, query_pairs, run_column_chain,
    )
    from swtpu_torch import DEFAULT_PENALTIES, SWConfig, ScoreBank
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
    b4 = args.only is None
    for q, t in column_batches(bank, query, db) if b4 else ():
        for mode, kw in modes.items():
            row(f"(f) bucket {t.shape[1]}", mode, q, t, **kw)
    name, n_pairs, (lo, hi), width = H_CASE
    queries, targets = make_pairs(rng, n_pairs, lo, hi)
    wbank = ScoreBank(SWConfig(score_width=width), device="cuda")
    for b in wbank._pair_batches(queries, targets) if b4 else ():
        if b.q.shape[1] <= col.QUERY_TILE:
            q, t = col.pad_column_batch(torch.from_numpy(b.q).cuda(),
                                        torch.from_numpy(b.t).cuda(), col.T_CHUNK)
            row(f"(h) group {q.shape[1]} x {t.shape[1]}", f"W={width}", q, t,
                score_width=width)
    if b4:
        shoot = np.random.default_rng(args.seed)
        q = torch.from_numpy(shoot.integers(0, 4, (65536, 128)).astype(np.int8)).cuda()
        t = torch.from_numpy(shoot.integers(0, 4, (65536, 128)).astype(np.int8)).cuda()
        row("shootout", "int32", q, t)
        for m in (32, 128, 256):
            q, t = (torch.from_numpy(x).cuda() for x in
                    gaps.long_gap_pairs(np.random.default_rng([args.seed, m]), 4096, m))
            row(f"long gaps m={m}", "int32", q, t)
    def b5_rows(case, q, t, width=None, dtype="int32"):
        """Every tile of q's chain through B5: its times, the median tile's
        and the chain's, and a digest of every tile's h/ms/is."""
        _, tiles = run_column_chain(q, t, width, col.column_chained_cuda, dtype)
        mode = dtype if width is None else f"W={width}"
        (B, m), n = q.shape, t.shape[1]
        devs = []
        for p, (a, outs) in enumerate(tiles):
            fn = lambda: col.column_chained_cuda(*a)  # noqa: E731
            devs.append(device_ms(fn, args.reps))
            if len(tiles) <= 2:
                print(f"{tag} {case} B5 tile {p} {mode} [{B} pairs, {n} columns] | wrapper "
                      f"{cuda_ms(fn, args.reps):.4f} ms, device {devs[-1]:.4f} ms | h "
                      f"{digest(outs[0])}", flush=True)
        chain = cuda_ms(lambda: col._chained_call(q, t, DEFAULT_PENALTIES, width,
                                                  state_dtype=dtype), args.reps)
        outs = torch.cat([o[0] for _, o in tiles] + [x.reshape(-1) for x in tiles[-1][1]])
        print(f"{tag} {case} B5 {mode} [{B} pairs, {m} x {n}, {len(tiles)} tiles] | device a "
              f"tile median {statistics.median(devs):.4f} ms (tiles "
              f"{', '.join(f'{x:.4f}' for x in devs)}), chain {chain:.4f} ms | every h and "
              f"the last tile's h/ms/is {digest(outs)}", flush=True)
        del tiles, outs

    g_name, g_n, (g_lo, g_hi), g_q = LONG_CASES[1]
    g_db = make_db(rng, g_n, g_lo, g_hi)
    g_query = rng.integers(0, 4, size=g_q).astype(np.int8)
    (gq, gt), = column_batches(bank, g_query, g_db)
    for width, dtype in ((None, "int32"), (None, "float32"), (12, "int32")):
        b5_rows("(g)", gq, gt, width, dtype)
    del gq, gt
    lrng = np.random.default_rng([args.seed, 10])
    _, q_reads, q_len, q_qlen, _ = LADDER_Q
    q_db = make_db(lrng, q_reads, q_len, q_len)
    q_query = lrng.integers(0, 4, size=q_qlen).astype(np.int8)
    (qq, qt), = column_batches(bank, q_query, q_db)
    b5_rows("(q)", qq, qt)
    del qq, qt, q_db
    _, nq, per, qr, tr, self_every, least = LADDER_S
    s_queries, s_targets = query_pairs(lrng, nq, per, qr, tr, self_every, (least, tr[1]))
    s_bank = ScoreBank(SWConfig(score_width=LADDER_WIDTH), device="cuda")
    sg = max(s_bank._pair_batches(s_queries, s_targets),
             key=lambda g: g.q.shape[0] * g.t.shape[1])
    sq, st = col.pad_column_batch(torch.from_numpy(sg.q).cuda(),
                                  torch.from_numpy(sg.t).cuda(), col.T_CHUNK)
    b5_rows("(s)", sq, st, LADDER_WIDTH)
    del sq, st
    # (s)'s shape without its windows (self_every 0): the random pairs' cost
    # alone, since one slow warp sets a grid of one wave's time
    plain_q, plain_t = query_pairs(np.random.default_rng([args.seed, 11]), nq, per, qr, tr)
    pg = max(s_bank._pair_batches(plain_q, plain_t), key=lambda g: g.q.shape[0] * g.t.shape[1])
    sq, st = col.pad_column_batch(torch.from_numpy(pg.q).cuda(),
                                  torch.from_numpy(pg.t).cuda(), col.T_CHUNK)
    b5_rows("(s) without windows", sq, st, LADDER_WIDTH)
    del sq, st
    for label, kw in modes.items() if b4 else ():
        parts = []
        for m in (8, 16, 32, 64, 128, 256):
            regs, spill, blocks = col.column_kernel_info(m, **kw)
            parts.append(f"m={m}: {regs} registers, {spill} spill bytes, {blocks} blocks an SM")
        print(f"{tag} B4 {label} | " + "; ".join(parts), flush=True)
    for label, kw in (("int32", {}), ("float32", dict(state_dtype="float32")),
                      ("W=12", dict(score_width=12))):
        regs, spill, blocks = col.column_kernel_info(tile=True, **kw)
        print(f"{tag} B5 tile {label} | {regs} registers, {spill} spill bytes, {blocks} "
              "blocks an SM", flush=True)
    s_wall, s_walls = wall_ms(lambda: s_bank.score_pairs(s_queries, s_targets), args.walls)
    print(f"{tag} walls | (s) score_pairs column W={LADDER_WIDTH} {s_wall:.2f} ms (runs "
          f"{', '.join(f'{w:.2f}' for w in s_walls)}); scores "
          f"{digest(torch.from_numpy(s_bank.score_pairs(s_queries, s_targets).scores))}",
          flush=True)
    if not b4:
        return 0
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

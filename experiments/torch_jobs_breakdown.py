"""The chunked stream dispatch against the one-shot call, on one CUDA GPU.

    python experiments/torch_jobs_breakdown.py [--seed N] [--reps N] [--against FILE]

At chip_smoke.py's cases (a) (262,144 reads x 128, a 128-base query) and
(b) (262,144 reads of 24-256 bases, a 32-base query), data from --seed,
chunks of 65,536 and 100,000 reads as chip_smoke.py's phase "jobs" takes
them:
  - --reps warm calls of each variant in turns (the order rotates every
    round): the one-shot call, the chunked one and, with --against, the
    one-shot call of another version of ``swtpu_torch/bank/scorebank.py``
    (for example an earlier commit's, from ``git show``), loaded beside
    this tree's package.  Each call's wall and its host stages, timed in
    that same call by wrapping scorebank's module names: pack_streams,
    pack_stream_wire, the copy to the device ("stage": the pinned staging,
    or "_put": pageable copies), the dispatch of each chunk's ops, and the
    rest (the wait for the scores, bookkeeping).  Medians of each.
  - then 5 consecutive warm calls of each variant, and their median wall,
    to set beside the walls in turns.
Prints the card's name and power limit first; every number is this run's.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CASES = ((0, 65536), (1, 100000))  # (chip_smoke.MAIN_CASES index, chunk reads)
STAGED = ("pack_streams", "pack_stream_wire", "_put", "sw_scores_stream_packed")


def load_against(path):
    """The ScoreBank module of another scorebank.py, importing the rest of
    swtpu_torch from this tree."""
    spec = importlib.util.spec_from_file_location("swtpu_torch.bank._against", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def wrap_stages(mods, acc):
    """Wrap each module's STAGED names and its _PinnedStager.put (as
    "stage") so that each call adds its host seconds to acc[name];
    returns the undo."""
    undo = []

    def timed(fn, name):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            acc[name] += time.perf_counter() - t0
            return out
        return wrapped

    for mod in mods:
        for name in STAGED:
            real = getattr(mod, name)
            setattr(mod, name, timed(real, name))
            undo.append((mod, name, real))
        real = mod._PinnedStager.put
        mod._PinnedStager.put = timed(real, "stage")
        undo.append((mod._PinnedStager, "put", real))

    def restore():
        for obj, name, real in undo:
            setattr(obj, name, real)
    return restore


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("--against", default=None,
                    help="another scorebank.py, whose one-shot call is timed in turns")
    args = ap.parse_args()
    import numpy as np
    import chip_smoke as cs
    from swtpu_torch import SWConfig, ScoreBank
    from swtpu_torch.bank import scorebank as bank_mod

    card, _ = cs.phase_device()
    cs.phase_build()
    mods = [bank_mod]
    banks = {"one_shot": ScoreBank(device="cuda")}
    if args.against:
        mods.append(load_against(args.against))
        banks["one_shot_against"] = mods[-1].ScoreBank(device="cuda")
    rng = np.random.default_rng(args.seed)
    for index, chunk in CASES:
        name, n, (lo, hi), qlen = cs.MAIN_CASES[index]
        db = cs.make_db(rng, n, lo, hi)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        runs = dict(banks, chunked=ScoreBank(SWConfig(stream_chunk_reads=chunk), device="cuda"))
        want = runs["one_shot"].score_database(query, db).scores
        walls, stages = defaultdict(list), defaultdict(lambda: defaultdict(list))
        acc = defaultdict(float)
        restore = wrap_stages(mods, acc)
        try:
            order = list(runs)
            for rep in range(args.reps + 1):  # a warm round, then the timed ones
                for k in order[rep % len(order):] + order[: rep % len(order)]:
                    acc.clear()
                    t0 = time.perf_counter()
                    res = runs[k].score_database(query, db)
                    wall = (time.perf_counter() - t0) * 1e3
                    if not np.array_equal(res.scores, want):
                        raise SystemExit(f"{name} {k}: scores differ from the one-shot call's")
                    if rep:
                        walls[k].append(wall)
                        for s, v in acc.items():
                            stages[k][s].append(v * 1e3)
                        stages[k]["rest"].append(wall - sum(acc.values()) * 1e3)
        finally:
            restore()
        print(f"{name} chunks of {chunk}: warm walls in turns, median of {args.reps}: "
              + "; ".join(f"{k} {statistics.median(v):.2f} ms (runs "
                          f"{', '.join(f'{x:.1f}' for x in v)})" for k, v in walls.items())
              + f" on {card}", flush=True)
        for k, st in stages.items():
            print(f"{name} {k} host stages in those calls, median ms: "
                  + ", ".join(f"{s} {statistics.median(v):.2f}" for s, v in st.items())
                  + f"; wall {statistics.median(walls[k]):.2f}", flush=True)
        for k, bank in runs.items():
            bank.score_database(query, db)
            alone = []
            for _ in range(5):
                t0 = time.perf_counter()
                bank.score_database(query, db)
                alone.append((time.perf_counter() - t0) * 1e3)
            print(f"{name} {k}: 5 consecutive warm calls, median {statistics.median(alone):.2f} "
                  f"ms (runs {', '.join(f'{x:.1f}' for x in alone)})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the time of swtpu_torch's stream path goes, on one CUDA GPU.

    python experiments/torch_stream_breakdown.py [--seed N] [--reps N]
        [--sweeps stages,rows,phys,slices] [--slice-counts 1,2,...]

For each of chip_smoke.py's five main-path cases (its shapes, data from --seed):
  - per-stage host-clock medians of one ScoreBank.score_database call taken
    apart, with a device synchronise after each stage: pack, wire pack,
    H2D, unpack + layout, kernel, gather, D2H; for the long-query cases
    (d) and (e) the kernel stage is the sum over the K chained tiles and
    the boundary shifts between them are a stage of their own;
  - the device busy share of one whole call under torch.profiler (device
    time of kernels and copies / host wall time);
  - the kernel alone (CUDA events; for (d) and (e) the whole chain) over
    rows 1-16 at ScoreBank's segments (also in one slice), over 512-4096
    physical streams at ScoreBank's rows, and over the kernel's time
    slices a stream at ScoreBank's geometry (the wrapper's choice marked).
Then chip_smoke.py's pair case (i) (its shapes, data of its own from
--seed): the stages of one ScoreBank.score_pairs call on the stream
backend taken apart in the same way (dedupe and chunking, pack_pair_streams,
H2D, layout, kernel, gather, D2H, summed over the call's wavefront calls),
the share of the wall the pair packer takes, and the busy share.
--sweeps picks which of these run (stages: the per-stage medians and the
busy share; pairs: case (i)'s).  Prints the card's name and power limit
first; every number is this run's.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

STAGES = ("pack", "wire", "h2d", "unpack+layout", "kernel", "gather", "d2h", "total")
LONG_STAGES = (
    "pack", "wire", "h2d", "unpack+layout", "kernel", "shift", "gather", "d2h", "total",
)


def stages_ms(bank, query, db, reps):
    """Median ms of each stage of the CUDA stream path over `reps` warm runs."""
    import numpy as np
    import torch
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.bank.streams import pack_stream_wire, pack_streams
    from swtpu_torch.ops.stream import (
        _gather_emissions, _to_kernel_layout, stream_strip_cuda, unpack_stream_wire,
    )

    seg, rows, phys = stream_geometry(len(query), bank.config, bank.device)
    pen = bank.config.penalties

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(bank.device)

    parts = {k: [] for k in STAGES}
    for rep in range(reps + 1):  # the first run warms up
        t = [time.perf_counter()]
        b = pack_streams(query, db.mat, n_streams=phys * seg, segments=seg,
                         lens=db.lens, rows=rows)
        t.append(time.perf_counter())
        codes, flags = pack_stream_wire(b.stream)
        t.append(time.perf_counter())
        q, c, f = put(b.q), put(codes), put(flags)
        es, ep = put(b.emit_stream), put(b.emit_step.astype(np.int32))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        qk, sk = _to_kernel_layout(q, unpack_stream_wire(c, f), seg, rows)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        strip = stream_strip_cuda(qk, sk, pen, seg, rows)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        scores = _gather_emissions(strip, es, ep, regular=b.emit_regular)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        scores.cpu().numpy()
        t.append(time.perf_counter())
        if rep:
            for k, a, z in zip(STAGES, t, t[1:]):
                parts[k].append((z - a) * 1e3)
            parts["total"].append((t[-1] - t[0]) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}, tuple(sk.shape)


def long_stages_ms(bank, query, db, reps):
    """Median ms of each stage of the CUDA long-query path over `reps` warm
    runs; the kernel and shift stages sum over the chain's tiles."""
    import numpy as np
    import torch
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.bank.streams import pack_stream_wire, pack_streams_long
    from swtpu_torch.ops.stream import (
        LANES, _gather_emissions, _q_kernel_layout, _shift_steps,
        stream_chained_cuda, unpack_stream_wire,
    )

    _, rows, phys = stream_geometry(len(query), bank.config, bank.device)
    pen = bank.config.penalties
    SL = LANES // rows

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(bank.device)

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    parts = {k: [] for k in LONG_STAGES}
    for rep in range(reps + 1):  # the first run warms up
        # (stage, time at its end); the chain's own stages are summed apart
        marks = [("start", time.perf_counter())]
        b = pack_streams_long(query, db.mat, n_streams=phys, rows=rows, lens=db.lens)
        marks.append(("pack", time.perf_counter()))
        codes, flags = pack_stream_wire(b.stream)
        marks.append(("wire", time.perf_counter()))
        q, c, f = put(b.q), put(codes), put(flags)
        es, ep = put(b.emit_stream), put(b.emit_step.astype(np.int32))
        marks.append(("h2d", clock()))
        sk = unpack_stream_wire(c, f).t().contiguous()
        K = q.shape[1] // LANES
        qks = [_q_kernel_layout(q[:, p * LANES : (p + 1) * LANES], 1, rows)
               .to(torch.int8).contiguous() for p in range(K)]
        marks.append(("unpack+layout", clock()))
        kernel = shift = 0.0
        bD = bG = bH = torch.zeros(tuple(sk.shape), dtype=torch.int32, device=sk.device)
        for p in range(K):
            t0 = clock()
            acc, oD, oG, oH = stream_chained_cuda(qks[p], sk, bD, bG, bH, pen, rows)
            t1 = clock()
            if p + 1 < K:
                bD = _shift_steps(oD, SL - 2)
                bG = _shift_steps(oG, SL - 1)
                bH = _shift_steps(oH, SL - 1)
            del oD, oG, oH
            kernel += t1 - t0
            shift += clock() - t1
        marks.append(("chain", clock()))
        scores = _gather_emissions(acc, es, ep, regular=b.emit_regular)
        marks.append(("gather", clock()))
        scores.cpu().numpy()
        marks.append(("d2h", time.perf_counter()))
        if rep:
            for (_, a), (k, z) in zip(marks, marks[1:]):
                if k in parts:
                    parts[k].append((z - a) * 1e3)
            parts["kernel"].append(kernel * 1e3)
            parts["shift"].append(shift * 1e3)
            parts["total"].append((marks[-1][1] - marks[0][1]) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}, tuple(sk.shape)


PAIR_STAGES = ("dedupe", "pack", "h2d", "layout", "kernel", "gather", "d2h", "total")


def pair_stages_ms(bank, queries, targets, reps):
    """Median ms of each stage of the CUDA pair-stream path over `reps`
    warm runs, each stage summed over the call's wavefront calls; and the
    number of those calls.  The stages are a copy of
    ScoreBank._score_pairs_stream's pipeline taken apart (exact int32 state,
    no verify_integrity checks), so it must follow that method when it
    changes."""
    import numpy as np
    import torch
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.bank.streams import batch_to_device, dedupe_queries, pack_pair_streams
    from swtpu_torch.ops.stream import _gather_emissions, _to_kernel_layout, stream_strip_cuda

    seg, rows, phys = stream_geometry(max(len(q) for q in queries), bank.config, bank.device)
    S = phys * seg
    pen = bank.config.penalties
    parts = {k: [] for k in PAIR_STAGES}
    for rep in range(reps + 1):  # the first run warms up
        acc = dict.fromkeys(PAIR_STAGES, 0.0)
        t0 = time.perf_counter()
        qlist, uid = dedupe_queries(queries)
        groups = [[] for _ in qlist]
        for i, u in enumerate(uid):
            groups[u].append(i)
        chunks = [groups[i : i + S] for i in range(0, len(groups), S)]
        acc["dedupe"] = time.perf_counter() - t0
        for chunk in chunks:
            idxs = [i for g in chunk for i in g]
            t = [time.perf_counter()]
            b = pack_pair_streams([queries[i] for i in idxs], [targets[i] for i in idxs],
                                  n_streams=S, segments=seg, rows=rows)
            t.append(time.perf_counter())
            d = batch_to_device(b, bank.device)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            qk, sk = _to_kernel_layout(d.q, d.stream, seg, rows)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            strip = stream_strip_cuda(qk, sk, pen, seg, rows)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            s = _gather_emissions(strip, d.emit_stream, d.emit_step, regular=b.emit_regular)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            np.asarray(s.cpu())
            t.append(time.perf_counter())
            for k, a, z in zip(PAIR_STAGES[1:], t, t[1:]):
                acc[k] += z - a
        acc["total"] = time.perf_counter() - t0
        if rep:
            for k, v in acc.items():
                parts[k].append(v * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}, len(chunks)


def busy_share(bank, query, db, run=None):
    """(device ms of kernels and copies, host wall ms) of one profiled
    call: bank.score_database(query, db), or run()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run() if run else bank.score_database(query, db)
        wall = time.perf_counter() - t0
    dev_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return dev_us / 1e3, wall * 1e3


def kernel_gcups(query, db, seg, rows, phys, slices=None):
    """(T, ms, GCUPS) of the kernel alone at `slices` (None: the
    wrapper's choice); a long query's whole chain."""
    from functools import partial

    from chip_smoke import laid_out_batch, long_batch
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import _long_strip, stream_chained_cuda, stream_strip_cuda
    from swtpu_torch.utils.timing import cuda_ms

    if len(query) > 128:
        q, sk = long_batch(query, db, rows, phys)
        tile = partial(stream_chained_cuda, slices=slices)
        ms = cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows, tile=tile), 3)
    else:
        qk, sk = laid_out_batch(query, db, seg, rows, phys)
        ms = cuda_ms(lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows,
                                               slices=slices), 3)
    cells = len(query) * int(db.lens.sum())
    return sk.shape[0], ms, cells / ms / 1e6


SLICE_SWEEP = (1, 2, 4, 8, 12, 16, 20, 24, 32, 48, 64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sweeps", default="stages,rows,phys,slices,pairs",
                    help="comma list of stages, rows, phys, slices, pairs")
    ap.add_argument("--slice-counts", default=",".join(map(str, SLICE_SWEEP)),
                    help="slice counts of the slices sweep (the wrapper's choice is added)")
    args = ap.parse_args()
    sweeps = set(args.sweeps.split(","))
    slice_counts = [int(c) for c in args.slice_counts.split(",")]
    import subprocess

    import numpy as np
    import torch
    from chip_smoke import I_CASE, LONG_CASES, MAIN_CASES, make_db, query_pairs
    from swtpu_torch import SWConfig, ScoreBank
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.ops.stream import (
        STEP_CHUNK, choose_slices, slice_steps, stream_kernel_info,
    )

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false")
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    rng = np.random.default_rng(args.seed)
    rng_long = np.random.default_rng([args.seed, 1])
    bank = ScoreBank(SWConfig(), device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(rng, c) for c in MAIN_CASES] + [(rng_long, c) for c in LONG_CASES]
    for gen, (name, n, (lo, hi), qlen) in cases:
        db = make_db(gen, n, lo, hi)
        query = gen.integers(0, 4, size=qlen).astype(np.int8)
        seg, rows, phys = stream_geometry(qlen, bank.config, bank.device)
        if "stages" in sweeps:
            stages = long_stages_ms if qlen > 128 else stages_ms
            med, shape = stages(bank, query, db, args.reps)
            print(f"{name} strip {list(shape)} medians of {args.reps}: "
                  + " ".join(f"{k}={v:.2f}ms" for k, v in med.items()), flush=True)
            dev_ms, wall_ms = busy_share(bank, query, db)
            print(f"{name} profiled call: device {dev_ms:.2f} ms of wall "
                  f"{wall_ms:.2f} ms = {dev_ms / wall_ms:.1%} busy", flush=True)
        for r in (1, 2, 4, 8, 16) if "rows" in sweeps else ():
            if (128 // r) % seg == 0:
                T, ms, g = kernel_gcups(query, db, seg, r, phys)
                ms_one = kernel_gcups(query, db, seg, r, phys, 1)[1]
                print(f"  rows sweep {name} seg={seg} rows={r} phys={phys} T={T} "
                      f"kernel {ms:.3f} ms -> {g:.1f} GCUPS (one slice {ms_one:.3f} ms)",
                      flush=True)
        for p in (512, 1024, 2048, 4096) if "phys" in sweeps else ():
            T, ms, g = kernel_gcups(query, db, seg, rows, p)
            print(f"  phys sweep {name} seg={seg} rows={rows} phys={p} "
                  f"T={T} kernel {ms:.3f} ms -> {g:.1f} GCUPS", flush=True)
        if "slices" in sweeps:
            T = kernel_gcups(query, db, seg, rows, phys, 1)[0]
            chosen = choose_slices(phys, rows, T, sms, seg)
            regs, local, blocks = stream_kernel_info(rows, chained=qlen > 128)
            print(f"  {name} kernel rows={rows}: {regs} registers, {local} local "
                  f"bytes, {blocks} resident blocks an SM", flush=True)
            for c in sorted({c for c in slice_counts if c * STEP_CHUNK <= T} | {chosen}):
                T, ms, g = kernel_gcups(query, db, seg, rows, phys, c)
                print(f"  slices sweep {name} seg={seg} rows={rows} phys={phys} T={T} "
                      f"slices={c}{' (chosen)' if c == chosen else ''} "
                      f"({slice_steps(T, c)} steps) kernel {ms:.3f} ms -> {g:.1f} GCUPS",
                      flush=True)
    if "pairs" in sweeps:
        name, nq, per, qr, tr, _ = I_CASE
        queries, targets = query_pairs(np.random.default_rng([args.seed, 6]), nq, per, qr, tr)
        med, calls = pair_stages_ms(bank, queries, targets, args.reps)
        walls = []
        for _ in range(args.reps + 1):
            t0 = time.perf_counter()
            bank.score_pairs(queries, targets)
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls[1:])
        print(f"{name} {len(queries)} pairs, {calls} wavefront calls, medians of {args.reps}: "
              + " ".join(f"{k}={v:.2f}ms" for k, v in med.items())
              + f" | pack_pair_streams {med['pack'] / med['total']:.1%} of the staged total; "
              f"score_pairs wall {wall:.2f} ms", flush=True)
        dev_ms, wall_ms = busy_share(bank, None, None,
                                     lambda: bank.score_pairs(queries, targets))
        print(f"{name} profiled call: device {dev_ms:.2f} ms of wall {wall_ms:.2f} ms = "
              f"{dev_ms / wall_ms:.1%} busy", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Drive the swtpu_torch port's main path once on one CUDA GPU.

    python chip_smoke.py [--seed N]

Phases, each reported on its own line; any failure exits non-zero:
  1. device: a CUDA device is required; prints the card's name and power
     limit (nvidia-smi), torch's CUDA version and nvcc's version;
  2. build: compiles the wavefront kernels from swtpu_torch/ops/csrc;
  3. kernel vs plain: each CUDA kernel's strips must equal the plain
     PyTorch version's bit for bit at 512 physical streams: the wavefront
     for every (segments, rows) that ScoreBank uses on CUDA and for
     rows=1, its ripple-H form at segments 1 and 4, and the chained tile
     over whole K-tile chains (K=2 at rows 16 and 1, K=4 at rows 16);
  4. main path: ScoreBank(device="cuda").score_database on five
     databases made from --seed: (a)-(c) short queries (the bench.py
     headline shape, a ragged short-query set and a mid-length set), then
     (d) and (e) long queries (a 256-base query against ragged reads, a
     512-base one against 128-base reads); a sample of 2048 reads and the
     top-10 reads must carry the oracle's scores, the wavefront kernel's
     launch counter must rise in every short case and the chained
     kernel's by K tiles per call in every long case;
  5. kernel vs plain at the main path's shapes: each short case's batch,
     at the geometry ScoreBank chose for it, through both; the full strips
     must be bit-equal (the plain version takes about two minutes on case
     (a)).  Each long case's chain runs through the kernel at full length,
     and every tile is held against the plain version on the first 4096
     steps (see phase_chained_at_main_shape).
The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches, error and times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOLERANCE = 0  # integer strips and scores: bit-equal
CHECK_STEPS = 4096  # steps of each long-case tile held against the plain version
STRIPS = ("acc", "oD", "oG", "oH")  # a chained tile's outputs


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_once(fn):
    """(fn(), its device time in ms) for one call, no warm-up: for the
    plain version, whose one call at a main-path shape takes minutes."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def strip_error(label, got, want) -> int:
    """Largest |kernel - plain| over the strip; fails above TOLERANCE."""
    err = int((got.long() - want.long()).abs().max())
    if err > TOLERANCE:
        bad = (got != want).nonzero()
        t, n = (int(x) for x in bad[0])
        fail(f"kernel vs plain {label}: {len(bad)} strip cells differ, first "
             f"[t={t}, n={n}] kernel {int(got[t, n])} plain {int(want[t, n])}")
    return err


def laid_out_batch(query, db, segments, rows, phys):
    """A case's batch packed as ScoreBank packs it, on the card in the
    kernel layout, with the raw stream: the 2-bit wire turns pads into 0,
    which changes the strip past each stream's last read but no score."""
    import torch
    from swtpu_torch.bank.streams import pack_streams
    from swtpu_torch.ops.stream import _to_kernel_layout

    b = pack_streams(query, db.mat, n_streams=phys * segments,
                     segments=segments, lens=db.lens, rows=rows)
    return _to_kernel_layout(
        torch.from_numpy(b.q).cuda(), torch.from_numpy(b.stream).cuda(),
        segments, rows,
    )


def long_batch(query, db, rows, phys):
    """A long case's batch packed as ScoreBank packs it, on the card: q
    [N, K*128] int8 and the raw stream in the kernel layout [T, N]."""
    import torch
    from swtpu_torch.bank.streams import pack_streams_long

    b = pack_streams_long(query, db.mat, n_streams=phys, rows=rows, lens=db.lens)
    return torch.from_numpy(b.q).cuda(), torch.from_numpy(b.stream.T.copy()).cuda()


def run_chain(q, sk, rows, tile):
    """The long-query chain (``_long_strip``) with `tile` running each
    tile; returns its last accumulator strip and every tile's (inputs,
    outputs)."""
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import _long_strip

    tiles = []

    def record(*args):
        outs = tile(*args)
        tiles.append((args, outs))
        return outs

    return _long_strip(q, sk, DEFAULT_PENALTIES, rows, tile=record), tiles


def make_db(rng, n, lo, hi):
    """EncodedDB of n random reads with lengths in [lo, hi], pad code 4."""
    import numpy as np
    from swtpu_torch.bank.scorebank import EncodedDB

    lens = rng.integers(lo, hi + 1, size=n, dtype=np.int32)
    mat = rng.integers(0, 4, size=(n, hi), dtype=np.int8)
    mat[np.arange(hi)[None, :] >= lens[:, None]] = 4
    return EncodedDB([f"db{i}" for i in range(n)], mat, lens)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    if not (REPO / "swtpu_torch").is_dir():
        fail(f"no swtpu_torch package beside {Path(__file__).name}: run it "
             "from a checkout of the repository")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = subprocess.run(
        [str(Path(CUDA_HOME or "") / "bin" / "nvcc"), "--version"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    print(f"phase device: ok {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | nvcc "
          f"{nvcc[-1] if nvcc else 'not found'}")
    return card


def phase_build():
    from swtpu_torch.ops._build import build_log_path, library_path, load_library

    t0 = time.perf_counter()
    load_library()
    dt = time.perf_counter() - t0
    print(f"phase build: ok {dt:.2f} s -> {library_path().name}")
    for line in build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernel_vs_plain(rng):
    """Strips of kernel and plain version on the same packed inputs."""
    import numpy as np
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import stream_strip_cuda, stream_strip_reference

    results = []
    for seg, rows in ((1, 16), (2, 8), (4, 4), (1, 1)):
        S = 512
        db = make_db(rng, S * seg * 10, 24, 256)  # T ~ 1.4k steps
        query = rng.integers(0, 4, size=128 // seg).astype(np.int8)
        qk, sk = laid_out_batch(query, db, seg, rows, S)
        got = stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows)
        want, plain_ms = cuda_once(
            lambda: stream_strip_reference(qk, sk, DEFAULT_PENALTIES, seg, rows)
        )
        err = strip_error(f"seg={seg} rows={rows}", got, want)
        ms = cuda_ms(lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows), 10)
        T, N = sk.shape
        print(f"phase kernel_vs_plain: ok seg={seg} rows={rows} strip [{T}, {N}] "
              f"bit-equal | kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
        results.append(dict(segments=seg, rows=rows, T=T, N=N, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms))
    return results


def phase_ripple_vs_plain(rng):
    """The wavefront's ripple-H form (rows 1) against its plain version."""
    import numpy as np
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import stream_strip_cuda, stream_strip_reference

    results = []
    for seg in (1, 4):
        S = 512
        db = make_db(rng, S * seg * 10, 24, 256)
        query = rng.integers(0, 4, size=128 // seg).astype(np.int8)
        qk, sk = laid_out_batch(query, db, seg, 1, S)
        args = (qk, sk, DEFAULT_PENALTIES, seg, 1, False)
        got = stream_strip_cuda(*args)
        want, plain_ms = cuda_once(lambda: stream_strip_reference(*args))
        err = strip_error(f"ripple-H seg={seg}", got, want)
        ms = cuda_ms(lambda: stream_strip_cuda(*args), 10)
        T, N = sk.shape
        print(f"phase kernel_vs_plain: ok ripple-H seg={seg} rows=1 strip [{T}, {N}] "
              f"bit-equal | kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
        results.append(dict(form="ripple-H", segments=seg, rows=1, T=T, N=N,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms))
    return results


CHAIN_CHECKS = ((2, 16), (2, 1), (4, 16))  # (tiles K, rows)


def phase_chained_vs_plain(rng):
    """Whole K-tile chains through the chained kernel and through its
    plain version: the last accumulator strip and all four strips of
    every tile must be bit-equal."""
    import numpy as np
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import (
        _long_strip, stream_chained_cuda, stream_chained_reference,
    )

    results = []
    for K, rows in CHAIN_CHECKS:
        S = 512
        db = make_db(rng, S * 10, 24, 256)  # T ~ 1.5k steps
        query = rng.integers(0, 4, size=128 * K).astype(np.int8)
        q, sk = long_batch(query, db, rows, S)
        acc, tiles = run_chain(q, sk, rows, stream_chained_cuda)
        (want, want_tiles), plain_ms = cuda_once(
            lambda: run_chain(q, sk, rows, stream_chained_reference)
        )
        label = f"chain K={K} rows={rows}"
        err = strip_error(f"{label} last acc", acc, want)
        for p, ((_, outs), (_, wouts)) in enumerate(zip(tiles, want_tiles)):
            for name, g, w in zip(STRIPS, outs, wouts):
                err = max(err, strip_error(f"{label} tile {p} {name}", g, w))
        ms = cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows), 5)
        tile_ms = cuda_ms(lambda: stream_chained_cuda(*tiles[0][0]), 10)
        T, N = sk.shape
        print(f"phase kernel_vs_plain: ok {label} strips [{T}, {N}] bit-equal "
              f"(last acc + 4 per tile) | chain {ms:.4f} ms (kernel {tile_ms:.4f} "
              f"ms per tile), plain chain {plain_ms:.1f} ms")
        results.append(dict(tiles=K, rows=rows, T=T, N=N, max_abs_err=err,
                            ms=ms, tile_ms=tile_ms, plain_ms=plain_ms))
    return results


MAIN_CASES = (
    # (name, reads, read length range, query length): segments/rows follow
    ("a_equal128_q128", 262144, (128, 128), 128),  # seg 1, rows 16, regular
    ("b_ragged_q32", 262144, (24, 256), 32),  # seg 4, rows 4, scatter
    ("c_ragged_q64", 65536, (24, 256), 64),  # seg 2, rows 8
)
LONG_CASES = (
    # chained tiles: segments 1, rows 16, 512 physical streams, K = qlen/128
    ("d_ragged_q256", 262144, (24, 256), 256),  # the reference AFU's 256-PE query
    ("e_equal128_q512", 65536, (128, 128), 512),  # swtpu's long-query shape
)


def phase_main_path(rng, card, main_cases):
    import numpy as np
    import torch
    from swtpu_torch import SWConfig, ScoreBank, score_many_vs_one
    from swtpu_torch.ops.stream import stream_chained_cuda, stream_strip_cuda

    bank = ScoreBank(SWConfig(), device="cuda")
    cases = []
    for name, n, (lo, hi), qlen in main_cases:
        db = make_db(rng, n, lo, hi)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        K = -(-qlen // 128)
        wrapper = stream_chained_cuda if K > 1 else stream_strip_cuda
        before = wrapper.launches
        torch.cuda.reset_peak_memory_stats()
        res = bank.score_database(query, db)  # warm
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = bank.score_database(query, db)
            walls.append(time.perf_counter() - t0)
            if not np.array_equal(again.scores, res.scores):
                fail(f"{name}: scores differ between runs")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = wrapper.launches - before
        if K > 1 and launched != 4 * K:
            fail(f"{name}: chained kernel launched {launched} times in 4 runs "
                 f"of {K} tiles")
        if launched < 4:
            fail(f"{name}: wavefront kernel launched {launched} times in 4 runs")
        if res.scores.shape != (n,) or res.scores.dtype != np.int32:
            fail(f"{name}: scores {res.scores.shape} {res.scores.dtype}")
        sample = np.sort(rng.choice(n, size=2048, replace=False))
        want = score_many_vs_one(query, [db.read(i) for i in sample])
        if not np.array_equal(res.scores[sample], want):
            k = int(np.flatnonzero(res.scores[sample] != want)[0])
            fail(f"{name}: read {sample[k]} scored {res.scores[sample[k]]}, "
                 f"oracle {want[k]}")
        top = res.top_k(10)
        top_want = score_many_vs_one(query, [db.read(i) for _, i in top])
        if [s for s, _ in top] != top_want.tolist():
            fail(f"{name}: top-10 {top} vs oracle {top_want.tolist()}")
        wall = statistics.median(walls)
        gcups = res.cells / wall / 1e9
        print(f"phase main_path: ok {name} reads={n} query={qlen} tiles={K} "
              f"cells={res.cells} padded={res.padded_cells} launches={launched} "
              f"peak device memory {peak_gb:.2f} GB | sample 2048 + "
              f"top-10 = oracle | wall median of 3 {wall*1e3:.2f} ms "
              f"(runs {', '.join(f'{w*1e3:.2f}' for w in walls)}) -> "
              f"{gcups:.2f} GCUPS on {card}", flush=True)
        cases.append(dict(name=name, query=query, db=db, wall_s=wall,
                          gcups=gcups, cells=res.cells))
    return bank, cases


def phase_kernel_at_main_shape(bank, cases):
    """Kernel vs plain version, full strip, on each main-path case's own
    batch at the geometry ScoreBank chose for it; both times."""
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.ops.stream import stream_strip_cuda, stream_strip_reference

    results = []
    for c in cases:
        seg, rows, phys = stream_geometry(len(c["query"]), bank.config, bank.device)
        qk, sk = laid_out_batch(c["query"], c["db"], seg, rows, phys)
        got = stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows)
        want, plain_ms = cuda_once(
            lambda: stream_strip_reference(qk, sk, DEFAULT_PENALTIES, seg, rows)
        )
        err = strip_error(f"{c['name']} seg={seg} rows={rows}", got, want)
        del want
        ms = cuda_ms(lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows), 3)
        T, N = sk.shape
        print(f"phase kernel_main_shape: ok {c['name']} seg={seg} rows={rows} "
              f"strip [{T}, {N}] bit-equal | kernel {ms:.3f} ms -> "
              f"{c['cells'] / ms / 1e6:.2f} GCUPS in the kernel "
              f"({ms / (c['wall_s'] * 1e3):.1%} of the wall time), plain "
              f"{plain_ms:.1f} ms", flush=True)
        results.append(dict(name=c["name"], segments=seg, rows=rows, T=T, N=N,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms))
    return results


def phase_chained_at_main_shape(bank, cases):
    """Each long case's batch, at the geometry ScoreBank chose for it,
    through the kernel chain at full length (timed as the main path runs
    it).  Then every tile against the plain version on the first
    CHECK_STEPS steps of every stream: both get the same inputs, the
    stream rows and the kernel's own shifted boundary strips, cut to
    CHECK_STEPS rows.  A tile is causal in t (step t reads only steps
    <= t of its inputs), so the first CHECK_STEPS rows of its four output
    strips are exactly what the cut inputs give: the check is exact for
    those steps.  The plain version takes ~1.8 ms per step at rows 16, so
    the full length would take minutes per tile."""
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.ops.stream import (
        _long_strip, stream_chained_cuda, stream_chained_reference,
    )

    n = CHECK_STEPS
    results = []
    for c in cases:
        _, rows, phys = stream_geometry(len(c["query"]), bank.config, bank.device)
        q, sk = long_batch(c["query"], c["db"], rows, phys)
        _, tiles = run_chain(q, sk, rows, stream_chained_cuda)
        chain_ms = cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows), 3)
        full_ms = cuda_ms(lambda: stream_chained_cuda(*tiles[0][0]), 3)
        err, ms, plain_ms = 0, [], []
        for p, ((qk, _, bD, bG, bH, pen, r), outs) in enumerate(tiles):
            cut = [x[:n].contiguous() for x in (sk, bD, bG, bH)]
            want, t_plain = cuda_once(lambda: stream_chained_reference(qk, *cut, pen, r))
            for name, g, w in zip(STRIPS, outs, want):
                err = max(err, strip_error(f"{c['name']} tile {p} {name}", g[:n], w))
            ms.append(cuda_ms(lambda: stream_chained_cuda(qk, *cut, pen, r), 10))
            plain_ms.append(t_plain)
        del tiles
        T, N = sk.shape
        print(f"phase chained_main_shape: ok {c['name']} rows={rows} tiles={len(ms)} "
              f"strips [{T}, {N}] | chain {chain_ms:.3f} ms -> "
              f"{c['cells'] / chain_ms / 1e6:.2f} GCUPS in the chain "
              f"({chain_ms / (c['wall_s'] * 1e3):.1%} of the wall time), one tile "
              f"{full_ms:.3f} ms | first {n} steps of every tile bit-equal "
              f"(4 strips): kernel {', '.join(f'{x:.4f}' for x in ms)} ms, plain "
              f"{', '.join(f'{x:.1f}' for x in plain_ms)} ms per tile", flush=True)
        results.append(dict(name=c["name"], rows=rows, tiles=len(ms), T=T, N=N,
                            max_abs_err=err, chain_ms=chain_ms, tile_ms=full_ms,
                            check_steps=n, ms=ms, plain_ms=plain_ms))
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card = phase_device()
    import numpy as np
    import torch

    # the short cases draw from `rng` exactly as before the long path was
    # added; the long-path checks and cases have generators of their own
    rng = np.random.default_rng(args.seed)
    rng_long = np.random.default_rng([args.seed, 1])
    phase_build()
    checks = phase_kernel_vs_plain(rng)
    checks += phase_ripple_vs_plain(rng_long)
    chains = phase_chained_vs_plain(rng_long)
    from swtpu_torch.ops.stream import stream_chained_cuda, stream_strip_cuda

    stream_strip_cuda.launches = 0
    bank, cases = phase_main_path(rng, card, MAIN_CASES)
    launches = stream_strip_cuda.launches
    if launches == 0:
        fail("the main path never launched the wavefront kernel")
    stream_chained_cuda.launches = 0
    _, long_cases = phase_main_path(rng_long, card, LONG_CASES)
    chained_launches = stream_chained_cuda.launches
    if chained_launches == 0:
        fail("the long-query path never launched the chained kernel")
    mains = phase_kernel_at_main_shape(bank, cases)
    long_mains = phase_chained_at_main_shape(bank, long_cases)
    head = mains[0]  # case (a): the headline shape, segments 1, rows 16
    lhead = long_mains[0]  # case (d), tile 0 on its first CHECK_STEPS steps
    print(card)
    print(json.dumps({"kernels": [{
        "name": "stream_wavefront",
        "route": "cuda",
        "source": "swtpu_torch/ops/csrc/stream_wavefront.cu",
        "replaces": "swtpu/ops/pallas_stream.py:193",
        "also_replaces": "swtpu/ops/pallas_stream.py:57 (tail-accumulator "
                         "and ripple-H forms)",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks + mains),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "shape": [head["T"], head["N"]],
        "main_shapes": mains,
        "configs": checks,
    }, {
        "name": "stream_chained",
        "route": "cuda",
        "source": "swtpu_torch/ops/csrc/stream_wavefront.cu",
        "replaces": "swtpu/ops/pallas_stream.py:314",
        "launches": chained_launches,
        "max_abs_err": max(c["max_abs_err"] for c in chains + long_mains),
        "ms": lhead["ms"][0],
        "plain_ms": lhead["plain_ms"][0],
        "shape": [lhead["check_steps"], lhead["N"]],
        "main_shapes": long_mains,
        "configs": chains,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

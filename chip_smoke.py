#!/usr/bin/env python3
"""Drive the swtpu_torch port's main path once on one CUDA GPU.

    python chip_smoke.py [--seed N]

Phases, each reported on its own line; any failure exits non-zero:
  1. device: a CUDA device is required; prints the card's name and power
     limit (nvidia-smi), torch's CUDA version and nvcc's version;
  2. build: compiles the wavefront kernel from swtpu_torch/ops/csrc;
  3. kernel vs plain: the CUDA kernel's strip must equal the plain PyTorch
     version's bit for bit at 512 physical streams, for every
     (segments, rows) that ScoreBank uses on CUDA and for rows=1;
  4. main path: ScoreBank(device="cuda").score_database on three
     databases made from --seed (the bench.py headline shape, a ragged
     short-query set and a mid-length set); a sample of >= 2048 reads and
     the top-10 reads must carry the oracle's scores, and the kernel's
     launch counter must rise in every case;
  5. kernel vs plain at the main path's shapes: each case's batch, at the
     geometry ScoreBank chose for it, through both; the full strips must
     be bit-equal (the plain version takes about two minutes on case (a)).
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


MAIN_CASES = (
    # (name, reads, read length range, query length): segments/rows follow
    ("a_equal128_q128", 262144, (128, 128), 128),  # seg 1, rows 16, regular
    ("b_ragged_q32", 262144, (24, 256), 32),  # seg 4, rows 4, scatter
    ("c_ragged_q64", 65536, (24, 256), 64),  # seg 2, rows 8
)


def phase_main_path(rng, card):
    import numpy as np
    from swtpu_torch import SWConfig, ScoreBank, score_many_vs_one
    from swtpu_torch.ops.stream import stream_strip_cuda

    bank = ScoreBank(SWConfig(), device="cuda")
    cases = []
    for name, n, (lo, hi), qlen in MAIN_CASES:
        db = make_db(rng, n, lo, hi)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        before = stream_strip_cuda.launches
        res = bank.score_database(query, db)  # warm
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = bank.score_database(query, db)
            walls.append(time.perf_counter() - t0)
            if not np.array_equal(again.scores, res.scores):
                fail(f"{name}: scores differ between runs")
        launched = stream_strip_cuda.launches - before
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
        print(f"phase main_path: ok {name} reads={n} cells={res.cells} "
              f"padded={res.padded_cells} launches={launched} | sample 2048 + "
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card = phase_device()
    import numpy as np
    import torch

    rng = np.random.default_rng(args.seed)
    phase_build()
    checks = phase_kernel_vs_plain(rng)
    from swtpu_torch.ops.stream import stream_strip_cuda

    stream_strip_cuda.launches = 0
    bank, cases = phase_main_path(rng, card)
    launches = stream_strip_cuda.launches
    if launches == 0:
        fail("the main path never launched the wavefront kernel")
    mains = phase_kernel_at_main_shape(bank, cases)
    head = mains[0]  # case (a): the headline shape, segments 1, rows 16
    print(card)
    print(json.dumps({"kernels": [{
        "name": "stream_wavefront",
        "route": "cuda",
        "source": "swtpu_torch/ops/csrc/stream_wavefront.cu",
        "replaces": "swtpu/ops/pallas_stream.py:193",
        "also_replaces": "swtpu/ops/pallas_stream.py:57",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks + mains),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "shape": [head["T"], head["N"]],
        "main_shapes": mains,
        "configs": checks,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""reads/s scaling across mesh sizes and localhost processes: the
counterpart of swtpu's root ``bench_scaling.py``.

    python -m swtpu_torch.bench_scaling [--device cuda|cpu] [--multihost]

``main`` prints one JSON line per mesh size (1, 2, 4, ... up to the visible
GPUs; on ``--device cpu`` a mesh of the one CPU device) and, with more than
one size, the scaling efficiency against 80 % of linear.  On cuda each
shard runs ``make_sharded_stream_scorer`` (B1, k = 4) on 2,048 reads of 128
bases a device over 256 streams; on the CPU with one device the scan, 256
pairs a device.  SWTPU_SCALING_BACKEND (anything but ``stream``) takes the
bucketed path instead (the column kernels on cuda, the scan on the CPU).
With one GPU there is one row and no efficiency line (a mesh of shards that
repeat one device would measure the harness, not scaling).

``--multihost`` instead runs ``run_multihost`` at 1, 2 and 4 worker
processes on the device (joined over gloo), in pair mode and in database
mode, SWTPU_SCALING_PER_PROC (64) rows a process, and prints reads/s at
each count and the efficiency 1 -> 4.  Every worker of one card shares
it, and each pays its own process start and CUDA context, so that wall
measures process start more than scaling (swtpu's note says the same of
its CPU devices).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from swtpu_torch.bench import require_device

# reads a device and streams a shard, on the card and on the CPU (swtpu's
# on-TPU and CPU values)
PER_DEV = {"cuda": 2048, "cpu": 256}
N_STREAMS = {"cuda": 256, "cpu": 8}
MESH_SIZES = (1, 2, 4, 8, 16, 32)


def _rate(metric: str, reads_per_s: float) -> None:
    print(json.dumps({"metric": metric, "value": round(reads_per_s, 1), "unit": "reads/s",
                      "vs_baseline": None}), flush=True)


def _efficiency(metric: str, eff: float) -> None:
    print(json.dumps({"metric": metric, "value": round(eff, 3), "unit": "ratio",
                      "vs_baseline": round(eff / 0.8, 3)}), flush=True)  # target: >= 80 % linear


def main(device: str = "cuda", devices=None) -> None:
    """The reads/s table over mesh sizes.  `devices` (for tests): the
    mesh's shards in order, e.g. [torch.device("cpu")] * 4; by default
    every visible GPU on cuda, the one CPU device on cpu."""
    from swtpu_torch.bank.streams import pack_streams_sharded
    from swtpu_torch.parallel import make_mesh, make_sharded_scorer, make_sharded_stream_scorer

    dev = require_device(device, "bench_scaling")
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devices = [torch.device(d) for d in devices]
    if len(devices) < 2:
        print("# warning: single device; scaling table will be trivial", file=sys.stderr)
    on_card = devices[0].type == "cuda"
    kind = devices[0].type
    rng = np.random.default_rng(0)
    m = n = 128
    per_dev = PER_DEV[kind]
    sizes = [s for s in MESH_SIZES if s <= len(devices)]
    # the headline wavefront kernel is the multi-device kernel; set
    # SWTPU_SCALING_BACKEND=column/scan to measure the bucketed path instead
    backend = os.environ.get("SWTPU_SCALING_BACKEND",
                             "stream" if on_card or len(devices) > 1 else "scan")
    results = {}
    for nd in sizes:
        mesh = make_mesh(devices=devices[:nd])
        B = per_dev * nd
        q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
        t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
        if backend == "stream":
            batch = pack_streams_sharded(q[0], list(t), n_shards=nd, n_streams=N_STREAMS[kind])
            scorer = make_sharded_stream_scorer(mesh, k=4)
            args = (batch.q, batch.stream, batch.emit_stream,
                    batch.emit_step.astype(np.int32), batch.ids)

            def run():
                return scorer(*args)[0].cpu()
        else:
            scorer = make_sharded_scorer(mesh, backend="pallas" if on_card else "scan")

            def run():
                return scorer(q, t).cpu()
        run()  # build + warm
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        results[nd] = B / best
        _rate(f"reads/s @ {nd} device(s)", results[nd])
    if len(sizes) > 1:
        if len(set(devices[: sizes[-1]])) < sizes[-1]:
            print("# note: the mesh's shards share devices; this efficiency measures the "
                  "harness, not multi-GPU scaling", file=sys.stderr)
        base = results[sizes[0]] / sizes[0]
        _efficiency(f"scaling efficiency 1->{sizes[-1]} devices",
                    results[sizes[-1]] / (sizes[-1] * base))


def main_multihost(device: str = "cuda") -> None:
    """reads/s at 1, 2 and 4 localhost worker processes on `device`, in
    pair mode and in database mode (the stream path), and the efficiency
    1 -> 4 of each."""
    from swtpu_torch.ops.common import T_PAD
    from swtpu_torch.testing.regress import run_multihost

    require_device(device, "bench_scaling")
    print("# note: the workers share one device and each starts its own process; "
          "this wall measures process start more than scaling", file=sys.stderr)
    rng = np.random.default_rng(0)
    m = n = 64
    # per-process work is constant across process counts, so ideal scaling
    # = constant wall time; raise SWTPU_SCALING_PER_PROC to amortize the
    # workers' start into the measurement
    per_proc = int(os.environ.get("SWTPU_SCALING_PER_PROC", "64"))
    results = {}
    for nprocs in (1, 2, 4):
        B = per_proc * nprocs
        q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
        t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
        ids = np.arange(B, dtype=np.int32)
        t0 = time.perf_counter()
        run_multihost(q, t, ids, nprocs=nprocs, topk=4, device=device)
        results[nprocs] = B / (time.perf_counter() - t0)
        _rate(f"reads/s @ {nprocs} process(es) (localhost harness)", results[nprocs])
    _efficiency("process-scaling efficiency 1->4 (incl. startup)",
                results[4] / (4 * results[1]))
    # the production multi-process path (score_database_multihost -> the
    # wavefront kernel): one replicated query, per-process database shards
    results_db = {}
    for nprocs in (1, 2, 4):
        B = per_proc * nprocs
        query = rng.integers(0, 4, size=m).astype(np.int8)
        lens = rng.integers(8, n + 1, size=B).astype(np.int32)
        t = np.full((B, n), T_PAD, np.int8)
        for i in range(B):
            t[i, : lens[i]] = rng.integers(0, 4, size=lens[i]).astype(np.int8)
        ids = np.arange(B, dtype=np.int32)
        t0 = time.perf_counter()
        run_multihost(query, t, ids, nprocs=nprocs, topk=4, mode="database", lens=lens,
                      device=device)
        results_db[nprocs] = B / (time.perf_counter() - t0)
        _rate(f"reads/s @ {nprocs} process(es) (database/stream path)", results_db[nprocs])
    _efficiency("database-path process-scaling efficiency 1->4 (incl. startup)",
                results_db[4] / (4 * results_db[1]))


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="swtpu_torch.bench_scaling",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--multihost", action="store_true",
                    help="reads/s at 1, 2 and 4 localhost worker processes instead")
    args = ap.parse_args(argv)
    if args.multihost:
        main_multihost(args.device)
    else:
        main(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())

"""Multi-process regression driver: N scoring workers on localhost.

The port of ``swtpu.testing.regress``'s multi-process half.  It launches N
``swtpu_torch.testing.worker`` processes joined by ``torch.distributed``
(gloo), can kill one mid-run or make one lie about its scores, detects the
failure, and recovers: the whole job reruns after a dead worker, and only
the bad shards are scored again after a lying one.  Per-shard cursors make
a job resumable across driver runs; their files are swtpu's, so either
package's driver adopts the other's.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class MultihostResult:
    scores: np.ndarray
    top_s: np.ndarray
    top_ids: np.ndarray
    attempts: int
    killed_pids: List[int]
    bad_shards: List[int] = dataclasses.field(default_factory=list)
    resumed_shards: List[int] = dataclasses.field(default_factory=list)
    # each launched worker's output of the last attempt: {pid: npz dict}
    # (its scores, checksum and kernel launch counts)
    worker_outputs: dict = dataclasses.field(default_factory=dict)


def job_fingerprint(q, t, ids) -> int:
    """The job's crc32 fingerprint that its cursors carry (swtpu's)."""
    return zlib.crc32(
        np.ascontiguousarray(q).tobytes()
        + np.ascontiguousarray(t).tobytes()
        + np.ascontiguousarray(ids).tobytes()
    ) & 0x7FFFFFFF


def run_multihost(
    q: np.ndarray,
    t: np.ndarray,
    ids: np.ndarray,
    nprocs: int = 2,
    topk: int = 4,
    kill_worker: Optional[int] = None,
    kill_after_s: float = 1.0,
    max_attempts: int = 3,
    timeout_s: float = 300.0,
    adversary_worker: Optional[int] = None,
    adversary_mode: str = "corrupt",
    audit_rows: int = 4,
    mode: str = "pairs",
    lens: Optional[np.ndarray] = None,
    shard_bounds: Optional[List] = None,
    resume_dir: Optional[Path] = None,
    device: str = "cuda",
) -> MultihostResult:
    """Score (q, t) across `nprocs` localhost processes on `device`
    ("cuda": each worker scores on every visible GPU; "cpu"); returns
    merged, cross-checked results.  If kill_worker is set, that worker is
    SIGKILLed on the first attempt and the whole job reruns.

    mode 'pairs': q is [B, m], row i scores against t row i (the dense
    collective top-K path, the scan a shard).  mode 'database': q is one
    1-D query against every t row (pad rows with T_PAD, pass `lens`); each
    worker takes its shard through ``score_database_multihost``'s stream
    path.

    If adversary_worker is set, that worker lies about its scores on every
    attempt; the driver catches it by the checksum cross-check, the
    algebraic score bound or an oracle audit of `audit_rows` rows a shard,
    and scores the bad shard again itself (the scan on `device`).

    shard_bounds: optional explicit [(lo, hi), ...] a process for ragged
    shards (database mode).  Default: an equal split.

    resume_dir: a directory of per-shard completion cursors (database mode
    only).  Each worker writes `shard_<pid>.npz` atomically once its scores
    exist; a rerun (this attempt loop, or a new driver run over the same
    directory) loads the valid cursors, launches workers only for the
    unfinished shards (a smaller world), and merges on the host — finished
    shards are never scored again.  The merged top-K is then the driver's,
    in the same (score desc, id asc) order as the collective merge.

    A worker that exits non-zero ends the attempt at once: its peers are
    killed (a gloo peer of a dead process may otherwise block in a
    collective), and no process of the attempt outlives it."""
    B = t.shape[0]
    if shard_bounds is None:
        assert B % nprocs == 0
    else:
        assert len(shard_bounds) == nprocs and shard_bounds[-1][1] == B
    job_fp = None
    if resume_dir is not None:
        assert mode == "database", "cursors are database-mode job state"
        resume_dir = Path(resume_dir)
        resume_dir.mkdir(parents=True, exist_ok=True)
        if shard_bounds is None:
            step = B // nprocs
            shard_bounds = [(p * step, (p + 1) * step) for p in range(nprocs)]
        # a cursor from another job (a stale resume_dir) must never merge
        job_fp = job_fingerprint(q, t, ids)
    if lens is None:
        lens = np.full(B, t.shape[1], np.int32)
    # the audit's view: in database mode every row pairs the one query
    q2d = np.tile(np.asarray(q)[None, :], (B, 1)) if mode == "database" else q
    killed: List[int] = []
    resumed: List[int] = []
    for attempt in range(1, max_attempts + 1):
        with tempfile.TemporaryDirectory(prefix="swtpu_torch_mh_") as td:
            tdp = Path(td)
            inp = tdp / "input.npz"
            np.savez(inp, q=q, t=t, ids=ids, mode=mode, lens=lens)
            port = _free_port()
            procs = []
            # gloo binds the loopback interface: the workers share one host
            env = dict(os.environ)
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
            cursors = {}
            if resume_dir is not None:
                cursors = _load_cursors(resume_dir, nprocs, job_fp, B)
                resumed = sorted(cursors)
            launch = [p for p in range(nprocs) if p not in cursors]
            world = len(launch)
            for rank, pid in enumerate(launch):
                cmd = [
                    sys.executable, "-m", "swtpu_torch.testing.worker",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--nprocs", str(world), "--pid", str(rank),
                    "--input", str(inp), "--output", str(tdp / f"out_{pid}.npz"),
                    "--topk", str(topk), "--device", device,
                ]
                if adversary_worker == pid:
                    cmd += ["--adversary", adversary_mode]
                if shard_bounds is not None:
                    cmd += ["--lo", str(shard_bounds[pid][0]),
                            "--hi", str(shard_bounds[pid][1])]
                if resume_dir is not None:
                    cmd += ["--cursor", str(resume_dir / f"shard_{pid}.npz"),
                            "--cursor-fp", str(job_fp)]
                procs.append(subprocess.Popen(cmd, env=env, cwd=str(Path(__file__).parents[2])))
            try:
                # kill the named shard's process (a resumed shard has none)
                if kill_worker is not None and attempt == 1 and kill_worker in launch:
                    time.sleep(kill_after_s)
                    procs[launch.index(kill_worker)].send_signal(signal.SIGKILL)
                    killed.append(kill_worker)
                deadline = time.time() + timeout_s
                rcs = [None] * len(procs)
                while time.time() < deadline and any(r is None for r in rcs):
                    rcs = [p.poll() for p in procs]
                    if any(r not in (None, 0) for r in rcs):
                        break  # a worker failed: its peers may never finish
                    time.sleep(0.1)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
            if any(rc != 0 for rc in rcs):
                continue  # failure detected -> rerun
            # merge and cross-check (cursors count as delivered shards)
            scores = np.zeros((B,), np.int32)
            top_s = top_ids = None
            ok = True
            shard_rows_of = {}
            outputs = {}
            for pid, d in cursors.items():
                scores[d["local_rows"]] = d["local_scores"]
                shard_rows_of[pid] = (d["local_rows"], d)
            for pid in launch:
                f = tdp / f"out_{pid}.npz"
                if not f.exists():
                    ok = False
                    break
                d = outputs[pid] = dict(np.load(f))
                scores[d["local_rows"]] = d["local_scores"]
                shard_rows_of[pid] = (d["local_rows"], d)
                if top_s is None:
                    top_s, top_ids = d["top_s"], d["top_ids"]
                elif not (np.array_equal(top_s, d["top_s"])
                          and np.array_equal(top_ids, d["top_ids"])):
                    raise AssertionError("workers disagree on merged top-K")
            if not ok:
                continue
            if resume_dir is not None:
                # resumed shards never joined this attempt's collective:
                # the driver merges, in (score desc, id asc) order
                order = np.lexsort((ids, -scores))[:topk]
                top_s = scores[order].astype(np.int32)
                top_ids = ids[order].astype(np.int32)
            # the integrity pass: checksum, score bounds, then an oracle
            # audit of a few rows a shard — it catches a shard whose device
            # lies even when every process exits 0
            bad = _find_bad_shards(q2d, t, shard_rows_of, audit_rows)
            if bad:
                # score only the bad shards again, on the driver's device,
                # and rebuild the merged top-K
                import torch

                from swtpu_torch.ops.scan import sw_scores_scan

                for pid in bad:
                    rows = shard_rows_of[pid][0]
                    scores[rows] = sw_scores_scan(
                        torch.as_tensor(q2d[rows]).to(device),
                        torch.as_tensor(t[rows]).to(device),
                    ).cpu().numpy()
                order = np.lexsort((ids, -scores))[: len(top_s)]
                top_s = scores[order].astype(top_s.dtype)
                top_ids = ids[order].astype(top_ids.dtype)
            return MultihostResult(
                scores, top_s, top_ids, attempt, killed, list(bad),
                resumed_shards=resumed, worker_outputs=outputs,
            )
    raise RuntimeError(f"multihost job failed after {max_attempts} attempts")


def _load_cursors(resume_dir: Path, nprocs: int, job_fp: int, B: int) -> dict:
    """Valid per-shard completion cursors on disk: {pid: npz dict}.  A
    cursor whose checksum fails (a torn write), whose job fingerprint does
    not match (a stale resume_dir) or whose rows fall outside this job's
    batch is discarded, and its shard is scored again."""
    from swtpu_torch.utils.guards import checksum

    out = {}
    for pid in range(nprocs):
        f = resume_dir / f"shard_{pid}.npz"
        if not f.exists():
            continue
        try:
            d = dict(np.load(f))
        except Exception:
            continue
        if not {"local_rows", "local_scores", "checksum"} <= set(d):
            continue
        if int(d["checksum"]) != checksum(np.asarray(d["local_scores"])):
            continue
        if "job_fp" in d and int(d["job_fp"]) != job_fp:
            continue
        rows = np.asarray(d["local_rows"])
        if rows.size and (rows.min() < 0 or rows.max() >= B):
            continue
        out[pid] = d
    return out


def _find_bad_shards(q, t, shard_rows_of, audit_rows: int) -> List[int]:
    """Integrity checks a shard: (1) ``guards.checksum`` of the delivered
    scores against the worker's (wire corruption); (2) the algebraic score
    bound (``guards.check_scores``); (3) an oracle audit of `audit_rows`
    evenly spaced rows."""
    from swtpu_torch.oracle import sw_score_single
    from swtpu_torch.utils.guards import IntegrityError, check_scores, checksum

    bad: List[int] = []
    for pid, (rows, d) in sorted(shard_rows_of.items()):
        s = d["local_scores"]
        if "checksum" in d and int(d["checksum"]) != checksum(np.asarray(s)):
            bad.append(pid)
            continue
        try:
            check_scores(
                s, np.full(len(rows), q.shape[1]), np.full(len(rows), t.shape[1]),
                match=5,
            )
        except IntegrityError:
            bad.append(pid)
            continue
        n = len(rows)
        sample = np.unique(np.linspace(0, n - 1, min(audit_rows, n)).astype(int))
        for k in sample:
            r = int(rows[k])
            if int(s[k]) != sw_score_single(q[r], t[r]):
                bad.append(pid)
                break
    return bad

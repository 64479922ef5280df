"""The port's localhost multi-process harness (swtpu_torch.testing.regress
and .worker): 2 worker processes joined by torch.distributed over gloo on
the CPU, in both modes, with a killed worker, lying workers, ragged shards,
resume cursors and the emit_regular agreement; the checksum, the cursors
and the job fingerprint against swtpu's, cursors adopted both ways."""

import numpy as np
import pytest

from swtpu.bank.scorebank import ScoreResult
from swtpu.oracle import score_many_vs_one, sw_score_batch
from swtpu.testing import regress as ref_regress
from swtpu.utils.guards import checksum as ref_checksum
from swtpu_torch.ops.common import T_PAD
from swtpu_torch.testing import regress
from swtpu_torch.testing.regress import _load_cursors, job_fingerprint, run_multihost
from swtpu_torch.utils.guards import checksum

pytestmark = pytest.mark.multihost


def _database(rng, B, n, lens):
    t = np.full((B, n), T_PAD, np.int8)
    for i in range(B):
        t[i, : lens[i]] = rng.integers(0, 4, size=lens[i]).astype(np.int8)
    return t, [t[i, : lens[i]] for i in range(B)]


def _top(scores, ids, k):
    order = np.lexsort((ids, -scores))[:k]
    return list(zip(scores[order].tolist(), ids[order].tolist()))


def _launched(res):
    """Each worker's (wavefront, chained, column, chained column) launches."""
    return {pid: tuple(int(d[f"launches_{k}"]) for k in
                       ("wavefront", "chained", "column", "column_chained"))
            for pid, d in res.worker_outputs.items()}


@pytest.mark.parametrize("arr", [np.arange(7, dtype=np.int32), np.zeros(0, np.int32),
                                 np.array([[3, -1], [9, 2**30]], np.int64),
                                 np.arange(12, dtype=np.int8)[::2]])
def test_checksum_equals_swtpu(arr):
    assert checksum(arr) == ref_checksum(arr)


def test_two_process_pairs_mode():
    """Pairs: the scan a shard, the merged top-4 the same on both workers
    and in (score desc, id asc) order; no kernel wrapper launched on the
    CPU."""
    rng = np.random.default_rng(1)
    B, m, n = 16, 16, 24
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    ids = np.arange(B, dtype=np.int32)
    want = sw_score_batch(q, t)
    res = run_multihost(q, t, ids, nprocs=2, topk=4, device="cpu")
    np.testing.assert_array_equal(res.scores, want)
    assert list(zip(res.top_s.tolist(), res.top_ids.tolist())) == _top(want, ids, 4)
    assert res.attempts == 1 and sorted(res.worker_outputs) == [0, 1]
    assert set(_launched(res).values()) == {(0, 0, 0, 0)}


def test_two_process_database_mode_ties():
    """Database mode on the stream path, ragged reads with the query's own
    read four times (a tie at the top cut by k = 3)."""
    rng = np.random.default_rng(4)
    B, n = 16, 32
    query = rng.integers(0, 4, size=18).astype(np.int8)
    lens = rng.integers(5, n + 1, size=B).astype(np.int32)
    t, targets = _database(rng, B, n, lens)
    for i in (2, 5, 9, 14):
        t[i], lens[i] = T_PAD, 18
        t[i, :18] = query
    targets = [t[i, : lens[i]] for i in range(B)]
    want = score_many_vs_one(query, targets)
    ids = np.arange(B, dtype=np.int32)
    res = run_multihost(query, t, ids, nprocs=2, topk=3, mode="database", lens=lens,
                        device="cpu")
    np.testing.assert_array_equal(res.scores, want)
    got = list(zip(res.top_s.tolist(), res.top_ids.tolist()))
    assert got == [(90, 2), (90, 5), (90, 9)] == ScoreResult(want, 0, 0, 1).top_k(3)
    assert res.attempts == 1


def test_worker_kill_detection_and_rerun():
    """A worker SIGKILLed on the first attempt: the driver ends the attempt
    at once (its peer killed), reruns, and no process is left."""
    rng = np.random.default_rng(2)
    B, m, n = 8, 8, 8
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    ids = np.arange(B, dtype=np.int32)
    res = run_multihost(q, t, ids, nprocs=2, kill_worker=1, kill_after_s=0.5, device="cpu")
    np.testing.assert_array_equal(res.scores, sw_score_batch(q, t))
    assert res.attempts == 2 and res.killed_pids == [1]


@pytest.mark.parametrize("mode,adv", [("pairs", "corrupt"), ("pairs", "corrupt_wire"),
                                      ("database", "corrupt")])
def test_lying_worker_detected_and_shard_rerun(mode, adv):
    """One worker's scores lie while it exits 0: the checksum cross-check
    (corrupt_wire) or the oracle audit (corrupt) catches only that shard,
    and the driver scores it again with the scan."""
    rng = np.random.default_rng(3)
    B, n = 16, 20
    ids = np.arange(B, dtype=np.int32)
    if mode == "pairs":
        q = rng.integers(0, 4, size=(B, 12)).astype(np.int8)
        t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
        want, kw, liar = sw_score_batch(q, t), {}, 1
    else:
        q = rng.integers(0, 4, size=12).astype(np.int8)
        lens = rng.integers(4, n + 1, size=B).astype(np.int32)
        t, targets = _database(rng, B, n, lens)
        want, kw, liar = score_many_vs_one(q, targets), dict(lens=lens), 0
    res = run_multihost(q, t, ids, nprocs=2, mode=mode, adversary_worker=liar,
                        adversary_mode=adv, device="cpu", **kw)
    assert res.bad_shards == [liar]
    np.testing.assert_array_equal(res.scores, want)
    assert list(zip(res.top_s.tolist(), res.top_ids.tolist())) == _top(want, ids, 4)


def test_ragged_shards_agree_geometry():
    """Process 0 holds 10 short reads, process 1 five long ones: the (T, R)
    envelope is all-gathered and padded to, no pin needed."""
    rng = np.random.default_rng(6)
    B, n = 15, 200
    lens = np.concatenate([rng.integers(4, 9, size=10),
                           rng.integers(150, 201, size=5)]).astype(np.int32)
    t, targets = _database(rng, B, n, lens)
    query = rng.integers(0, 4, size=20).astype(np.int8)
    want = score_many_vs_one(query, targets)
    ids = np.arange(B, dtype=np.int32)
    res = run_multihost(query, t, ids, nprocs=2, topk=4, mode="database", lens=lens,
                        shard_bounds=[(0, 10), (10, 15)], device="cpu")
    np.testing.assert_array_equal(res.scores, want)
    assert list(zip(res.top_s.tolist(), res.top_ids.tolist())) == _top(want, ids, 4)


@pytest.mark.parametrize("second_regular", [False, True])
def test_emit_regular_agreed_across_processes(second_regular):
    """One process's shard regular (equal reads), the other's ragged: the
    geometry all-gather agrees on the scatter gather; both regular and the
    same: the strided gather on both."""
    rng = np.random.default_rng(8)
    B, n = 16, 40
    lens = np.concatenate([np.full(8, 20), np.full(8, 20) if second_regular
                           else rng.integers(4, n + 1, size=8)]).astype(np.int32)
    t, targets = _database(rng, B, n, lens)
    query = rng.integers(0, 4, size=16).astype(np.int8)
    res = run_multihost(query, t, np.arange(B, dtype=np.int32), nprocs=2, topk=3,
                        mode="database", lens=lens, device="cpu")
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))


def _resume_job(seed=7):
    rng = np.random.default_rng(seed)
    B, n = 12, 24
    query = rng.integers(0, 4, size=10).astype(np.int8)
    lens = rng.integers(4, n + 1, size=B).astype(np.int32)
    t, targets = _database(rng, B, n, lens)
    return query, t, lens, np.arange(B, dtype=np.int32), score_many_vs_one(query, targets)


def test_resume_cursor_skips_finished_shards(tmp_path):
    """Shard 0's cursor from an earlier run (a marker in it) is adopted and
    only shard 1 is scored; a third run launches no worker; a stale cursor
    (another job's fingerprint) is discarded and its shard scored again."""
    query, t, lens, ids, want = _resume_job()
    rdir = tmp_path / "job_state"
    rdir.mkdir()
    s0 = want[:6].copy()
    s0[0] = want[0] + 1  # a marker inside the score bound
    np.savez(rdir / "shard_0.npz", local_rows=np.arange(6), local_scores=s0,
             checksum=checksum(s0))
    kw = dict(nprocs=2, topk=3, mode="database", lens=lens, resume_dir=rdir, audit_rows=0,
              device="cpu")
    res = run_multihost(query, t, ids, **kw)
    assert res.resumed_shards == [0] and sorted(res.worker_outputs) == [1]
    assert res.scores[0] == want[0] + 1
    np.testing.assert_array_equal(res.scores[1:], want[1:])
    assert (rdir / "shard_1.npz").exists()
    res2 = run_multihost(query, t, ids, **kw)
    assert res2.resumed_shards == [0, 1] and res2.worker_outputs == {}
    np.testing.assert_array_equal(res2.scores, res.scores)
    assert list(zip(res2.top_s.tolist(), res2.top_ids.tolist())) == _top(res.scores, ids, 3)
    d1 = dict(np.load(rdir / "shard_1.npz"))
    d1["job_fp"] = np.int64(12345)
    np.savez(rdir / "shard_1.npz", **d1)
    res3 = run_multihost(query, t, ids, **kw)
    assert res3.resumed_shards == [0]
    np.testing.assert_array_equal(res3.scores[6:], want[6:])


def test_cursors_equal_swtpu_and_adopted_both_ways(tmp_path):
    """swtpu's driver and the port's on the same job: the same scores and
    top-K, cursor files equal in every field (job_fp the same crc32), each
    package's _load_cursors takes the other's, and each driver resumes the
    other's finished job without launching a worker."""
    query, t, lens, ids, want = _resume_job(9)
    B = len(ids)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    kw = dict(nprocs=2, topk=3, mode="database", lens=lens)
    res = run_multihost(query, t, ids, resume_dir=port_dir, device="cpu", **kw)
    ref = ref_regress.run_multihost(query, t, ids, resume_dir=ref_dir, **kw)
    np.testing.assert_array_equal(res.scores, want)
    for f in ("scores", "top_s", "top_ids"):
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f))
    fp = job_fingerprint(query, t, ids)
    for pid in (0, 1):
        mine = dict(np.load(port_dir / f"shard_{pid}.npz"))
        theirs = dict(np.load(ref_dir / f"shard_{pid}.npz"))
        assert sorted(mine) == sorted(theirs) == ["checksum", "job_fp", "local_rows",
                                                  "local_scores"]
        for key in mine:
            assert mine[key].dtype == theirs[key].dtype, key
            np.testing.assert_array_equal(mine[key], theirs[key])
        assert int(mine["job_fp"]) == fp
    assert sorted(_load_cursors(ref_dir, 2, fp, B)) == [0, 1]
    assert sorted(ref_regress._load_cursors(port_dir, 2, fp, B)) == [0, 1]
    again = run_multihost(query, t, ids, resume_dir=ref_dir, device="cpu", **kw)
    assert again.resumed_shards == [0, 1] and again.worker_outputs == {}
    ref_again = ref_regress.run_multihost(query, t, ids, resume_dir=port_dir, **kw)
    assert ref_again.resumed_shards == [0, 1]
    for f in ("scores", "top_s", "top_ids"):
        np.testing.assert_array_equal(getattr(again, f), getattr(ref_again, f))
    assert regress._find_bad_shards(
        np.tile(query[None, :], (B, 1)), t,
        {p: (d["local_rows"], d) for p, d in _load_cursors(port_dir, 2, fp, B).items()},
        4) == []


def test_worker_without_cuda_exits_non_zero(tmp_path):
    """--device cuda on a machine without a GPU: a non-zero exit, never a
    run on the CPU."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    np.savez(tmp_path / "in.npz", q=np.zeros((2, 8), np.int8), t=np.zeros((2, 8), np.int8),
             ids=np.arange(2, dtype=np.int32), mode="pairs", lens=np.full(2, 8, np.int32))
    p = subprocess.run(
        [sys.executable, "-m", "swtpu_torch.testing.worker", "--coordinator",
         "127.0.0.1:1", "--nprocs", "1", "--pid", "0", "--input", str(tmp_path / "in.npz"),
         "--output", str(tmp_path / "out.npz")], capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "no CUDA device" in p.stderr
    assert not (tmp_path / "out.npz").exists()

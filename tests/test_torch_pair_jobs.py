"""Long-query pair jobs: ScoreBank.score_pairs on the stream backend with
many distinct queries over 128 bases, each one chained many-vs-one job,
dispatched and finished through a window of jobs in flight (on CUDA side
by side on CUDA streams; here on the CPU one after another, through the
same loop), against the oracles and swtpu's own packer, exact and at the
RTL's 12-bit score width.  The CUDA side is in test_torch_cuda.py."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.bank import streams as ref_streams
from swtpu.config import DEFAULT_PENALTIES
from swtpu.ops import pallas_stream as ref
from swtpu.oracle import score_many_vs_one, sw_score_single_biased
from swtpu_torch.bank import ScoreBank, scorebank
from swtpu_torch.config import SWConfig
from swtpu_torch.ops import stream as port
from swtpu_torch.utils.metrics import EventLog

torch.set_num_threads(1)

N_QUERIES = 16  # distinct long queries: 16 jobs
QUERY_LENS = (129, 400)  # 2-4 chained tiles
TARGET_HI = 60  # targets of 0-60 bases
PHYS, ROWS = 8, 1  # the CPU's stream geometry (stream_geometry)
WIDTH = 12
WINDOWS = (1, 2, scorebank.JOB_WINDOW)  # jobs in flight


def _job_set(seed, n_short=0):
    """Pairs over N_QUERIES distinct long queries (repeated by content,
    not by object), 1-4 targets each, every third target a window of its
    query of up to TARGET_HI bases; with `n_short`, that many pairs of
    queries of 1-128 bases mixed in."""
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, 4, size=k).astype(np.int8)
          for k in rng.integers(QUERY_LENS[0], QUERY_LENS[1] + 1, size=N_QUERIES)]
    owner = rng.permutation(np.repeat(np.arange(N_QUERIES), rng.integers(1, 5, N_QUERIES)))
    queries = [qs[u].copy() for u in owner]
    targets = [rng.integers(0, 4, size=k).astype(np.int8)
               for k in rng.integers(0, TARGET_HI + 1, size=len(owner))]
    for i in range(0, len(owner), 3):
        k = int(rng.integers(1, TARGET_HI + 1))
        off = int(rng.integers(0, len(queries[i]) - k + 1))
        targets[i] = queries[i][off : off + k].copy()
    for _ in range(n_short):
        at = int(rng.integers(0, len(queries) + 1))
        queries.insert(at, rng.integers(0, 4, size=int(rng.integers(1, 129))).astype(np.int8))
        targets.insert(at, rng.integers(0, 4, size=int(rng.integers(0, TARGET_HI + 1)))
                       .astype(np.int8))
    return queries, targets


def _oracle(queries, targets, width):
    if width is not None:
        return [sw_score_single_biased(q, t, score_width=width) for q, t in zip(queries, targets)]
    out = np.zeros(len(queries), np.int32)
    keys = [q.tobytes() for q in queries]
    for key in dict.fromkeys(keys):
        idx = [i for i, k in enumerate(keys) if k == key]
        out[idx] = score_many_vs_one(queries[idx[0]], [targets[i] for i in idx])
    return out


@pytest.fixture(scope="module")
def cases():
    """(pairs, their oracle scores) by (name, width), made once."""
    out = {}
    for name, n_short in (("long", 0), ("mixed", 6)):
        queries, targets = _job_set(len(name), n_short)
        for width in (None, WIDTH):
            out[name, width] = (queries, targets, _oracle(queries, targets, width))
    return out


def _want_records(queries, targets):
    """swtpu's "stream_long" record fields of each long-query job, in job
    order, from swtpu's own dedupe and packer (its kernel not run)."""
    long_idx = [i for i, q in enumerate(queries) if len(q) > 128]
    qlist, uid = ref_streams.dedupe_queries([queries[i] for i in long_idx])
    out = []
    for u, q in enumerate(qlist):
        group = [i for pos, i in enumerate(long_idx) if uid[pos] == u]
        b = ref_streams.pack_streams_long(q, [targets[i] for i in group], n_streams=PHYS,
                                          rows=ROWS)
        K = b.q.shape[1] // 128
        N, T = b.stream.shape
        out.append(("stream_long", len(group), b.cells, N * T * 128 * K,
                    f"streams={N} T={T} tiles={K}"))
    return out


def _records(log, path):
    log.close()
    return [(e.kind, e.reads, e.cells, e.padded_cells, e.note) for e in EventLog.parse(path)]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("width", [None, WIDTH])
@pytest.mark.parametrize("name", ["long", "mixed"])
def test_pair_jobs_equal_oracle_and_swtpu_records(cases, name, width, window, monkeypatch,
                                                  tmp_path):
    """Every window gives the oracle's scores and swtpu's records in job
    order; a window under the job count makes jobs finish before later
    ones are dispatched."""
    queries, targets, want = cases[name, width]
    monkeypatch.setattr(scorebank, "JOB_WINDOW", window)
    bank = ScoreBank(SWConfig(score_width=width), backend="stream", device="cpu",
                     verify_integrity=True)
    streams, dispatch = [], bank._dispatch_long

    def dispatch_long(*args, stream=None, **kw):
        streams.append(stream)
        return dispatch(*args, stream=stream, **kw)

    monkeypatch.setattr(bank, "_dispatch_long", dispatch_long)
    log = EventLog(tmp_path / "events.jsonl")
    res = bank.score_pairs(queries, targets, event_log=log)
    np.testing.assert_array_equal(res.scores, want)
    assert res.scores.dtype == np.int32
    records = _records(log, tmp_path / "events.jsonl")
    kinds = [r[0] for r in records]
    n_short = sum(len(q) <= 128 for q in queries)
    if n_short:
        assert kinds[0] == "pair_stream"  # the short pairs go first
    longs = [r for r in records if r[0] == "stream_long"]
    assert kinds == kinds[: len(kinds) - len(longs)] + ["stream_long"] * len(longs)
    assert longs == _want_records(queries, targets)
    assert len(streams) == len(longs) == N_QUERIES
    assert streams == [None] * N_QUERIES  # no streams on the CPU
    short = [r for r in records if r[0] != "stream_long"]
    assert res.cells == sum(r[2] for r in records)
    assert res.padded_cells == sum(r[3] for r in records)
    assert len(short) == (1 if n_short else 0)


def test_window_bounds_the_jobs_in_flight(cases, monkeypatch):
    """At most JOB_WINDOW jobs are dispatched and not yet finished, the
    oldest finished first, and each finished once."""
    queries, targets, want = cases["long", None]
    monkeypatch.setattr(scorebank, "JOB_WINDOW", 2)
    bank = ScoreBank(backend="stream", device="cpu")
    trace, open_jobs = [], []
    dispatch, finish = bank._dispatch_long, bank._finish_long

    def dispatch_long(*args, **kw):
        job = dispatch(*args, **kw)
        open_jobs.append(job)
        trace.append(("dispatch", len(open_jobs)))
        return job

    def finish_long(job, event_log=None, **kw):
        assert job is open_jobs[0]
        open_jobs.pop(0)
        trace.append(("finish", len(open_jobs)))
        return finish(job, event_log, **kw)

    monkeypatch.setattr(bank, "_dispatch_long", dispatch_long)
    monkeypatch.setattr(bank, "_finish_long", finish_long)
    res = bank.score_pairs(queries, targets)
    np.testing.assert_array_equal(res.scores, want)
    assert max(n for what, n in trace if what == "dispatch") == 2
    assert [w for w, _ in trace].count("finish") == N_QUERIES and not open_jobs
    assert trace[:4] == [("dispatch", 1), ("dispatch", 2), ("finish", 1), ("dispatch", 2)]


@pytest.mark.parametrize("window", [1, 2])
def test_records_elapsed_add_up_to_the_wall(cases, window, monkeypatch, tmp_path):
    """Each record's elapsed_s is the time since the record before it
    finished, so a call's records add up to no more than its wall (what
    `swtpu_torch.cli events` totals), and the long jobs' records to the
    time from the first long dispatch to the last finish."""
    queries, targets, _ = cases["mixed", None]
    monkeypatch.setattr(scorebank, "JOB_WINDOW", window)
    bank = ScoreBank(backend="stream", device="cpu")
    dispatch, first = bank._dispatch_long, []

    def dispatch_long(*args, **kw):
        first.append(time.perf_counter())
        return dispatch(*args, **kw)

    monkeypatch.setattr(bank, "_dispatch_long", dispatch_long)
    log = EventLog(tmp_path / "events.jsonl")
    res = bank.score_pairs(queries, targets, event_log=log)
    end = time.perf_counter()
    log.close()
    events = list(EventLog.parse(tmp_path / "events.jsonl"))
    assert all(e.elapsed_s > 0 for e in events)
    assert sum(e.elapsed_s for e in events) <= res.elapsed_s
    longs = sum(e.elapsed_s for e in events if e.kind == "stream_long")
    assert longs == pytest.approx(end - first[0], abs=0.05, rel=0.05)


@pytest.mark.parametrize("width", [None, WIDTH])
def test_score_database_long_query_keeps_one_record(cases, width, tmp_path):
    """score_database on a long query is one job, dispatched and finished:
    one "stream_long" record, swtpu's, and the oracle's scores."""
    queries, targets, _ = cases["long", width]
    query = max(queries, key=len)
    log = EventLog(tmp_path / "events.jsonl")
    res = ScoreBank(SWConfig(score_width=width), backend="stream",
                    device="cpu").score_database(query, targets, event_log=log)
    np.testing.assert_array_equal(res.scores, _oracle([query] * len(targets), targets, width))
    (record,) = _records(log, tmp_path / "events.jsonl")
    (want,) = _want_records([query] * len(targets), targets)
    assert record == want
    assert (res.cells, res.padded_cells) == want[2:4]


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("width", [None, WIDTH])
def test_long_strip_hands_tiles_swtpus_layouts_and_shifts(rows, width):
    """Each tile of the chain (_long_strip: every register laid out in one
    copy, each shift one concatenation) gets swtpu's register layout of
    its 128 query rows, contiguous, and the tile before's D/G/H strips
    shifted as swtpu's _shift_steps shifts them, the boundary zero (0, or
    the bias at W = 12) at the tail and in the first tile's boundaries."""
    rng = np.random.default_rng(rows)
    N, K, T = 8, 3, 3 * 64
    q = rng.integers(0, 4, (N, K * 128)).astype(np.int8)
    sk = torch.from_numpy(rng.integers(0, 4, (T, N)).astype(np.int8))
    zero = 0 if width is None else 1 << (width - 1)
    seen = []

    def tile(qk, _sk, bD, bG, bH, _pen, _rows, **_mode):
        outs = tuple(torch.from_numpy(rng.integers(-99, 9999, (T, N)).astype(np.int32))
                     for _ in range(4))
        seen.append(((qk, bD, bG, bH), outs))
        return outs

    acc = port._long_strip(torch.from_numpy(q), sk, DEFAULT_PENALTIES, rows, tile=tile,
                           score_width=width)
    assert acc is seen[-1][1][0] and len(seen) == K
    SL = 128 // rows
    for p, ((qk, *bounds), _) in enumerate(seen):
        assert qk.dtype == torch.int8 and qk.is_contiguous()
        want = ref._q_kernel_layout(jnp.asarray(q[:, p * 128 : (p + 1) * 128]), 1, rows)
        np.testing.assert_array_equal(qk.numpy(), np.asarray(want))
        for b, k, out in zip(bounds, (SL - 2, SL - 1, SL - 1), seen[p - 1][1][1:]):
            assert b.is_contiguous() and b.shape == (T, N)
            want = (np.full((T, N), zero) if p == 0 else
                    ref._shift_steps(jnp.asarray(out.numpy()), k, fill=zero))
            np.testing.assert_array_equal(b.numpy(), np.asarray(want))

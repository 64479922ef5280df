"""Pairs on the streamed wavefront: the port's pair packer and
ScoreBank.score_pairs on the stream backend against swtpu's (interpret
mode) and the oracles, exact and at the RTL's 12-bit score width, with
queries of one tile and longer (the mixed path).  The CUDA side is in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from swtpu.bank import ScoreBank as RefBank
from swtpu.bank import streams as ref_streams
from swtpu.config import SWConfig as RefConfig
from swtpu.oracle import score_many_vs_one, sw_score_single_biased
from swtpu.utils import EventLog as RefEventLog
from swtpu_torch.bank import ScoreBank, streams
from swtpu_torch.config import SWConfig
from swtpu_torch.utils.metrics import EventLog

torch.set_num_threads(1)

FIELDS = ("q", "stream", "emit_stream", "emit_step")


def _pairs(rng, n, lo, hi, n_queries, t_hi=60):
    """n pairs over n_queries distinct queries of lo..hi bases (a query
    repeats by content, not by object), targets of 0..t_hi-1 bases."""
    qs = [rng.integers(0, 4, size=k).astype(np.int8)
          for k in rng.integers(lo, hi + 1, size=n_queries)]
    queries = [qs[i].copy() for i in rng.integers(0, n_queries, size=n)]
    targets = [rng.integers(0, 4, size=k).astype(np.int8)
               for k in rng.integers(0, t_hi, size=n)]
    return queries, targets


def _assert_same_batch(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.cells, got.segments, got.rows) == (want.cells, want.segments, want.rows)
    assert got.emit_regular == want.emit_regular


def test_dedupe_queries_equals_swtpu():
    rng = np.random.default_rng(1)
    queries, _ = _pairs(rng, 50, 0, 20, 12)
    queries[3] = list(queries[3])  # any sequence of codes
    qlist, uid = streams.dedupe_queries(queries)
    rlist, ruid = ref_streams.dedupe_queries(queries)
    np.testing.assert_array_equal(uid, ruid)
    assert uid.dtype == ruid.dtype == np.int32
    assert len(qlist) == len(rlist)
    for a, b in zip(qlist, rlist):
        assert a.dtype == b.dtype == np.int8
        np.testing.assert_array_equal(a, b)


# at each segment count, on 8 streams a segment: repeated queries; the
# same with zero-length targets; as many distinct queries as streams; one
# query and targets all of one length (the regular emission pattern)
PACK_CASES = ["repeats", "zero_length", "u_equals_s", "regular"]


@pytest.mark.parametrize("case", PACK_CASES)
@pytest.mark.parametrize("segments", [1, 2, 4])
def test_pack_pair_streams_equals_swtpu(segments, case):
    rng = np.random.default_rng(segments * 10 + PACK_CASES.index(case))
    qcap = 128 // segments
    S = 8 * segments
    if case == "u_equals_s":
        qs = [rng.integers(0, 4, size=qcap).astype(np.int8) for _ in range(S)]
        queries = [qs[i % S].copy() for i in range(3 * S)]
        targets = _pairs(rng, 3 * S, 1, 1, 1)[1]
    elif case == "regular":
        queries = [rng.integers(0, 4, size=qcap).astype(np.int8)] * (2 * S)
        targets = [rng.integers(0, 4, size=17).astype(np.int8) for _ in range(2 * S)]
    else:
        queries, targets = _pairs(rng, 40, 1, qcap, 5)
        if case == "zero_length":
            for i in (0, 7, 8, 39):
                targets[i] = np.zeros(0, np.int8)
    for rows in (1, 4):
        if (128 // rows) % segments:
            continue
        got = streams.pack_pair_streams(queries, targets, n_streams=S, segments=segments,
                                        rows=rows)
        want = ref_streams.pack_pair_streams(queries, targets, n_streams=S,
                                             segments=segments, rows=rows)
        _assert_same_batch(got, want)
    if case == "zero_length":
        assert (got.emit_step[[0, 7, 8, 39]] == -1).all()
    if case == "u_equals_s":
        assert len(streams.dedupe_queries(queries)[0]) == S
    if case == "regular":
        assert got.emit_regular is not None


@pytest.mark.parametrize("case", ["too_many_queries", "query_over_qcap", "unpaired"])
@pytest.mark.parametrize("segments", [1, 2, 4])
def test_pack_pair_streams_errors_equal_swtpu(segments, case):
    rng = np.random.default_rng(segments)
    S = 4 * segments
    queries, targets = _pairs(rng, 30, 1, 128 // segments, 3)
    if case == "too_many_queries":
        queries = [rng.integers(0, 4, size=12).astype(np.int8) for _ in range(S + 1)]
        targets = targets[: S + 1]
    elif case == "query_over_qcap":
        queries[4] = rng.integers(0, 4, size=128 // segments + 1).astype(np.int8)
    else:
        targets = targets[:-1]
    with pytest.raises(ValueError) as got:
        streams.pack_pair_streams(queries, targets, n_streams=S, segments=segments)
    with pytest.raises(ValueError) as want:
        ref_streams.pack_pair_streams(queries, targets, n_streams=S, segments=segments)
    assert str(got.value) == str(want.value)


def _events(log, path, ref):
    log.close()
    parse = RefEventLog.parse if ref else EventLog.parse
    return [(e.kind, e.reads, e.cells, e.padded_cells, e.note) for e in parse(path)]


# (name, score width, pairs): exact on 30 distinct queries of one tile,
# more than the 8 streams of a call at segments 1 (4 calls); at 12 bits on
# queries of up to 32 bases (segments 4); and at 12 bits on a mixed set:
# short pairs plus 2 distinct queries of 420-460 bases, one pair of each
# the query itself, which scores past the 12-bit ceiling and wraps
SCORE_CASES = [("exact", None), ("w12_short", 12), ("w12_mixed", 12)]


def _score_case(name):
    rng = np.random.default_rng(len(name))
    if name == "exact":
        return _pairs(rng, 60, 40, 128, 30)
    if name == "w12_short":
        return _pairs(rng, 40, 1, 32, 6)
    queries, targets = _pairs(rng, 24, 10, 100, 5)
    longs, ltargets = _pairs(rng, 8, 420, 460, 2)
    for i in range(8):
        if not any(np.array_equal(longs[i], longs[j]) for j in range(i)):
            ltargets[i] = longs[i].copy()
    return queries + longs, targets + ltargets


@pytest.mark.parametrize("name,width", SCORE_CASES)
def test_score_pairs_equals_swtpu_and_oracle(name, width, tmp_path):
    queries, targets = _score_case(name)
    log = EventLog(tmp_path / "port.jsonl")
    got = ScoreBank(SWConfig(score_width=width), backend="stream", device="cpu").score_pairs(
        queries, targets, event_log=log)
    ref_log = RefEventLog(tmp_path / "ref.jsonl")
    want = RefBank(RefConfig(score_width=width), backend="stream", interpret=True).score_pairs(
        queries, targets, event_log=ref_log)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.scores.dtype == np.int32
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)
    if width is None:
        oracle = [score_many_vs_one(q, [t])[0] for q, t in zip(queries, targets)]
    else:
        oracle = [sw_score_single_biased(q, t, score_width=width)
                  for q, t in zip(queries, targets)]
    np.testing.assert_array_equal(got.scores, oracle)
    events = _events(log, tmp_path / "port.jsonl", False)
    assert events == _events(ref_log, tmp_path / "ref.jsonl", True)
    kinds = [e[0] for e in events]
    if name == "exact":
        assert kinds == ["pair_stream"] * 4  # 30 queries over calls of 8 streams
    if name == "w12_mixed":
        assert kinds == ["pair_stream", "stream_long", "stream_long"]
        wrapping = [i for i, (q, t) in enumerate(zip(queries, targets))
                    if len(q) > 128 and np.array_equal(q, t)]
        assert len(wrapping) == 2
        for i in wrapping:
            assert got.scores[i] < 5 * len(queries[i])  # wrapped


def test_default_backend_scores_pairs_on_the_stream(tmp_path):
    """ScoreBank(device="cpu") resolves to the stream backend, and its
    score_pairs takes the pair streams, with verify_integrity's checks."""
    rng = np.random.default_rng(5)
    queries, targets = _pairs(rng, 30, 1, 64, 4)
    targets[2] = np.zeros(0, np.int8)
    bank = ScoreBank(device="cpu", verify_integrity=True)
    assert bank.backend == "stream"
    log = EventLog(tmp_path / "events.jsonl")
    res = bank.score_pairs(queries, targets, event_log=log)
    np.testing.assert_array_equal(
        res.scores, [score_many_vs_one(q, [t])[0] for q, t in zip(queries, targets)])
    assert res.scores[2] == 0
    ((kind, reads, cells, padded, note),) = _events(log, tmp_path / "events.jsonl", False)
    assert (kind, reads, cells, padded) == ("pair_stream", 30, res.cells, res.padded_cells)
    assert note.startswith("streams=16 T=") and note.endswith("queries=4")
    assert bank.score_pairs([], []).scores.shape == (0,)

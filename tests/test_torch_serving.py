"""Device-resident serving in the port: ScoreBank.load_database,
score_loaded, score_loaded_many and topk_loaded on the CPU against swtpu's
stream backend in interpret mode and the oracle, and _local_topk against
swtpu's."""

import numpy as np
import pytest
import torch

from swtpu.bank import ScoreBank as RefBank
from swtpu.config import Penalties as RefPenalties
from swtpu.config import SWConfig as RefConfig
from swtpu.oracle import score_many_vs_one, sw_score_single_biased
from swtpu.parallel.sharded import _local_topk as ref_local_topk
from swtpu_torch.bank import LoadedDatabase, ScoreBank
from swtpu_torch.config import Penalties, SWConfig
from swtpu_torch.io.loader import EncodedDB
from swtpu_torch.ops import stream as stream_ops
from swtpu_torch.parallel.topk import _local_topk
from swtpu_torch.utils.metrics import EventLog

torch.set_num_threads(1)


def _reads(rng, n, lo, hi):
    return [rng.integers(0, 4, size=int(rng.integers(lo, hi))).astype(np.int8)
            for _ in range(n)]


def _same_results(got, want):
    """Scores, cells and padded cells of two ScoreResults are equal."""
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.scores.dtype == np.int32
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)


def test_loaded_queries_equal_swtpu(tmp_path):
    """One database loaded for 300 bases serves queries of one tile and
    of three chained tiles (two long ones in a row on the same resident
    stream), a zero-length read among the reads."""
    rng = np.random.default_rng(21)
    targets = _reads(rng, 23, 2, 70)
    targets[4] = np.zeros((0,), np.int8)
    log = EventLog(tmp_path / "events.jsonl")
    bank = ScoreBank(backend="stream", device="cpu")
    db = bank.load_database(targets, max_query_len=300)
    assert isinstance(db, LoadedDatabase)
    assert (db.k_max, db.segments, db.rows, db.n_reads) == (3, 1, 1, 23)
    ref_bank = RefBank(backend="stream", interpret=True)
    ref_db = ref_bank.load_database(targets, max_query_len=300)
    np.testing.assert_array_equal(db.stream.numpy(), np.asarray(ref_db.stream))
    assert db.total_chars == ref_db.total_chars and db.emit_regular == ref_db.emit_regular
    for qlen in (16, 100, 290, 260):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        got = bank.score_loaded(query, db, event_log=log)
        _same_results(got, ref_bank.score_loaded(query, ref_db))
        np.testing.assert_array_equal(got.scores, score_many_vs_one(query, targets))
        assert got.cells == qlen * sum(len(t) for t in targets)
        assert got.scores[4] == 0
    log.close()
    events = EventLog.parse(tmp_path / "events.jsonl")
    assert [e.kind for e in events] == ["loaded"] * 4
    assert events[2].note == "qlen=290 resident_reads=23"


@pytest.mark.parametrize("form", ["mat_lens", "encoded_db"])
def test_loaded_dense_form_with_verify_integrity(form):
    rng = np.random.default_rng(22)
    mat = rng.integers(0, 4, size=(17, 50)).astype(np.int8)
    lens = rng.integers(3, 51, size=17).astype(np.int32)
    targets = [mat[i, : lens[i]] for i in range(17)]
    dense = (mat, lens) if form == "mat_lens" else EncodedDB(
        [f"db{i}" for i in range(17)], mat, lens)
    bank = ScoreBank(backend="stream", device="cpu", verify_integrity=True)
    db = bank.load_database(dense)
    query = rng.integers(0, 4, size=40).astype(np.int8)
    got = bank.score_loaded(query, db)
    ref_bank = RefBank(backend="stream", interpret=True, verify_integrity=True)
    _same_results(got, ref_bank.score_loaded(query, ref_bank.load_database((mat, lens))))
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, targets))


def test_loaded_many_and_topk_equal_swtpu(tmp_path):
    rng = np.random.default_rng(23)
    targets = _reads(rng, 19, 5, 60)
    bank = ScoreBank(backend="stream", device="cpu")
    db = bank.load_database(targets)
    queries = [rng.integers(0, 4, size=L).astype(np.int8) for L in (16, 64, 100)]
    log = EventLog(tmp_path / "events.jsonl")
    results = bank.score_loaded_many(queries, db, event_log=log)
    ref_bank = RefBank(backend="stream", interpret=True)
    ref_db = ref_bank.load_database(targets)
    for q, res, want in zip(queries, results, ref_bank.score_loaded_many(queries, ref_db)):
        _same_results(res, want)
        np.testing.assert_array_equal(res.scores, score_many_vs_one(q, targets))
    # the wave's wall divided evenly
    assert len({r.elapsed_s for r in results}) == 1 and results[0].elapsed_s > 0
    got = bank.topk_loaded(queries[1], db, k=5, event_log=log)
    assert got == results[1].top_k(5) == ref_bank.topk_loaded(queries[1], ref_db, k=5)
    assert all(isinstance(s, int) and isinstance(i, int) for s, i in got)
    log.close()
    events = EventLog.parse(tmp_path / "events.jsonl")
    assert [e.kind for e in events] == ["loaded_many"] * 3 + ["loaded_topk"]
    assert events[-1].note == "qlen=64 k=5" and events[-1].padded_cells == 0


@pytest.mark.parametrize("k", [1, 3, 6, 30])
def test_topk_loaded_cuts_through_ties(k):
    """Reads 2, 5, 6, 9, 11 and 17 are the query itself: k = 3 cuts the
    tied top group, k = 30 asks for more than the 20 reads."""
    rng = np.random.default_rng(24)
    targets = _reads(rng, 20, 5, 60)
    query = rng.integers(0, 4, size=48).astype(np.int8)
    for i in (2, 5, 6, 9, 11, 17):
        targets[i] = query.copy()
    bank = ScoreBank(backend="stream", device="cpu")
    db = bank.load_database(targets, max_query_len=64)
    got = bank.topk_loaded(query, db, k=k)
    want = bank.score_loaded(query, db).top_k(k)
    assert got == want and len(got) == min(k, 20)
    assert got[: min(k, 6)] == [(240, i) for i in (2, 5, 6, 9, 11, 17)][:k]
    ref_bank = RefBank(backend="stream", interpret=True)
    assert got == ref_bank.topk_loaded(query, ref_bank.load_database(targets, 64), k=k)


def test_loaded_segmented_short_queries_equal_swtpu():
    rng = np.random.default_rng(24)
    targets = _reads(rng, 15, 4, 50)
    bank = ScoreBank(backend="stream", device="cpu")
    db = bank.load_database(targets, max_query_len=32)
    assert (db.segments, db.k_max) == (4, 1)
    ref_bank = RefBank(backend="stream", interpret=True)
    ref_db = ref_bank.load_database(targets, max_query_len=32)
    np.testing.assert_array_equal(db.stream.numpy(), np.asarray(ref_db.stream))
    for qlen in (8, 30):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        got = bank.score_loaded(query, db)
        _same_results(got, ref_bank.score_loaded(query, ref_db))
        np.testing.assert_array_equal(got.scores, score_many_vs_one(query, targets))


@pytest.mark.parametrize("case", ["backend", "segmented", "tiles"])
def test_value_errors_equal_swtpu(case):
    """load_database off the stream backend, a query past a segmented
    database's capacity, and one past its tiles: swtpu's messages."""
    rng = np.random.default_rng(25)
    targets = _reads(rng, 6, 4, 30)
    if case == "backend":
        def run(bank):
            bank.load_database(targets)
        port, ref = ScoreBank(backend="pallas", device="cpu"), RefBank(backend="pallas")
        match = "requires the stream backend"
    else:
        cap, qlen = (32, 50) if case == "segmented" else (300, 400)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)

        def run(bank):
            bank.score_loaded(query, bank.load_database(targets, max_query_len=cap))
        port = ScoreBank(backend="stream", device="cpu")
        ref = RefBank(backend="stream", interpret=True)
        match = "segmented capacity" if case == "segmented" else "reload with a larger"
    with pytest.raises(ValueError, match=match) as got:
        run(port)
    with pytest.raises(ValueError) as want:
        run(ref)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("qlen", [100, 450])
def test_loaded_score_width_equals_swtpu(qlen):
    """score_width=12 on a resident database, one tile and a biased chain
    of four: a read equal to the 450-base query scores 2,250 exactly,
    past the 12-bit ceiling, so it wraps."""
    rng = np.random.default_rng(26)
    targets = _reads(rng, 18, 5, 80)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    targets[3] = query.copy()
    bank = ScoreBank(SWConfig(score_width=12), backend="stream", device="cpu")
    got = bank.score_loaded(query, bank.load_database(targets, max_query_len=512))
    ref_bank = RefBank(RefConfig(score_width=12), backend="stream", interpret=True)
    _same_results(got, ref_bank.score_loaded(
        query, ref_bank.load_database(targets, max_query_len=512)))
    want = [sw_score_single_biased(query, t, RefPenalties(), 12) for t in targets]
    assert got.scores.tolist() == want
    assert (got.scores[3] == 5 * qlen) == (qlen == 100)


def test_loaded_int16_rows8_equals_swtpu():
    """int16 state at stream_rows=8 on a resident database: one-tile
    queries of 60 and 128 bases (the 16-bit states run at rows <= 8)."""
    rng = np.random.default_rng(27)
    targets = _reads(rng, 16, 5, 70)
    cfg = dict(stream_state_dtype="int16", stream_rows=8)
    bank = ScoreBank(SWConfig(**cfg), backend="stream", device="cpu")
    db = bank.load_database(targets)
    assert db.rows == 8
    ref_bank = RefBank(RefConfig(**cfg), backend="stream", interpret=True)
    ref_db = ref_bank.load_database(targets)
    for qlen in (60, 128):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        got = bank.score_loaded(query, db)
        _same_results(got, ref_bank.score_loaded(query, ref_db))
        np.testing.assert_array_equal(got.scores, score_many_vs_one(query, targets))


def test_resident_stream_is_not_copied(monkeypatch):
    """Both wavefront entries get the resident tensor itself: the same
    storage for a one-tile and a chained query, two of each."""
    rng = np.random.default_rng(28)
    targets = _reads(rng, 12, 5, 60)
    bank = ScoreBank(backend="stream", device="cpu")
    db = bank.load_database(targets, max_query_len=256)
    assert db.stream.dtype == torch.int8 and db.stream.is_contiguous()
    seen = []
    strip_call, long_strip = stream_ops._strip_call, stream_ops._long_strip

    def record_strip(qk, sk, *args, **kw):
        seen.append(sk.data_ptr())
        return strip_call(qk, sk, *args, **kw)

    def record_long(q, sk, *args, **kw):
        seen.append(sk.data_ptr())
        return long_strip(q, sk, *args, **kw)

    monkeypatch.setattr(stream_ops, "_strip_call", record_strip)
    monkeypatch.setattr(stream_ops, "_long_strip", record_long)
    for qlen in (50, 200, 90, 256):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        np.testing.assert_array_equal(bank.score_loaded(query, db).scores,
                                      score_many_vs_one(query, targets))
    assert seen == [db.stream.data_ptr()] * 4


TOPK_R = [7, 512, 513, 5000]
TOPK_KK = [1, 10, 128, 129]


@pytest.mark.parametrize("kk", TOPK_KK)
@pytest.mark.parametrize("R", TOPK_R)
def test_local_topk_equals_swtpu(R, kk):
    """Scores of 0-3 (heavy ties), one in nine a sentinel (id -1, score
    -2^30); kk past R takes all R."""
    kk = min(kk, R)
    rng = np.random.default_rng(R + kk)
    scores = rng.integers(0, 4, size=R).astype(np.int32)
    ids = np.arange(R, dtype=np.int32)
    sentinel = rng.random(R) < 1 / 9
    ids[sentinel] = -1
    masked = np.where(sentinel, -(2 ** 30), scores).astype(np.int32)
    got_s, got_i = _local_topk(torch.from_numpy(masked), torch.from_numpy(ids), kk)
    want_s, want_i = ref_local_topk(masked, ids, kk)
    assert got_s.dtype == got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    order = np.argsort(-masked.astype(np.int64), kind="stable")[:kk]
    np.testing.assert_array_equal(got_i.numpy(), ids[order])

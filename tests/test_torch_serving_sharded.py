"""Sharded device-resident serving in the port (swtpu_torch.bank.serving)
on a mesh of 8 CPU shards, against swtpu.bank.serving on its 8-device
virtual CPU mesh (its stream backend in interpret mode) and the oracle:
every case of tests/test_serving_sharded.py, at tolerance 0."""

import jax
import numpy as np
import pytest
import torch

from swtpu.bank import ScoreBank as RefBank
from swtpu.config import SWConfig as RefConfig
from swtpu.oracle import score_many_vs_one, sw_score_single_biased
from swtpu.parallel import make_mesh as ref_make_mesh
from swtpu_torch.bank import ScoreBank
from swtpu_torch.bank.serving import ShardedLoadedDatabase
from swtpu_torch.config import SWConfig
from swtpu_torch.ops import stream as stream_ops
from swtpu_torch.parallel.mesh import make_mesh
from swtpu_torch.utils.metrics import EventLog

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs swtpu's 8 virtual CPU devices")
    return make_mesh(devices=["cpu"] * 8), ref_make_mesh(8)


@pytest.fixture(scope="module")
def banks():
    return ScoreBank(backend="stream", device="cpu"), RefBank(backend="stream", interpret=True)


def _targets(rng, n, lo=3, hi=40):
    return [rng.integers(0, 4, size=rng.integers(lo, hi)).astype(np.int8) for _ in range(n)]


def _load_both(banks, meshes, targets, **kw):
    """(the port's db, swtpu's db), their layouts held equal."""
    db = banks[0].load_database_sharded(targets, meshes[0], **kw)
    ref_db = banks[1].load_database_sharded(targets, meshes[1], **kw)
    assert isinstance(db, ShardedLoadedDatabase)
    ref_stream = np.asarray(ref_db.stream)
    assert db.shape == ref_stream.shape
    for d, s in enumerate(db.streams):
        assert s.is_contiguous() and s.dtype == torch.int8
        np.testing.assert_array_equal(s.numpy(), ref_stream[d])
    np.testing.assert_array_equal(db.ids_host, ref_db.ids_host)
    assert (db.k_max, db.segments, db.rows, db.n_shards, db.total_chars, db.emit_regular) == (
        ref_db.k_max, ref_db.segments, ref_db.rows, ref_db.n_shards, ref_db.total_chars,
        ref_db.emit_regular)
    return db, ref_db


def _same(got, want):
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.scores.dtype == np.int32
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)


def test_loaded_sharded_parity(meshes, banks):
    bank, ref = banks
    rng = np.random.default_rng(10)
    targets = _targets(rng, 37)
    db, ref_db = _load_both(banks, meshes, targets)
    assert db.n_shards == 8
    for qlen in (9, 100, 128):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        res = bank.score_loaded_sharded(query, db)
        _same(res, ref.score_loaded_sharded(query, ref_db))
        np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
        assert res.cells == qlen * sum(len(t) for t in targets)


def test_loaded_sharded_long_query_chained(meshes, banks, monkeypatch):
    """A query over 128 bases chains tiles on each shard; the capacity
    comes from the load's max_query_len.  The resident stream reaches the
    kernel's plain version uncopied, one chained tile a shard a tile."""
    bank, ref = banks
    rng = np.random.default_rng(11)
    targets = _targets(rng, 19)
    db, ref_db = _load_both(banks, meshes, targets, max_query_len=300)
    assert db.k_max == 3
    seen = []
    real = stream_ops.stream_chained_reference

    def spy(qk, sk, *a, **kw):
        seen.append(sk.data_ptr())
        return real(qk, sk, *a, **kw)

    monkeypatch.setattr(stream_ops, "stream_chained_reference", spy)
    for qlen in (64, 130, 300):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        res = bank.score_loaded_sharded(query, db)
        _same(res, ref.score_loaded_sharded(query, ref_db))
        np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
    assert len(seen) == 8 * (2 + 3)
    assert set(seen) == {s.data_ptr() for s in db.streams}
    over = rng.integers(0, 4, size=385).astype(np.int8)  # needs 4 tiles
    with pytest.raises(ValueError, match="reload") as e:
        bank.score_loaded_sharded(over, db)
    with pytest.raises(ValueError) as ref_e:
        ref.score_loaded_sharded(over, ref_db)
    assert str(e.value) == str(ref_e.value)


def test_loaded_sharded_segmented_short_queries(meshes, banks):
    """max_query_len <= 32 packs segments=4, as the one-device loader."""
    bank, ref = banks
    rng = np.random.default_rng(12)
    targets = _targets(rng, 23, lo=2, hi=25)
    db, ref_db = _load_both(banks, meshes, targets, max_query_len=32)
    assert db.segments == 4
    query = rng.integers(0, 4, size=30).astype(np.int8)
    _same(bank.score_loaded_sharded(query, db), ref.score_loaded_sharded(query, ref_db))
    over = rng.integers(0, 4, size=40).astype(np.int8)
    with pytest.raises(ValueError, match="segmented capacity") as e:
        bank.score_loaded_sharded(over, db)
    with pytest.raises(ValueError) as ref_e:
        ref.score_loaded_sharded(over, ref_db)
    assert str(e.value) == str(ref_e.value)


def test_topk_loaded_sharded_tie_consistency(meshes, banks):
    """The merged top-K off the resident shards orders ties like
    ScoreResult.top_k, swtpu's sharded serving and the one-device path."""
    bank, ref = banks
    rng = np.random.default_rng(13)
    base = _targets(rng, 3, 6, 20)
    targets = [base[int(rng.integers(0, 3))] for _ in range(26)]
    query = rng.integers(0, 4, size=12).astype(np.int8)
    db, ref_db = _load_both(banks, meshes, targets)
    res = bank.score_loaded_sharded(query, db)
    k = 7
    got = bank.topk_loaded_sharded(query, db, k=k)
    assert got == res.top_k(k) == ref.topk_loaded_sharded(query, ref_db, k=k)
    assert got == bank.topk_loaded(query, bank.load_database(targets), k=k)


def test_loaded_sharded_many_pipelined(meshes, banks, tmp_path):
    bank, ref = banks
    rng = np.random.default_rng(14)
    targets = _targets(rng, 17)
    db, ref_db = _load_both(banks, meshes, targets)
    queries = [rng.integers(0, 4, size=rng.integers(5, 100)).astype(np.int8)
               for _ in range(4)]
    log = EventLog(tmp_path / "many.jsonl")
    results = bank.score_loaded_many_sharded(queries, db, event_log=log)
    log.close()
    for q, r, w in zip(queries, results, ref.score_loaded_many_sharded(queries, ref_db)):
        _same(r, w)
        np.testing.assert_array_equal(r.scores, score_many_vs_one(q, targets))
    events = EventLog.parse(tmp_path / "many.jsonl")
    assert [e.kind for e in events] == ["loaded_sharded_many"] * 4
    assert [e.note for e in events] == [f"qlen={len(q)} shards=8" for q in queries]


def test_loaded_sharded_dense_form_and_events(meshes, banks, tmp_path):
    """The dense (mat, lens) form loads shard by shard, and serving emits
    swtpu's events with swtpu's fields."""
    from swtpu.utils import EventLog as RefEventLog

    bank, ref = banks
    rng = np.random.default_rng(15)
    lens = rng.integers(4, 30, size=21).astype(np.int32)
    mat = np.zeros((21, 30), np.int8)
    for i, L in enumerate(lens):
        mat[i, :L] = rng.integers(0, 4, size=L)
    targets = [mat[i, : lens[i]] for i in range(21)]
    db, ref_db = _load_both(banks, meshes, (mat, lens))
    query = rng.integers(0, 4, size=16).astype(np.int8)
    log, ref_log = EventLog(tmp_path / "serve.jsonl"), RefEventLog(tmp_path / "ref.jsonl")
    res = bank.score_loaded_sharded(query, db, event_log=log)
    bank.topk_loaded_sharded(query, db, k=3, event_log=log)
    ref.score_loaded_sharded(query, ref_db, event_log=ref_log)
    ref.topk_loaded_sharded(query, ref_db, k=3, event_log=ref_log)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
    log.close()
    ref_log.close()
    got, want = EventLog.parse(tmp_path / "serve.jsonl"), EventLog.parse(tmp_path / "ref.jsonl")
    assert [e.kind for e in got] == ["loaded_sharded", "loaded_sharded_topk"]
    assert all(e.reads == 21 for e in got)
    assert [(e.kind, e.reads, e.cells, e.padded_cells, e.note) for e in got] == [
        (e.kind, e.reads, e.cells, e.padded_cells, e.note) for e in want]


def test_loaded_sharded_fewer_reads_than_shards(meshes, banks):
    """Fewer reads than shards leaves shards empty: still exact, and a
    top-K past the reads drops the sentinel slots."""
    bank, ref = banks
    rng = np.random.default_rng(16)
    targets = _targets(rng, 5)
    db, ref_db = _load_both(banks, meshes, targets)
    query = rng.integers(0, 4, size=11).astype(np.int8)
    _same(bank.score_loaded_sharded(query, db), ref.score_loaded_sharded(query, ref_db))
    top = bank.topk_loaded_sharded(query, db, k=8)
    assert len(top) == 5 and top == ref.topk_loaded_sharded(query, ref_db, k=8)


def test_loaded_sharded_requires_stream_backend(meshes):
    bank = ScoreBank(backend="scan", device="cpu")
    with pytest.raises(ValueError, match="stream backend") as e:
        bank.load_database_sharded([np.zeros(4, np.int8)], meshes[0])
    with pytest.raises(ValueError) as ref_e:
        RefBank(backend="scan").load_database_sharded([np.zeros(4, np.int8)], meshes[1])
    assert str(e.value) == str(ref_e.value)


def test_loaded_sharded_biased_long_query(meshes):
    """score_width composes with sharded serving at any query length (the
    biased chained tiles a shard)."""
    rng = np.random.default_rng(17)
    W = 9
    bank = ScoreBank(SWConfig(score_width=W), backend="stream", device="cpu")
    ref = RefBank(RefConfig(score_width=W), backend="stream", interpret=True)
    targets = _targets(rng, 13)
    db, ref_db = _load_both((bank, ref), meshes, targets, max_query_len=256)
    query = np.tile(np.arange(4, dtype=np.int8), 40)  # 160 bases, self-similar
    want = np.array([sw_score_single_biased(query, t, score_width=W) for t in targets],
                    np.int32)
    res = bank.score_loaded_sharded(query, db)
    np.testing.assert_array_equal(res.scores, want)
    _same(res, ref.score_loaded_sharded(query, ref_db))

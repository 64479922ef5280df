"""The port's bucketed column path on the CPU: length buckets, the dense
packer and the batch guards against swtpu's, field for field and message
for message, and ScoreBank(backend="pallas") score_database / score_pairs
(exact and wrap-parity) against swtpu's pallas ScoreBank in interpret mode
and the oracles.  All integers: bit-equal."""

import numpy as np
import pytest
import torch

from swtpu.bank import ScoreBank as RefBank
from swtpu.bank.buckets import plan_buckets as ref_plan_buckets
from swtpu.bank.packer import pack_many_vs_one as ref_pack_many_vs_one
from swtpu.bank.packer import pack_pairs as ref_pack_pairs
from swtpu.config import SWConfig as RefConfig
from swtpu.oracle import score_many_vs_one, sw_score_single, sw_score_single_biased
from swtpu.utils import guards as ref_guards
from swtpu.utils.metrics import EventLog as RefEventLog
from swtpu_torch.bank import ScoreBank
from swtpu_torch.bank.buckets import plan_buckets
from swtpu_torch.bank.packer import pack_many_vs_one, pack_pairs
from swtpu_torch.config import Penalties, SWConfig
from swtpu_torch.io.loader import EncodedDB
from swtpu_torch.utils import guards
from swtpu_torch.utils.metrics import EventLog

torch.set_num_threads(1)

FIELDS = ("q", "t", "q_lens", "t_lens", "ids", "cells", "padded_cells")


def _db(rng, n, hi=90):
    """EncodedDB with reads 2 and 5 zero-length."""
    lens = rng.integers(1, hi, size=n).astype(np.int32)
    lens[[2, 5]] = 0
    mat = rng.integers(0, 4, size=(n, hi)).astype(np.int8)
    mat[np.arange(hi)[None, :] >= lens[:, None]] = 4
    return EncodedDB([f"db{i}" for i in range(n)], mat, lens)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert type(a) is type(b), f
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize(
    "lengths,ladder",
    [
        ([10, 32, 33, 128, 500, 0], (32, 128, 512)),
        ([7, 7, 2048, 1], (2048, 32, 512, 128)),  # unsorted ladder
        (list(range(0, 300, 7)), (16, 64, 300)),
    ],
)
def test_plan_buckets_equals_swtpu(lengths, ladder):
    got, want = plan_buckets(lengths, ladder), ref_plan_buckets(lengths, ladder)
    assert got.bucket_lens == want.bucket_lens
    assert got.assignments.dtype == want.assignments.dtype
    np.testing.assert_array_equal(got.assignments, want.assignments)
    assert got.fill == want.fill


def test_plan_buckets_overflow_message_equals_swtpu():
    with pytest.raises(ValueError) as e:
        plan_buckets([600, 700, 5], (32, 128, 512))
    with pytest.raises(ValueError) as e_ref:
        ref_plan_buckets([600, 700, 5], (32, 128, 512))
    assert str(e.value) == str(e_ref.value) == "read length 700 exceeds largest bucket 512"


@pytest.mark.parametrize("form", ["list", "dense"])
@pytest.mark.parametrize("batch_align,q_width", [(1, None), (8, None), (4, 64)])
def test_pack_many_vs_one_equals_swtpu(form, batch_align, q_width):
    rng = np.random.default_rng(batch_align)
    db = _db(rng, 45, hi=200)
    query = rng.integers(0, 4, size=37).astype(np.int8)
    kw = dict(bucket_lens=(32, 128, 512), q_width=q_width, batch_align=batch_align)
    if form == "dense":
        args, kw["lens"] = (query, db.mat), db.lens
    else:
        args = (query, db.as_list())
    got, want = pack_many_vs_one(*args, **kw), ref_pack_many_vs_one(*args, **kw)
    _assert_batches_equal(got, want)
    assert len(got) == 3
    if batch_align > 1:
        assert all(len(b.ids) % batch_align == 0 for b in got)
        assert any((b.ids == -1).any() for b in got)


def test_pack_many_vs_one_edges_equal_swtpu():
    query = np.zeros(20, np.int8)
    assert pack_many_vs_one(query, []) == ref_pack_many_vs_one(query, []) == []
    with pytest.raises(ValueError) as e:
        pack_many_vs_one(query, [query], q_width=16)
    with pytest.raises(ValueError) as e_ref:
        ref_pack_many_vs_one(query, [query], q_width=16)
    assert str(e.value) == str(e_ref.value)


@pytest.mark.parametrize("ids", [None, np.array([9, 3, 5, 1, 0, 7], np.int64)])
def test_pack_pairs_equals_swtpu(ids):
    rng = np.random.default_rng(3)
    queries = [rng.integers(0, 4, size=k).astype(np.int8) for k in (5, 0, 30, 17, 32, 1)]
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in (60, 3, 0, 128, 77, 9)]
    got = pack_pairs(queries, targets, q_width=32, t_width=128, ids=ids)
    want = ref_pack_pairs(queries, targets, q_width=32, t_width=128, ids=ids)
    _assert_batches_equal([got], [want])
    with pytest.raises(ValueError, match="must pair up"):
        pack_pairs(queries, targets[:2], 32, 128)


def _corruptions():
    rng = np.random.default_rng(4)
    b = pack_many_vs_one(rng.integers(0, 4, size=20).astype(np.int8),
                         [rng.integers(0, 4, size=k).astype(np.int8) for k in (5, 20, 31)])[0]
    yield "query", b.q, b.q_lens, None
    yield "target", b.t, b.t_lens, None
    q = b.q.copy()
    q[1, 3] = 7  # not a code
    yield "query", q, b.q_lens, "not a base code"
    t = b.t.copy()
    t[0, 2] = 4  # a pad inside the read
    yield "target", t, b.t_lens, "pad code inside"
    t = b.t.copy()
    t[0, 10] = 1  # a base past the read's length
    yield "target", t, b.t_lens, "real code beyond"
    yield "query", b.q[0], None, "must be 2-D"


@pytest.mark.parametrize("case", range(6))
def test_check_packed_messages_equal_swtpu(case):
    what, arr, lens, match = list(_corruptions())[case]
    check = getattr(guards, f"check_packed_{what}")
    ref_check = getattr(ref_guards, f"check_packed_{what}")
    if match is None:
        check(arr, lens)
        ref_check(arr, lens)
        return
    with pytest.raises(guards.IntegrityError, match=match) as e:
        check(arr, lens)
    with pytest.raises(ref_guards.IntegrityError) as e_ref:
        ref_check(arr, lens)
    assert str(e.value) == str(e_ref.value)


def _events(log_path, log=EventLog):
    return [(e.kind, e.reads, e.cells, e.padded_cells, e.note)
            for e in log.parse(log_path)]


def test_score_database_equals_swtpu_pallas(tmp_path):
    """One run against swtpu's pallas ScoreBank in interpret mode: scores,
    cells and the per-bucket "batch" records."""
    rng = np.random.default_rng(5)
    db = _db(rng, 24, hi=100)
    query = rng.integers(0, 4, size=40).astype(np.int8)
    port_log = EventLog(tmp_path / "port.jsonl")
    ref_log = RefEventLog(tmp_path / "ref.jsonl")
    got = ScoreBank(SWConfig(target_buckets=(32, 128)), backend="pallas",
                    device="cpu").score_database(query, db.as_list(), event_log=port_log)
    want = RefBank(RefConfig(target_buckets=(32, 128)), backend="pallas",
                   interpret=True).score_database(
        query, db.as_list(), event_log=ref_log)
    port_log.close()
    ref_log.close()
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, db.as_list()))
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)
    assert got.scores[2] == got.scores[5] == 0
    events = _events(tmp_path / "port.jsonl")
    assert events == _events(tmp_path / "ref.jsonl", RefEventLog)
    assert [e[0] for e in events] == ["batch", "batch"]
    assert events[1][-1] == "bucket_len=128"


@pytest.mark.parametrize("form", ["list", "encoded_db", "mat_lens"])
@pytest.mark.parametrize("qlen", [20, 300])  # one tile / a chain of two
def test_score_database_forms_equal_oracle(form, qlen):
    rng = np.random.default_rng(qlen + len(form))
    db = _db(rng, 30, hi=140)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    targets = {"list": db.as_list(), "encoded_db": db, "mat_lens": (db.mat, db.lens)}[form]
    bank = ScoreBank(backend="pallas", device="cpu", verify_integrity=True)
    res = bank.score_database(query, targets)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, db.as_list()))
    assert res.scores.dtype == np.int32 and res.scores[2] == res.scores[5] == 0
    assert res.cells == qlen * int(db.lens.sum())
    qw = -(-qlen // 8) * 8
    assert res.padded_cells == qw * sum(
        int(((db.lens > lo) & (db.lens <= hi)).sum()) * hi
        for lo, hi in ((-1, 32), (32, 128), (128, 512))
    )


def test_verify_integrity_catches_a_corrupt_batch(monkeypatch):
    import swtpu_torch.bank.scorebank as sb

    real = sb.pack_many_vs_one

    def corrupt(*a, **k):
        batches = real(*a, **k)
        batches[0].t[0, 0] = 9
        return batches

    monkeypatch.setattr(sb, "pack_many_vs_one", corrupt)
    rng = np.random.default_rng(6)
    db = _db(rng, 10)
    bank = ScoreBank(backend="pallas", device="cpu", verify_integrity=True)
    with pytest.raises(guards.IntegrityError, match=r"target\[0,0\] = 9"):
        bank.score_database(np.zeros(12, np.int8), db)


def test_score_pairs_long_query_equals_oracle(tmp_path):
    """Pairs grouped by (query bucket, target bucket); one query of 300
    bases chains two 256-row tiles."""
    rng = np.random.default_rng(7)
    qlens = [300, 20, 0, 100, 40, 300, 8]
    tlens = [50, 10, 30, 0, 120, 200, 8]
    queries = [rng.integers(0, 4, size=k).astype(np.int8) for k in qlens]
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in tlens]
    log = EventLog(tmp_path / "events.jsonl")
    res = ScoreBank(backend="pallas", device="cpu").score_pairs(
        queries, targets, event_log=log)
    log.close()
    want = [sw_score_single(q, t) for q, t in zip(queries, targets)]
    np.testing.assert_array_equal(res.scores, want)
    assert res.cells == sum(a * b for a, b in zip(qlens, tlens))
    events = EventLog.parse(tmp_path / "events.jsonl")
    assert {e.kind for e in events} == {"pair_batch"}
    assert sum(e.reads for e in events) == len(queries)
    assert "q_width=512 t_width=512" in {e.note for e in events}
    with pytest.raises(ValueError, match="must pair up"):
        ScoreBank(backend="pallas", device="cpu").score_pairs(queries, targets[:3])


def test_score_pairs_equal_swtpu_pallas():
    rng = np.random.default_rng(8)
    queries = [rng.integers(0, 4, size=k).astype(np.int8) for k in (12, 40, 30, 9)]
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in (30, 20, 100, 0)]
    buckets = dict(target_buckets=(32, 128), query_buckets=(16, 64))
    got = ScoreBank(SWConfig(**buckets), backend="pallas", device="cpu").score_pairs(
        queries, targets)
    want = RefBank(RefConfig(**buckets), backend="pallas", interpret=True).score_pairs(
        queries, targets)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)


def test_scorebank_score_width_routes_biased():
    """Ported from tests/test_biased.py: score_width resolves 'auto' to the
    column kernels, whose wrap-parity reproduces the RTL's 8-bit overflow."""
    rng = np.random.default_rng(5)
    query = np.tile(np.arange(4, dtype=np.int8), 10)  # 40 bases, scores 200
    targets = [rng.integers(0, 4, size=rng.integers(8, 32)).astype(np.int8)
               for _ in range(6)]
    targets.append(query.copy())  # exact self-match: 200 > an 8-bit ceiling
    bank = ScoreBank(SWConfig(score_width=8, target_buckets=(40,)), device="cpu")
    assert bank.backend == "pallas"
    got = bank.score_database(query, targets).scores
    want = np.array(
        [sw_score_single_biased(query, t, score_width=8) for t in targets],
        dtype=np.int32,
    )
    np.testing.assert_array_equal(got, want)
    exact = sw_score_single(query, query)
    assert exact == 200 and got[-1] < exact  # wrapped, not the exact score


def test_score_pairs_score_width_equals_biased_oracle():
    """The RTL's 12-bit width with custom penalties: an identical 300-base
    pair (1500 exactly) fits; at 10 bits it wraps across the two tiles."""
    rng = np.random.default_rng(9)
    pen = Penalties(match=5, mismatch=-4, gap_open=-10, gap_extend=-2)
    seq = rng.integers(0, 4, size=300).astype(np.int8)
    queries = [seq, rng.integers(0, 4, size=60).astype(np.int8), seq[:50]]
    targets = [seq.copy(), rng.integers(0, 4, size=90).astype(np.int8), seq[10:40]]
    for width in (12, 10):
        bank = ScoreBank(SWConfig(penalties=pen, score_width=width), device="cpu")
        got = bank.score_pairs(queries, targets).scores
        want = [sw_score_single_biased(q, t, pen, width) for q, t in zip(queries, targets)]
        np.testing.assert_array_equal(got, want)
        assert (got[0] == 1500) == (width == 12)

"""The port's main path end to end: swtpu_torch ScoreBank.score_database
against swtpu's stream-backend ScoreBank (interpret mode) and the oracle."""

import numpy as np
import pytest
import torch

from swtpu.bank import ScoreBank as RefBank
from swtpu.bank import ScoreResult as RefResult
from swtpu.bank import streams as ref_streams
from swtpu.config import Penalties as RefPenalties
from swtpu.config import SWConfig as RefConfig
from swtpu.io.loader import EncodedDB as RefEncodedDB
from swtpu.ops.pallas_stream import sw_scores_stream_long as ref_stream_long
from swtpu.oracle import score_many_vs_one
from swtpu.utils.guards import IntegrityError as RefIntegrityError
from swtpu.utils.guards import check_stream_batch as ref_check_stream_batch
from swtpu_torch.bank import ScoreBank, ScoreResult
from swtpu_torch.bank.scorebank import stream_geometry
from swtpu_torch.bank.streams import pack_streams
from swtpu_torch.config import Penalties, SWConfig
from swtpu_torch.io.loader import EncodedDB
from swtpu_torch.ops.column import sw_scores_column
from swtpu_torch.utils.guards import IntegrityError, check_scores, check_stream_batch
from swtpu_torch.utils.metrics import EventLog

torch.set_num_threads(1)


def _db(rng, n, hi=90):
    """EncodedDB with reads 2 and 5 zero-length."""
    lens = rng.integers(1, hi, size=n).astype(np.int32)
    lens[[2, 5]] = 0
    mat = rng.integers(0, 4, size=(n, hi)).astype(np.int8)
    mat[np.arange(hi)[None, :] >= lens[:, None]] = 4
    return EncodedDB([f"db{i}" for i in range(n)], mat, lens)


@pytest.mark.parametrize("qlen", [20, 60, 128])  # segments 4 / 2 / 1
def test_score_database_equals_swtpu_and_oracle(qlen):
    rng = np.random.default_rng(qlen)
    db = _db(rng, 40)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    reads = db.as_list()
    got = ScoreBank(device="cpu").score_database(query, reads)
    want = RefBank(backend="stream", interpret=True).score_database(query, reads)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, reads))
    assert got.scores.dtype == np.int32
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)
    assert got.scores[2] == got.scores[5] == 0


@pytest.mark.parametrize("form", ["encoded_db", "mat_lens"])
def test_dense_forms_equal_ragged_list(form):
    rng = np.random.default_rng(7)
    db = _db(rng, 60)
    query = rng.integers(0, 4, size=45).astype(np.int8)
    targets = db if form == "encoded_db" else (db.mat, db.lens)
    bank = ScoreBank(device="cpu")
    got = bank.score_database(query, targets)
    ragged = bank.score_database(query, db.as_list())
    np.testing.assert_array_equal(got.scores, ragged.scores)
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, db.as_list()))
    assert got.cells == ragged.cells == 45 * int(db.lens.sum())


def test_custom_penalties_and_config_rows():
    rng = np.random.default_rng(8)
    db = _db(rng, 30)
    query = rng.integers(0, 4, size=100).astype(np.int8)
    pen = Penalties(match=3, mismatch=-2, gap_open=-5, gap_extend=-1)
    bank = ScoreBank(SWConfig(penalties=pen, stream_rows=16), device="cpu")
    got = bank.score_database(query, db)
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, db.as_list(), pen))


def test_top_k_is_stable_on_ties():
    rng = np.random.default_rng(9)
    base = [rng.integers(0, 4, size=30).astype(np.int8) for _ in range(4)]
    reads = [base[i % 4] for i in range(16)]  # every score four times
    query = base[1][:25].copy()
    res = ScoreBank(device="cpu").score_database(query, reads)
    top = res.top_k(6)
    assert top == RefResult(res.scores, 0, 0, 1.0).top_k(6)
    assert [i for _, i in top[:4]] == [1, 5, 9, 13]  # ties keep read order
    assert [s for s, _ in top] == sorted((s for s, _ in top), reverse=True)
    assert isinstance(res, ScoreResult) and res.gcups > 0


def test_verify_integrity_and_guards():
    rng = np.random.default_rng(10)
    db = _db(rng, 30)
    query = rng.integers(0, 4, size=33).astype(np.int8)
    got = ScoreBank(device="cpu", verify_integrity=True).score_database(query, db)
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, db.as_list()))
    b = pack_streams(query, db.as_list(), n_streams=8, segments=2)
    check_stream_batch(b)
    bad = [("stream", (1, 3), 7), ("q", (0, 2), 9), ("emit_stream", (4,), 99),
           ("emit_step", (4,), 10**6)]
    for field, at, value in bad:
        arr = getattr(b, field).copy()
        arr[at] = value
        broken = type(b)(**{**b.__dict__, field: arr})
        with pytest.raises(IntegrityError) as e:
            check_stream_batch(broken)
        with pytest.raises(RefIntegrityError) as e_ref:
            ref_check_stream_batch(broken)
        assert str(e.value) == str(e_ref.value)
    with pytest.raises(IntegrityError, match="exceeds bound"):
        check_scores(np.array([0, 60]), [10, 10], [10, 10], 5)
    with pytest.raises(IntegrityError, match="negative"):
        check_scores(np.array([-1]), [10], [10], 5)


def test_event_log_record(tmp_path):
    rng = np.random.default_rng(11)
    db = _db(rng, 20)
    query = rng.integers(0, 4, size=70).astype(np.int8)
    log = EventLog(tmp_path / "events.jsonl")
    res = ScoreBank(device="cpu").score_database(query, db, event_log=log)
    log.close()
    (ev,) = EventLog.parse(tmp_path / "events.jsonl")
    assert ev.kind == "stream"
    assert (ev.reads, ev.cells, ev.padded_cells) == (20, res.cells, res.padded_cells)
    assert ev.note.startswith("streams=8 T=")


@pytest.mark.parametrize("qlen", [20, 140])
def test_scan_backend_equals_the_stream_backend_and_swtpu(qlen):
    """backend="scan" (the bucketed batches through the column scan) on
    the CPU: the stream backend's scores on the same reads, and swtpu's
    scan bank's, at a one-tile and a longer query."""
    rng = np.random.default_rng(qlen)
    db = _db(rng, 25)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    got = ScoreBank(backend="scan", device="cpu").score_database(query, db)
    np.testing.assert_array_equal(
        got.scores, ScoreBank(backend="stream", device="cpu").score_database(query, db).scores)
    want = RefBank(backend="scan").score_database(query, RefEncodedDB(db.names, db.mat, db.lens))
    np.testing.assert_array_equal(got.scores, want.scores)
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)
    with pytest.raises(ValueError, match="unknown backend 'lane'"):
        ScoreBank(backend="lane", device="cpu")


# the wavefront's 16-bit states on the stream backend, each at penalties it
# takes (uint16 refuses the default open penalty; at mismatch -4 it wraps)
BANK_STATES = {
    "int16": ("int16", Penalties()),
    "uint16": ("uint16", Penalties(5, 0, 0, 0)),
    "uint16 wrap": ("uint16", Penalties(5, -4, 0, 0)),
    "bfloat16": ("bfloat16", Penalties()),
}


@pytest.mark.parametrize("qlen", [60, 200])
@pytest.mark.parametrize("mode", list(BANK_STATES))
def test_score_database_16bit_states_equal_swtpu(mode, qlen):
    """score_database in each 16-bit state on the CPU (rows 1, swtpu's
    interpret geometry) against swtpu: the stream backend in interpret mode
    for a short query; for a long one swtpu's chain on the same packed
    batch at a 2-step chunk (its bank's 8-step bfloat16 tile takes XLA
    minutes to compile; the packing is held field for field in
    test_torch_stream_long.py).  Reads 4 and 9 are the query itself, so
    bfloat16 rounds them."""
    dtype, pen = BANK_STATES[mode]
    rng = np.random.default_rng(qlen + 40)
    db = _db(rng, 30)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    reads = db.as_list()
    reads[4] = reads[9] = query.copy()
    got = ScoreBank(SWConfig(stream_state_dtype=dtype, penalties=pen), device="cpu")
    got = got.score_database(query, reads).scores
    ref_cfg = RefConfig(stream_state_dtype=dtype, penalties=RefPenalties(*pen.astuple()))
    if qlen <= 128:
        want = RefBank(ref_cfg, backend="stream", interpret=True).score_database(query, reads)
        want = want.scores
    else:
        b = ref_streams.pack_streams_long(query, reads, n_streams=8, rows=1)
        want = ref_stream_long(b.q, b.stream, b.emit_stream,
                               b.emit_step.astype(np.int32), ref_cfg.penalties,
                               interpret=True, state_dtype=dtype, rows=1, chunk=2)
    np.testing.assert_array_equal(got, np.asarray(want))
    exact = score_many_vs_one(query, reads, pen)
    if mode in ("int16", "uint16"):
        np.testing.assert_array_equal(got, exact)
    elif mode == "bfloat16":
        assert got[4] == got[9] < exact[4] == 5 * qlen
    else:  # every read that has a mismatch wraps; an empty one scores 0
        assert all(s >= 65532 if len(r) else s == 0 for s, r in zip(got, reads))


@pytest.mark.parametrize("mode", list(BANK_STATES))
def test_score_pairs_16bit_states_equal_swtpu(mode):
    """score_pairs in each 16-bit state: short queries on the pair streams
    against swtpu's stream backend in interpret mode; with a long query
    added, its pairs equal the port's own score_database on them (held
    against swtpu above)."""
    dtype, pen = BANK_STATES[mode]
    rng = np.random.default_rng(41)
    qs = [rng.integers(0, 4, size=k).astype(np.int8) for k in (40, 90, 128)]
    queries = [qs[i] for i in rng.integers(0, 3, size=24)]
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(0, 100, 24)]
    targets[0] = queries[0].copy()
    bank = ScoreBank(SWConfig(stream_state_dtype=dtype, penalties=pen), device="cpu")
    got = bank.score_pairs(queries, targets)
    ref_cfg = RefConfig(stream_state_dtype=dtype, penalties=RefPenalties(*pen.astuple()))
    want = RefBank(ref_cfg, backend="stream", interpret=True).score_pairs(queries, targets)
    np.testing.assert_array_equal(got.scores, want.scores)
    long_q = rng.integers(0, 4, size=150).astype(np.int8)
    mixed = bank.score_pairs(queries + [long_q] * 3, targets + targets[:2] + [long_q])
    np.testing.assert_array_equal(mixed.scores[:24], got.scores)
    np.testing.assert_array_equal(
        mixed.scores[24:], bank.score_database(long_q, targets[:2] + [long_q]).scores)


def test_uint16_at_default_penalties_raises_as_swtpu():
    """uint16 state cannot hold the default open penalty: score_pairs and
    score_database raise swtpu's OverflowError."""
    cfg = dict(stream_state_dtype="uint16")
    q, t = [np.zeros(9, np.int8)], [np.zeros(9, np.int8)]
    with pytest.raises(OverflowError) as got:
        ScoreBank(SWConfig(**cfg), device="cpu").score_pairs(q, t)
    with pytest.raises(OverflowError) as want:
        RefBank(RefConfig(**cfg), backend="stream", interpret=True).score_pairs(q, t)
    assert str(got.value) == str(want.value) == "Python integer -12 out of bounds for uint16"
    with pytest.raises(OverflowError, match="-12 out of bounds for uint16"):
        ScoreBank(SWConfig(**cfg), device="cpu").score_database(np.zeros(200, np.int8), t)


@pytest.mark.parametrize("state_dtype", ["float32", "int16"])
def test_column_exact_states_equal_int32(state_dtype):
    """sw_scores_column in float32 and int16 state gives int32's scores
    (swtpu's kernels in these states: test_torch_column_ops.py)."""
    rng = np.random.default_rng(42)
    q = torch.from_numpy(rng.integers(0, 4, size=(5, 40)).astype(np.int8))
    t = torch.from_numpy(rng.integers(0, 4, size=(5, 70)).astype(np.int8))
    np.testing.assert_array_equal(sw_scores_column(q, t, state_dtype=state_dtype).numpy(),
                                  sw_scores_column(q, t).numpy())


@pytest.mark.parametrize(
    "qlen,device,config,want",
    [
        (20, "cuda", SWConfig(), (4, 4, 512)),
        (32, "cuda", SWConfig(), (4, 4, 512)),
        (33, "cuda", SWConfig(), (2, 8, 512)),
        (64, "cuda", SWConfig(), (2, 8, 512)),
        (128, "cuda", SWConfig(), (1, 16, 512)),
        (128, "cuda", SWConfig(stream_rows=4, stream_phys=1024), (1, 4, 1024)),
        (129, "cuda", SWConfig(), (1, 16, 512)),
        (4095, "cuda", SWConfig(stream_phys=256), (1, 16, 256)),
        (20, "cpu", SWConfig(), (4, 1, 8)),
        (300, "cpu", SWConfig(), (1, 1, 8)),
        (128, "cpu", SWConfig(stream_rows=16, stream_phys=1024), (1, 16, 8)),
    ],
)
def test_stream_geometry(qlen, device, config, want):
    """swtpu's device settings on CUDA and its interpret settings on the
    CPU; needs no card, since it only reads the device's type."""
    assert stream_geometry(qlen, config, device) == want


@pytest.mark.parametrize("form", ["list", "encoded_db"])
@pytest.mark.parametrize("qlen", [129, 256, 300])  # K = 2 / 2 / 3 tiles
def test_long_query_equals_swtpu_and_oracle(qlen, form, tmp_path):
    rng = np.random.default_rng(qlen + len(form))
    db = _db(rng, 40)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    targets = db if form == "encoded_db" else db.as_list()
    log = EventLog(tmp_path / "events.jsonl")
    got = ScoreBank(device="cpu").score_database(query, targets, event_log=log)
    log.close()
    if form == "encoded_db":
        targets = RefEncodedDB(db.names, db.mat, db.lens)
    want = RefBank(backend="stream", interpret=True).score_database(query, targets)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, db.as_list()))
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)
    assert got.cells == qlen * int(db.lens.sum())
    assert got.scores[2] == got.scores[5] == 0
    (ev,) = EventLog.parse(tmp_path / "events.jsonl")
    assert (ev.kind, ev.reads, ev.cells, ev.padded_cells) == (
        "stream_long", 40, got.cells, got.padded_cells
    )
    assert ev.note.startswith("streams=8 T=") and ev.note.endswith(f"tiles={-(-qlen // 128)}")


def test_long_query_settings():
    """Custom penalties, rows from the config, verify_integrity; the long
    path ignores stream_chunk_reads, as swtpu's does."""
    rng = np.random.default_rng(12)
    db = _db(rng, 30)
    query = rng.integers(0, 4, size=210).astype(np.int8)
    pen = Penalties(match=3, mismatch=-2, gap_open=-5, gap_extend=-1)
    cfg = SWConfig(penalties=pen, stream_rows=4, stream_chunk_reads=4)
    got = ScoreBank(cfg, device="cpu", verify_integrity=True).score_database(query, db)
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, db.as_list(), pen))


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoreBank(device="cuda")


"""The port's main path end to end: swtpu_torch ScoreBank.score_database
against swtpu's stream-backend ScoreBank (interpret mode) and the oracle."""

import numpy as np
import pytest
import torch

from swtpu.bank import ScoreBank as RefBank
from swtpu.bank import ScoreResult as RefResult
from swtpu.io.loader import EncodedDB as RefEncodedDB
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


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: ScoreBank(SWConfig(stream_state_dtype="bfloat16"), backend="stream",
                           device="cpu").score_database(np.zeros(9, np.int8),
                                                        [np.zeros(9, np.int8)]),
         "'bfloat16' is not ported yet \\(ROADMAP item 20"),
        (lambda: ScoreBank(backend="scan", device="cpu"), "scan"),
        (lambda: ScoreBank(SWConfig(stream_chunk_reads=2), device="cpu").score_database(
            np.zeros(9, np.int8), [np.zeros(9, np.int8)] * 3), "chunked"),
        (lambda: ScoreBank(SWConfig(stream_state_dtype="int16"), device="cpu").score_database(
            np.zeros(200, np.int8), [np.zeros(9, np.int8)]), "'int16' is not ported yet"),
        (lambda: ScoreBank(SWConfig(stream_state_dtype="uint16"), device="cpu").score_pairs(
            [np.zeros(9, np.int8)], [np.zeros(9, np.int8)]), "ROADMAP item 20"),
        (lambda: sw_scores_column(torch.zeros((2, 8), dtype=torch.int8),
                                  torch.zeros((2, 8), dtype=torch.int8),
                                  state_dtype="float32"), "float32"),
    ],
)
def test_unported_settings_raise(make, match):
    with pytest.raises(NotImplementedError, match=match):
        make()


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


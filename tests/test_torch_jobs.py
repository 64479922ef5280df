"""The port's job layer on the CPU: the chunked stream dispatch, callable
backends, resumable jobs (and the state file the two packages share),
seeded fault injection, GcupsMeter, profile_trace, score_streams and the
golden-file parsers, each against swtpu and the oracle.  Tolerance 0
throughout: every score is an integer and must be equal."""

import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

import swtpu.ops.pallas_stream as ref_pallas_stream
from swtpu.bank import ScoreBank as RefBank
from swtpu.bank import resume as ref_resume
from swtpu.bank.streams import score_streams as ref_score_streams
from swtpu.config import SWConfig as RefConfig
from swtpu.io.loader import EncodedDB as RefEncodedDB
from swtpu.ops.scan import sw_scores_scan
from swtpu.oracle import score_many_vs_one, sw_score_single_biased
from swtpu.testing import faults as ref_faults
from swtpu.testing import goldens as ref_goldens
from swtpu.utils.metrics import GcupsMeter as RefGcupsMeter
from swtpu_torch.bank import ScoreBank
from swtpu_torch.bank import resume
from swtpu_torch.bank import scorebank as bank_mod
from swtpu_torch.bank.streams import score_streams
from swtpu_torch.config import SWConfig
from swtpu_torch.io.loader import EncodedDB
from swtpu_torch.ops.column import sw_scores_column
from swtpu_torch.testing import faults, goldens
from swtpu_torch.utils import guards
from swtpu_torch.utils.guards import IntegrityError
from swtpu_torch.utils.metrics import BatchEvent, EventLog, GcupsMeter, profile_trace

torch.set_num_threads(1)

BUCKETS = (32, 128, 256)


def _reads(rng, n, lo=0, hi=70):
    return [rng.integers(0, 4, size=k).astype(np.int8) for k in rng.integers(lo, hi, size=n)]


def _dense(reads):
    w = max(max(len(t) for t in reads), 1)
    mat = np.full((len(reads), w), 4, np.int8)
    lens = np.array([len(t) for t in reads], np.int32)
    for i, t in enumerate(reads):
        mat[i, : len(t)] = t
    return mat, lens


def _form(reads, form, ref=False):
    """`reads` as a list, an EncodedDB (of either package) or (mat, lens)."""
    if form == "list":
        return reads
    mat, lens = _dense(reads)
    if form == "encoded":
        return (RefEncodedDB if ref else EncodedDB)([f"db{i}" for i in range(len(reads))],
                                                    mat, lens)
    return mat, lens


def _counting(monkeypatch, module, name, fail_after=None):
    """Count the calls of module.name; with `fail_after`, each call past
    that many raises (a job killed mid-run)."""
    real = getattr(module, name)
    calls = {"n": 0}

    def wrapped(*a, **kw):
        calls["n"] += 1
        if fail_after is not None and calls["n"] > fail_after:
            raise RuntimeError("simulated crash")
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def _port_column(q, t, pen):
    """A callable backend: the column kernels' plain version."""
    return sw_scores_column(torch.from_numpy(q), torch.from_numpy(t), pen).numpy()


def _scan(q, t, pen):
    return np.asarray(sw_scores_scan(q, t, pen))


# ---------------------------------------------------------------- chunked


@pytest.mark.parametrize("chunk", [3, 8, 29])
@pytest.mark.parametrize("qlen", [20, 100])  # segments 4 / segments 1
@pytest.mark.parametrize("form", ["list", "encoded", "mat_lens"])
def test_chunked_equals_one_shot_and_oracle(form, qlen, chunk):
    rng = np.random.default_rng(qlen + chunk)
    reads = _reads(rng, 30)
    reads[4] = reads[4][:0]
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    targets = _form(reads, form)
    log = EventLog()
    res = ScoreBank(SWConfig(stream_chunk_reads=chunk), device="cpu").score_database(
        query, targets, event_log=log)
    one = ScoreBank(device="cpu").score_database(query, targets)
    np.testing.assert_array_equal(res.scores, one.scores)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, reads))
    assert res.scores.dtype == np.int32 and res.cells == one.cells
    (ev,) = log.events
    assert (ev.kind, ev.reads, ev.cells, ev.padded_cells) == (
        "stream_pipelined", 30, res.cells, res.padded_cells)
    streams = 8 * (4 if qlen <= 32 else 1)
    assert ev.note == f"chunks={-(-30 // chunk)} chunk_reads={chunk} streams={streams}"


def test_chunking_off_at_or_above_the_read_count():
    rng = np.random.default_rng(1)
    reads = _reads(rng, 12)
    query = rng.integers(0, 4, size=40).astype(np.int8)
    for chunk in (12, 13):
        log = EventLog()
        ScoreBank(SWConfig(stream_chunk_reads=chunk), device="cpu").score_database(
            query, reads, event_log=log)
        assert [e.kind for e in log.events] == ["stream"]


@pytest.mark.parametrize("chunk", [0, 4])
def test_empty_database_is_one_empty_chunk(chunk):
    """No reads: one empty chunk, with or without chunks, as swtpu's."""
    query = np.array([0, 1, 2, 3] * 5, np.int8)
    ref_log, log = EventLog(), EventLog()
    want = RefBank(RefConfig(stream_chunk_reads=chunk), backend="stream",
                   interpret=True).score_database(query, [], event_log=ref_log)
    got = ScoreBank(SWConfig(stream_chunk_reads=chunk), device="cpu").score_database(
        query, [], event_log=log)
    assert got.scores.dtype == want.scores.dtype == np.int32 and len(got.scores) == 0
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)
    assert [(e.kind, e.note) for e in log.events] == [(e.kind, e.note) for e in ref_log.events]


@pytest.mark.parametrize("form", ["list", "mat_lens"])
def test_chunked_equals_swtpu_chunked(form):
    """Scores and cells equal swtpu's chunked path; padded_cells counts
    each chunk's own stream length, never more than swtpu's power-of-two
    ladder."""
    rng = np.random.default_rng(20)
    reads = _reads(rng, 29, 2, 70)
    query = rng.integers(0, 4, size=50).astype(np.int8)
    ref_log, log = EventLog(), EventLog()
    want = RefBank(RefConfig(stream_chunk_reads=8), backend="stream",
                   interpret=True).score_database(query, _form(reads, form), event_log=ref_log)
    got = ScoreBank(SWConfig(stream_chunk_reads=8), device="cpu").score_database(
        query, _form(reads, form), event_log=log)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.cells == want.cells
    assert got.padded_cells <= want.padded_cells
    # each chunk keeps its own T: the sum of the chunks' one-shot padding
    one = ScoreBank(device="cpu")
    assert got.padded_cells == sum(
        one.score_database(query, reads[lo : lo + 8]).padded_cells for lo in range(0, 29, 8))
    assert (log.events[0].kind, log.events[0].note) == (ref_log.events[0].kind,
                                                       ref_log.events[0].note)


def test_chunked_verify_integrity_checks_every_chunk(monkeypatch):
    rng = np.random.default_rng(2)
    reads = _reads(rng, 20)
    query = rng.integers(0, 4, size=40).astype(np.int8)
    batches = _counting(monkeypatch, guards, "check_stream_batch")
    scores = _counting(monkeypatch, guards, "check_scores")
    bank = ScoreBank(SWConfig(stream_chunk_reads=6), device="cpu", verify_integrity=True)
    res = bank.score_database(query, reads)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, reads))
    assert (batches["n"], scores["n"]) == (4, 1)


def test_chunked_guard_catches_a_corrupted_chunk(monkeypatch):
    """A flipped char in the third chunk's stream is caught before its
    dispatch."""
    rng = np.random.default_rng(3)
    reads = _reads(rng, 20, 5)
    query = rng.integers(0, 4, size=40).astype(np.int8)
    real = bank_mod.pack_streams
    calls = {"n": 0}

    def corrupting(*a, **kw):
        batch = real(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 3:
            batch.stream[0, 0] = 7  # neither a (flagged) code nor the pad
        return batch

    monkeypatch.setattr(bank_mod, "pack_streams", corrupting)
    bank = ScoreBank(SWConfig(stream_chunk_reads=6), device="cpu", verify_integrity=True)
    with pytest.raises(IntegrityError, match="stream\\[0,0\\] = 7"):
        bank.score_database(query, reads)


# ------------------------------------------------------- callable backend


def test_callable_backend_scores_the_bucketed_batches():
    rng = np.random.default_rng(4)
    reads = _reads(rng, 25, 5, 250)
    query = rng.integers(0, 4, size=24).astype(np.int8)
    calls = []

    def fn(q, t, pen):
        calls.append(t.shape)
        return _port_column(q, t, pen)

    bank = ScoreBank(SWConfig(target_buckets=BUCKETS), backend=fn, device="cpu")
    assert bank.backend is fn
    log = EventLog()
    res = bank.score_database(query, reads, event_log=log)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, reads))
    ref = RefBank(RefConfig(target_buckets=BUCKETS), backend=_scan).score_database(query, reads)
    assert (res.cells, res.padded_cells) == (ref.cells, ref.padded_cells)
    assert [e.kind for e in log.events] == ["batch"] * len(calls) and len(calls) == 3
    queries = _reads(rng, 25, 1, 60)
    pairs = bank.score_pairs(queries, reads)
    want = [score_many_vs_one(q, [t])[0] for q, t in zip(queries, reads)]
    np.testing.assert_array_equal(pairs.scores, want)
    with pytest.raises(ValueError, match="requires the stream backend"):
        bank.load_database(reads)


# ------------------------------------------------------------ resume


@pytest.mark.parametrize("form", ["list", "encoded", "mat_lens"])
@pytest.mark.parametrize("width,extra", [(None, ""), (None, "stream/8"), (12, "stream/8")])
def test_fingerprint_equals_swtpu(form, width, extra):
    rng = np.random.default_rng(5)
    reads = _reads(rng, 9)
    query = rng.integers(0, 4, size=30).astype(np.int8)
    got = resume._fingerprint(query, _form(reads, form), SWConfig(score_width=width), extra)
    want = ref_resume._fingerprint(query, _form(reads, form, ref=True),
                                   RefConfig(score_width=width), extra)
    assert got == want and len(got) == 32
    assert resume.STATE_VERSION == ref_resume.STATE_VERSION
    assert got != resume._fingerprint(query[:-1], _form(reads, form), SWConfig(), extra)


def _workload(rng, n=25, hi=250):
    return rng.integers(0, 4, size=20).astype(np.int8), _reads(rng, n, 5, hi)


def test_resumable_bucketed_completes_and_resumes(tmp_path):
    rng = np.random.default_rng(0)
    query, targets = _workload(rng)
    want = score_many_vs_one(query, targets)
    cfg = SWConfig(target_buckets=BUCKETS)
    state = tmp_path / "job.npz"
    res = resume.score_database_resumable(ScoreBank(cfg, backend="pallas", device="cpu"),
                                          query, targets, state)
    np.testing.assert_array_equal(res.scores, want)
    assert state.exists()

    def poisoned(q, t, pen):
        raise AssertionError("batch scored again after it was done")

    res2 = resume.score_database_resumable(ScoreBank(cfg, backend=poisoned, device="cpu"),
                                           query, targets, state)
    np.testing.assert_array_equal(res2.scores, want)
    assert (res2.cells, res2.padded_cells) == (res.cells, res.padded_cells)


def test_resumable_bucketed_partial(tmp_path):
    rng = np.random.default_rng(1)
    query, targets = _workload(rng)
    state = tmp_path / "job.npz"
    calls = {"n": 0}

    def flaky(q, t, pen):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("simulated crash")
        return _port_column(q, t, pen)

    cfg = SWConfig(target_buckets=BUCKETS)
    with pytest.raises(RuntimeError, match="simulated crash"):
        resume.score_database_resumable(ScoreBank(cfg, backend=flaky, device="cpu"),
                                        query, targets, state)
    assert state.exists()
    res = resume.score_database_resumable(ScoreBank(cfg, backend="pallas", device="cpu"),
                                          query, targets, state)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))


@pytest.mark.parametrize("writer", ["swtpu", "port"])
def test_bucketed_state_crosses_between_packages(tmp_path, writer):
    """A bucketed job killed after its first batch by one package is
    finished by the other, which scores only the batches left."""
    rng = np.random.default_rng(11)
    query, targets = _workload(rng, 30)
    state = tmp_path / "job.npz"
    first, rest = {"n": 0}, {"n": 0}

    def flaky(score):
        def fn(q, t, pen):
            first["n"] += 1
            if first["n"] > 1:
                raise RuntimeError("simulated crash")
            return score(q, t, pen)
        return fn

    def counting(score):
        def fn(q, t, pen):
            rest["n"] += 1
            return score(q, t, pen)
        return fn

    ref_cfg, cfg = RefConfig(target_buckets=BUCKETS), SWConfig(target_buckets=BUCKETS)
    ref_run = lambda fn: ref_resume.score_database_resumable(  # noqa: E731
        RefBank(ref_cfg, backend=fn), query, targets, state)
    port_run = lambda fn: resume.score_database_resumable(  # noqa: E731
        ScoreBank(cfg, backend=fn, device="cpu"), query, targets, state)
    start, finish = (ref_run, port_run) if writer == "swtpu" else (port_run, ref_run)
    with pytest.raises(RuntimeError, match="simulated crash"):
        start(flaky(_scan if writer == "swtpu" else _port_column))
    res = finish(counting(_port_column if writer == "swtpu" else _scan))
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
    n_batches = len(ScoreBank(cfg, device="cpu")._bucket_batches(query, targets))
    assert n_batches > 1 and rest["n"] == n_batches - 1  # all but the first


@pytest.mark.parametrize("writer", ["swtpu", "port"])
def test_stream_state_crosses_between_packages(tmp_path, writer, monkeypatch):
    """A stream job of 3 chunks killed after its first by one package is
    finished by the other, which scores only the last two chunks; the
    totals equal an uninterrupted job's."""
    rng = np.random.default_rng(6)
    query, targets = _workload(rng, 20, 90)
    state = tmp_path / "job.npz"
    ref_bank = RefBank(RefConfig(), backend="stream", interpret=True)
    bank = ScoreBank(device="cpu")
    killed = (ref_pallas_stream, "sw_scores_stream") if writer == "swtpu" else (
        bank_mod, "sw_scores_stream")
    finisher = (bank_mod, "sw_scores_stream") if writer == "swtpu" else (
        ref_pallas_stream, "sw_scores_stream")
    start, finish = (ref_resume, ref_bank), (resume, bank)
    if writer == "port":
        start, finish = finish, start
    _counting(monkeypatch, *killed, fail_after=1)
    with pytest.raises(RuntimeError, match="simulated crash"):
        start[0].score_database_resumable(start[1], query, targets, state, chunk_reads=8)
    monkeypatch.undo()
    calls = _counting(monkeypatch, *finisher)
    res = finish[0].score_database_resumable(finish[1], query, targets, state, chunk_reads=8)
    monkeypatch.undo()
    assert calls["n"] == 2
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
    whole = resume.score_database_resumable(bank, query, targets, tmp_path / "whole.npz",
                                            chunk_reads=8)
    assert (res.cells, res.padded_cells) == (whole.cells, whole.padded_cells)


def test_state_file_fields_equal_swtpu(tmp_path):
    rng = np.random.default_rng(12)
    query, targets = _workload(rng, 12, 90)
    got, want = tmp_path / "port.npz", tmp_path / "ref.npz"
    resume.score_database_resumable(ScoreBank(device="cpu"), query, targets, got,
                                    chunk_reads=8)
    ref_resume._save_state(want, ref_resume._fingerprint(
        query, targets, RefConfig(), extra="stream/8"), 2,
        np.asarray(score_many_vs_one(query, targets), np.int32), np.ones(2, bool),
        np.load(got)["padded"])
    a, b = np.load(got), np.load(want)
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_resume_stream_completes_and_skips_done_chunks(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    query, targets = _workload(rng, 21, 90)
    want = score_many_vs_one(query, targets)
    bank = ScoreBank(device="cpu")
    state = tmp_path / "job.npz"
    res = resume.score_database_resumable(bank, query, targets, state, chunk_reads=8)
    np.testing.assert_array_equal(res.scores, want)
    assert res.cells == len(query) * sum(len(t) for t in targets)
    calls = _counting(monkeypatch, bank_mod, "sw_scores_stream", fail_after=0)
    res2 = resume.score_database_resumable(bank, query, targets, state, chunk_reads=8)
    assert calls["n"] == 0
    np.testing.assert_array_equal(res2.scores, want)
    assert (res2.cells, res2.padded_cells) == (res.cells, res.padded_cells)


def test_resume_stream_interrupt_midjob(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    query, targets = _workload(rng, 20, 90)
    state = tmp_path / "job.npz"
    bank = ScoreBank(device="cpu")
    _counting(monkeypatch, bank_mod, "sw_scores_stream", fail_after=1)
    with pytest.raises(RuntimeError, match="simulated crash"):
        resume.score_database_resumable(bank, query, targets, state, chunk_reads=8)
    monkeypatch.undo()
    assert state.exists()
    calls = _counting(monkeypatch, bank_mod, "sw_scores_stream")
    res = resume.score_database_resumable(bank, query, targets, state, chunk_reads=8)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
    assert calls["n"] == 2  # 20 reads in chunks of 8: the first was done


@pytest.mark.parametrize("change", ["query", "chunk_reads", "version"])
def test_resume_stream_stale_state_restarts(tmp_path, monkeypatch, change):
    """A state file of another job (query, unit size or format version) is
    not adopted: every chunk is scored again."""
    rng = np.random.default_rng(7)
    query, targets = _workload(rng, 12, 90)
    state = tmp_path / "job.npz"
    bank = ScoreBank(device="cpu")
    resume.score_database_resumable(bank, query, targets, state, chunk_reads=8)
    chunk = 8
    if change == "query":
        query = rng.integers(0, 4, size=20).astype(np.int8)
    elif change == "chunk_reads":
        chunk = 6
    else:
        st = dict(np.load(state))
        st["version"] = resume.STATE_VERSION + 1
        np.savez(state, **st)
    calls = _counting(monkeypatch, bank_mod, "sw_scores_stream")
    res = resume.score_database_resumable(bank, query, targets, state, chunk_reads=chunk)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
    assert calls["n"] == -(-12 // chunk)


def test_resume_stream_dense_form(tmp_path):
    rng = np.random.default_rng(8)
    query = rng.integers(0, 4, size=20).astype(np.int8)
    mat = rng.integers(0, 4, size=(19, 40)).astype(np.int8)
    lens = rng.integers(5, 41, size=19).astype(np.int32)
    want = score_many_vs_one(query, [mat[i, : lens[i]] for i in range(19)])
    res = resume.score_database_resumable(ScoreBank(device="cpu"), query, (mat, lens),
                                          tmp_path / "job.npz", chunk_reads=8)
    np.testing.assert_array_equal(res.scores, want)


def test_resume_state_voided_by_score_width(tmp_path):
    """An exact job's state is not adopted by a wrap-parity job."""
    rng = np.random.default_rng(9)
    query = np.tile(np.arange(4, dtype=np.int8), 10)  # 40 bases
    targets = [query.copy(), rng.integers(0, 4, size=30).astype(np.int8)]
    state = tmp_path / "job.npz"
    r1 = resume.score_database_resumable(ScoreBank(device="cpu"), query, targets, state,
                                         chunk_reads=8)
    assert r1.scores[0] == 200
    want = [sw_score_single_biased(query, t, score_width=7) for t in targets]
    assert want[0] != 200
    r2 = resume.score_database_resumable(
        ScoreBank(SWConfig(score_width=7), backend="stream", device="cpu"), query, targets,
        state, chunk_reads=8)
    np.testing.assert_array_equal(r2.scores, want)


def test_resume_stream_default_unit(tmp_path, monkeypatch):
    """On the CPU the default unit is swtpu's interpret-mode 8 reads."""
    rng = np.random.default_rng(10)
    query, targets = _workload(rng, 17, 90)
    calls = _counting(monkeypatch, bank_mod, "sw_scores_stream")
    res = resume.score_database_resumable(ScoreBank(device="cpu"), query, targets,
                                          tmp_path / "job.npz")
    assert calls["n"] == 3 and resume.CHUNK_READS_CPU == 8
    assert resume.CHUNK_READS_CUDA == 1 << 18
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))


# ------------------------------------------------------------ faults

FAULTS = {
    "reorder_drop": dict(seed=7, reorder_percent=100, drop_percent=40, delay_ms_max=1),
    "seed_11": dict(seed=11, reorder_percent=60, drop_percent=25),
    "corrupt_scores": dict(seed=3, reorder_percent=50, corrupt_percent=50,
                           corrupt_kind="scores"),
}


@pytest.mark.parametrize("name", list(FAULTS))
def test_fault_injector_equals_swtpu(name):
    """The same seed over the same batches injects the same faults, and
    the scores land in read order."""
    rng = np.random.default_rng(0)
    targets = _reads(rng, 41, 5, 250)
    query = rng.integers(0, 4, size=24).astype(np.int8)
    got, inj = faults.score_database_with_faults(
        ScoreBank(SWConfig(target_buckets=BUCKETS), backend="pallas", device="cpu"),
        query, targets, faults.FaultConfig(**FAULTS[name]))
    want, ref_inj = ref_faults.score_database_with_faults(
        RefBank(RefConfig(target_buckets=BUCKETS), backend="scan"), query, targets,
        ref_faults.FaultConfig(**FAULTS[name]))
    np.testing.assert_array_equal(got, want)
    counts = ("injected_drops", "injected_reorders", "injected_corruptions")
    assert [getattr(inj, c) for c in counts] == [getattr(ref_inj, c) for c in counts]
    if name == "corrupt_scores":
        assert inj.injected_corruptions > 0
    else:
        np.testing.assert_array_equal(got, score_many_vs_one(query, targets))
    if name == "reorder_drop":
        assert inj.injected_drops > 0


@pytest.mark.parametrize("kind,match", [("codes", "not a base code"),
                                        ("scores", "exceeds bound")])
def test_corruption_is_caught_by_the_guards(kind, match):
    rng = np.random.default_rng(1)
    targets = _reads(rng, 20, 5, 120)
    query = rng.integers(0, 4, size=24).astype(np.int8)
    bank = ScoreBank(SWConfig(target_buckets=BUCKETS), backend="pallas", device="cpu",
                     verify_integrity=True)
    cfg = faults.FaultConfig(seed=5, corrupt_percent=100, corrupt_kind=kind)
    with pytest.raises(IntegrityError, match=match):
        faults.score_database_with_faults(bank, query, targets, cfg)


def test_every_drop_is_retried():
    """A submission dropped max_retries times in a row runs on its last
    attempt: each batch is dropped that often and still scored."""
    rng = np.random.default_rng(2)
    targets = _reads(rng, 10, 5, 250)
    query = rng.integers(0, 4, size=24).astype(np.int8)
    bank = ScoreBank(SWConfig(target_buckets=BUCKETS), backend="pallas", device="cpu")
    scores, inj = faults.score_database_with_faults(
        bank, query, targets, faults.FaultConfig(drop_percent=100, max_retries=3))
    np.testing.assert_array_equal(scores, score_many_vs_one(query, targets))
    assert inj.injected_drops == 3 * len(bank._bucket_batches(query, targets))


# ------------------------------------------------- metrics and helpers


def test_gcups_meter_equals_swtpu(monkeypatch):
    clock = itertools.count(0.0, 0.25)
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    meters = []
    for meter in (GcupsMeter(), RefGcupsMeter()):
        for cells, padded, reads in ((1000, 4000, 10), (500, 1000, 3)):
            with meter.batch(cells=cells, padded_cells=padded, reads=reads):
                pass
        meters.append(meter)
    got, want = meters
    fields = ("cells", "padded_cells", "reads", "elapsed_s", "gcups", "reads_per_s",
              "pad_efficiency")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert (got.cells, got.pad_efficiency, got.elapsed_s) == (1500, 0.3, 0.5)
    assert GcupsMeter().gcups == GcupsMeter().pad_efficiency == 0.0


def test_event_log_roundtrip(tmp_path):
    path = tmp_path / "events.jsonl"
    log = EventLog(path)
    log.emit(BatchEvent("batch", 0.0, 0.5, reads=10, cells=1000, padded_cells=2000))
    log.emit(BatchEvent("job", 1.0, 2.0, reads=100, cells=99999, padded_cells=120000,
                        note="done"))
    log.close()
    back = EventLog.parse(path)
    assert [dataclasses.asdict(e) for e in back] == [dataclasses.asdict(e) for e in log.events]
    assert json.loads(path.read_text().splitlines()[0])["gcups"] == 0.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "prof" / "nested"
    with profile_trace(out, device="cpu"):
        torch.ones(64).cumsum(0)
    (trace,) = out.glob("*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    with profile_trace(None):
        pass
    with profile_trace(""):
        pass


@pytest.mark.parametrize("segments,rows,qlen", [(1, 1, 30), (4, 2, 20)])
def test_score_streams_equals_swtpu(segments, rows, qlen):
    rng = np.random.default_rng(segments)
    reads = _reads(rng, 12, 0, 40)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    got = score_streams(query, reads, n_streams=8, device="cpu", segments=segments, rows=rows)
    want = ref_score_streams(query, reads, n_streams=8, interpret=True, segments=segments,
                             rows=rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, score_many_vs_one(query, reads))


def test_golden_parsers_equal_swtpu(tmp_path, monkeypatch):
    """The reference data is not in the checkout, so the three formats are
    written here, with the lines that each parser must skip.  The port
    looks for the data only where SWTPU_REFERENCE_DATA points."""
    import importlib

    rtl = tmp_path / "data1.fa_query1.fa_out.txt"
    rtl.write_text("# header\n@   566ns: \t      >db1 score: \t       133\n"
                   "garbage line\n@  1200ns:   >db2 score:   -4\n")
    ssearch = tmp_path / "score.txt"
    ssearch.write_text(">>> query\n# comment\n\ndb1 100 x y z 133 more\nshort line\n"
                       "db2 90 a b c notint\ndb3 80 a b c 106\n")
    swalign = tmp_path / "sw_testing.txt"
    swalign.write_text("=== db1: ===\nalignment...\nScore: 133\n=== db2: ===\n"
                       "Score: 106\nScore: 999\n")
    cases = [("parse_rtl_out_file", rtl, {"db1": 133, "db2": -4}),
             ("parse_ssearch_scores", ssearch, {"db1": 133, "db3": 106}),
             ("parse_swalign_dump", swalign, {"db1": 133, "db2": 106})]
    for fn, path, want in cases:
        assert getattr(goldens, fn)(path) == getattr(ref_goldens, fn)(path) == want
    try:
        monkeypatch.setenv("SWTPU_REFERENCE_DATA", str(tmp_path))
        importlib.reload(goldens)
        assert goldens.REFERENCE_DATA_DIR == tmp_path and goldens.reference_data_available()
        monkeypatch.delenv("SWTPU_REFERENCE_DATA")
        importlib.reload(goldens)
        assert goldens.REFERENCE_DATA_DIR is None and not goldens.reference_data_available()
    finally:
        monkeypatch.undo()
        importlib.reload(goldens)

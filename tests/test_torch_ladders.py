"""The top of swtpu's length ladders on the CPU, at small read counts: a
4,095-base query (32 chained wavefront tiles at rows 1, 16 chained column
tiles), reads in the 2,048 bucket, score_pairs at the RTL's 12-bit width
with queries over 2,048 bases, and a resident library loaded for 4,096
bases.  Each against swtpu's scan bank, swtpu's oracles or the port's own
other entry point, at tolerance 0.  The same paths at their full sizes on
the card are chip_smoke.py's phase "ladders"."""

import contextlib
import functools

import numpy as np
import pytest
import torch

from swtpu.bank.scorebank import ScoreBank as RefBank
from swtpu.config import SWConfig as RefConfig
from swtpu.oracle import score_many_vs_one, sw_score_single_biased
from swtpu_torch import SWConfig, ScoreBank
from swtpu_torch.ops import column, stream

WIDTH = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests on one torch thread, the count restored after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _calls(module, name, summary):
    """Each call of module.name (looked up at call time by the port's
    dispatchers) recorded as summary(*args) while the block runs."""
    seen, orig = [], getattr(module, name)

    def wrapper(*args, **kw):
        seen.append(summary(*args))
        return orig(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def _scored(backend, config, run):
    """run(bank) on a CPU bank with its integrity checks on; (its result,
    the plain tiles it ran: (rows, steps) a chained wavefront tile, the
    target columns a chained column tile, the columns a column batch, the
    steps a wavefront strip)."""
    bank = ScoreBank(config, backend=backend, device="cpu", verify_integrity=True)
    with _calls(stream, "stream_chained_reference", lambda *a: ("B3", a[6], a[1].shape[0])) as b3, \
            _calls(stream, "stream_strip_reference", lambda *a: ("B1", a[1].shape[0])) as b1, \
            _calls(column, "column_chained_reference", lambda *a: ("B5", a[1].shape[1])) as b5, \
            _calls(column, "column_scores_reference", lambda *a: ("B4", a[1].shape[1])) as b4:
        res = run(bank)
    return res, b1 + b3 + b4 + b5


# a 4,095-base query, the reference's LEN_WIDTH envelope, against 6 reads
# of 1-64 bases, one a window of it
def _long_query_case():
    rng = np.random.default_rng(4095)
    query = rng.integers(0, 4, size=4095).astype(np.int8)
    reads = [rng.integers(0, 4, size=k).astype(np.int8) for k in (1, 17, 33, 50, 64, 64)]
    reads[4] = query[2000:2064].copy()
    return query, reads


@functools.lru_cache(maxsize=None)
def _long_query_want():
    query, reads = _long_query_case()
    scan = RefBank(RefConfig(), backend="scan").score_database(query, reads).scores
    return score_many_vs_one(query, reads), scan


@functools.lru_cache(maxsize=None)
def _long_query_scored(backend):
    query, reads = _long_query_case()
    return _scored(backend, SWConfig(), lambda bank: bank.score_database(query, reads))


@pytest.mark.parametrize("backend,tiles", [
    ("pallas", [("B5", 32)] * 16 + [("B5", 128)] * 16),
    ("stream", [("B3", 1, 4160)] * 32),
])
def test_long_query_4095_equals_swtpu_scan_and_oracle(backend, tiles):
    """The column path chains 16 plain B5 tiles over the query padded to
    4,096 rows in each of the 32 and 128 buckets; the stream path 32 plain
    B3 tiles at rows 1 over 4,160 steps: 64 + 127 drain (192, a multiple of
    32) + 127 x 31 for the chain, to a multiple of 32."""
    res, ran = _long_query_scored(backend)
    oracle, scan = _long_query_want()
    assert ran == tiles
    np.testing.assert_array_equal(res.scores, oracle)
    np.testing.assert_array_equal(res.scores, scan)
    assert res.scores[4] == 5 * 64
    assert res.cells == 4095 * sum(len(r) for r in _long_query_case()[1])


def test_loaded_for_4096_equals_score_database():
    """load_database(max_query_len=4096) drains the stream for 32 tiles;
    score_loaded of the 4,095-base query = score_database's scores."""
    query, reads = _long_query_case()
    bank = ScoreBank(SWConfig(), backend="stream", device="cpu")
    db = bank.load_database(reads, max_query_len=4096)
    assert db.k_max == 32 and db.rows == 1
    assert db.stream.shape[0] == 4160  # [T, N], as score_database packs it
    with _calls(stream, "stream_chained_reference", lambda *a: a[1].shape[0]) as b3:
        got = bank.score_loaded(query, db)
    assert b3 == [4160] * 32
    np.testing.assert_array_equal(got.scores, _long_query_scored("stream")[0].scores)
    np.testing.assert_array_equal(got.scores, _long_query_want()[0])


# 4 reads of 1,500-2,048 bases (the 2,048 bucket) against a 128-base query,
# one holding the query
def _long_reads_case():
    rng = np.random.default_rng(2048)
    query = rng.integers(0, 4, size=128).astype(np.int8)
    reads = [rng.integers(0, 4, size=k).astype(np.int8) for k in (1500, 1777, 2000, 2048)]
    reads[1][300:428] = query
    return query, reads


@functools.lru_cache(maxsize=None)
def _long_reads_want():
    query, reads = _long_reads_case()
    scan = RefBank(RefConfig(), backend="scan").score_database(query, reads).scores
    return score_many_vs_one(query, reads), scan


@pytest.mark.parametrize("backend,ran", [("pallas", [("B4", 2048)]),
                                         ("stream", [("B1", 2176)])])
def test_reads_in_the_2048_bucket_equal_swtpu_scan_and_oracle(backend, ran):
    """The column path runs the plain B4 once on the 2,048 bucket; the
    stream path one plain B1 over 2,048 + 127 drain steps."""
    query, reads = _long_reads_case()
    res, got = _scored(backend, SWConfig(), lambda bank: bank.score_database(query, reads))
    oracle, scan = _long_reads_want()
    assert got == ran
    np.testing.assert_array_equal(res.scores, oracle)
    np.testing.assert_array_equal(res.scores, scan)
    assert res.scores[1] == 5 * 128


# score_pairs at the RTL's width: 2 queries of about 2,100 bases x 2 targets
# of about 600, the second of each a window of its query that wraps
def _pairs_case():
    rng = np.random.default_rng(2100)
    qs = [rng.integers(0, 4, size=k).astype(np.int8) for k in (2100, 2071)]
    queries = [qs[0], qs[0], qs[1], qs[1]]
    targets = [rng.integers(0, 4, size=600).astype(np.int8), qs[0][700:1300].copy(),
               rng.integers(0, 4, size=613).astype(np.int8), qs[1][100:700].copy()]
    return queries, targets


@functools.lru_cache(maxsize=None)
def _pairs_scored(backend):
    queries, targets = _pairs_case()
    return _scored(backend, SWConfig(score_width=WIDTH),
                   lambda bank: bank.score_pairs(queries, targets))


@functools.lru_cache(maxsize=None)
def _pair_oracle(k):
    queries, targets = _pairs_case()
    return sw_score_single_biased(queries[k], targets[k], score_width=WIDTH)


@pytest.mark.parametrize("k", range(4))
@pytest.mark.parametrize("backend,tiles", [("pallas", [("B5", 2048)] * 16),
                                           ("stream", [("B3", 1, 2784)] * 17
                                            + [("B3", 1, 2816)] * 17)])
def test_pairs_w12_over_2048_bases_equal_biased_oracle(backend, tiles, k):
    """The column path chains 16 biased B5 tiles over the (4,096, 2,048)
    group; the stream path one job of 17 biased B3 tiles a distinct query.
    The windows' exact scores (3,000) pass the 12-bit ceiling and wrap."""
    res, ran = _pairs_scored(backend)
    assert ran == tiles
    assert res.scores[k] == _pair_oracle(k)
    if k % 2:
        assert res.scores[k] != 5 * len(_pairs_case()[1][k])

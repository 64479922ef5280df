"""The port's config-driven regression suites (swtpu_torch.testing.suite)
against swtpu's: the same outcomes field for field on the built-in suite
and on suites/*.json, the same report lines and exit codes, and the stream
path's corruption patches reaching the names ScoreBank calls."""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from swtpu.testing import suite as ref_suite
from swtpu_torch.bank import scorebank as bank_mod
from swtpu_torch.testing import suite

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# a suite small enough to run twice in a test
SMALL = {"datasets": [{"reads": 6, "min_len": 4, "max_len": 12, "query_len": 8}]}


def _rows(outcomes):
    return [dataclasses.asdict(o) for o in outcomes]


def test_suite_definitions_equal_swtpu():
    assert suite.DEFAULT_SUITE == ref_suite.DEFAULT_SUITE
    assert ([(f.name, f.default) for f in dataclasses.fields(suite.TestOutcome)]
            == [(f.name, f.default) for f in dataclasses.fields(ref_suite.TestOutcome)])
    for spec in suite.DEFAULT_SUITE["datasets"]:
        got = suite._gen_dataset(np.random.default_rng(7), spec)
        want = ref_suite._gen_dataset(np.random.default_rng(7), spec)
        np.testing.assert_array_equal(got[0], want[0])
        assert len(got[1]) == len(want[1])
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", [
    None, "suites/default.json",
    pytest.param("suites/multihost.json", marks=pytest.mark.multihost),
])
def test_run_suite_equals_swtpu(path):
    """Every field of every outcome, in order: the seeded fault counts, the
    bad shard and the resumed shards included."""
    arg = None if path is None else str(REPO / path)
    got = suite.run_suite(arg, device="cpu")
    assert _rows(got) == _rows(ref_suite.run_suite(arg))
    assert all(o.passed for o in got)
    details = {o.name: o.detail for o in got}
    assert details["corruption_inject_stream"] == "stream codes: caught; stream scores: caught"
    if path == "suites/multihost.json":
        assert [o.name for o in got[-3:]] == ["multihost", "resume_cursor", "lying_device"]
        assert details["lying_device"] == "bad_shards=[1]"
        assert details["resume_cursor"] == "rerun resumed shards [0, 1]"
    else:
        assert re.fullmatch(r"drops=\d+ reorders=\d+", details["faulted_scheduling"])


@pytest.mark.parametrize("tests", [["oracle_parity", "lying_device"],
                                   ["topk_merge", "resume_cursor", "lying_device"]])
def test_listed_multihost_tests_skip_when_disabled(tests):
    """A dict suite that lists multi-process tests with multihost off reports
    them SKIP, never drops them, as swtpu's does."""
    got = suite.run_suite({**SMALL, "tests": tests}, device="cpu")
    assert _rows(got) == _rows(ref_suite.run_suite({**SMALL, "tests": tests}))
    skipped = [o.name for o in got if o.skipped]
    assert skipped == ["multihost"] + [n for n in ("lying_device", "resume_cursor")
                                       if n in tests]
    assert all(o.passed for o in got)


def _report(capsys, fn, *args):
    rc = fn(*args)
    lines = capsys.readouterr().out.splitlines()
    lines[-1] = re.sub(r"in \d+\.\ds$", "in s", lines[-1])
    return rc, lines


CANNED = {
    "fail": [suite.TestOutcome("oracle_parity", 0, True),
             suite.TestOutcome("faulted_scheduling", 0, False, "drops=3 reorders=1"),
             suite.TestOutcome("lying_device", -1, True, "multihost disabled in this suite",
                               skipped=True)],
    "skips": [suite.TestOutcome("oracle_parity", 1, True),
              suite.TestOutcome("multihost", -1, True, "multihost disabled in this suite",
                                skipped=True),
              suite.TestOutcome("lying_device", -1, True, "multihost disabled in this suite",
                                skipped=True)],
}


@pytest.mark.parametrize("case,rc", [("fail", 1), ("skips", 0)])
def test_main_cli_lines_equal_swtpu(monkeypatch, capsys, case, rc):
    """The same canned outcomes print the same lines (the seconds aside);
    1 on a failure that was not skipped, 0 when only skips did not pass."""
    outcomes = CANNED[case]
    monkeypatch.setattr(suite, "run_suite", lambda path, device="cuda": outcomes)
    ref = [ref_suite.TestOutcome(**dataclasses.asdict(o)) for o in outcomes]
    monkeypatch.setattr(ref_suite, "run_suite", lambda path: ref)
    got = _report(capsys, suite.main_cli, None, "cpu")
    assert got == _report(capsys, ref_suite.main_cli, None)
    assert got[0] == rc


def test_main_cli_fails_under_warning(tmp_path, monkeypatch, capsys):
    """"fail": "WARNING" is read by nothing: a failed check still exits 1,
    in both packages, with the same lines."""
    path = tmp_path / "warn.json"
    path.write_text(json.dumps({**SMALL, "fail": "WARNING", "tests": ["oracle_parity"]}))
    import swtpu.oracle
    import swtpu_torch.oracle

    for mod in (swtpu.oracle, swtpu_torch.oracle):
        real = mod.score_many_vs_one
        monkeypatch.setattr(mod, "score_many_vs_one",
                            lambda q, t, real=real: real(q, t) + 1)
    rc, lines = _report(capsys, suite.main_cli, str(path), "cpu")
    assert (rc, lines) == _report(capsys, ref_suite.main_cli, str(path))
    assert rc == 1 and lines[0] == "FAIL ds0 oracle_parity"


def test_stream_patches_reach_the_names_scorebank_calls():
    """The stream path looks its pack and scoring entries up in
    scorebank's namespace at call time: the suite's patches must replace
    exactly those names, the plain form (the CPU) and the wire form (CUDA),
    and restore them after."""
    called = set(bank_mod.ScoreBank._score_database_stream.__code__.co_names)
    assert {n for n in called if n.startswith("sw_scores_stream")} == set(
        suite.STREAM_SCORE_FAKES) == {"sw_scores_stream", "sw_scores_stream_packed"}
    assert "pack_streams" in called
    real = {n: getattr(bank_mod, n) for n in (*suite.STREAM_SCORE_FAKES, "pack_streams")}

    es = torch.arange(5, dtype=torch.int32)
    with suite.corrupted_stream_scores():
        plain = bank_mod.sw_scores_stream(None, None, es, es, rows=1)
        wire = bank_mod.sw_scores_stream_packed(None, None, None, es, es, rows=1)
    for got in (plain, wire):
        assert got.dtype == torch.int32 and got.device == es.device
        assert got.tolist() == [10 ** 6] * 5

    reads = [np.arange(9, dtype=np.int8) % 4, np.zeros(3, np.int8)]
    with suite.corrupted_stream_codes():
        batch = bank_mod.pack_streams(np.zeros(8, np.int8), reads, n_streams=8)
    assert batch.stream[0, 0] == 6
    assert {n: getattr(bank_mod, n) for n in real} == real


@pytest.mark.parametrize("patch", ["codes", "scores"])
def test_stream_corruption_caught_on_the_bank(patch):
    """The stream bank the suite builds rejects each corruption, and scores
    the oracle's without it."""
    from swtpu_torch import SWConfig, ScoreBank, score_many_vs_one
    from swtpu_torch.utils.guards import IntegrityError

    rng = np.random.default_rng(3)
    query, targets = suite._gen_dataset(rng, SMALL["datasets"][0])
    bank = ScoreBank(SWConfig(), backend="stream", device="cpu", verify_integrity=True)
    np.testing.assert_array_equal(bank.score_database(query, targets).scores,
                                  score_many_vs_one(query, targets))
    ctx = suite.corrupted_stream_codes if patch == "codes" else suite.corrupted_stream_scores
    with ctx(), pytest.raises(IntegrityError):
        bank.score_database(query, targets)

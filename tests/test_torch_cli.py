"""The port's CLI and entry points: same score lines as swtpu's CLI, the
same bytes from oracle, generate, diff, events and score --resume, no JAX
in the port's process, and chip_smoke.py refusing to run without a card."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from swtpu.cli import main as ref_main
from swtpu.io import FastaRecord, read_fasta, write_fasta
from swtpu.io.encode import CODE_BASES
from swtpu.testing.goldens import parse_rtl_out_file
from swtpu_torch.bank import scorebank as bank_mod
from swtpu_torch.cli import main

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _fasta(path, seed, n=25, qlen=50):
    rng = np.random.default_rng(seed)
    lens = [qlen] + list(rng.integers(0, 120, size=n))
    lens[4] = 0
    recs = [
        FastaRecord("query" if i == 0 else f"db{i}",
                    "".join(CODE_BASES[int(c)] for c in rng.integers(0, 4, size=k)))
        for i, k in enumerate(lens)
    ]
    write_fasta(path, recs)
    return path


def test_score_lines_equal_swtpu_cli(tmp_path, capsys):
    fa = _fasta(tmp_path / "gen.fa", seed=1)
    port_out, ref_out = tmp_path / "port.txt", tmp_path / "ref.txt"
    events = tmp_path / "events.jsonl"
    assert main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa),
                 "-o", str(port_out), "--topk", "3", "--events", str(events)]) == 0
    err = capsys.readouterr().err
    assert err.count("# top: >db") == 3 and "GCUPS on cpu" in err
    assert json.loads(events.read_text())["kind"] == "stream"
    assert ref_main(["--platform", "cpu", "score", "-q", str(fa), "-l", str(fa),
                     "-o", str(ref_out), "--backend", "scan"]) == 0
    got, want = parse_rtl_out_file(port_out), parse_rtl_out_file(ref_out)
    assert len(got) == 25 and got == want
    assert ref_main(["diff", str(port_out), str(ref_out)]) == 0


def test_score_with_custom_penalties(tmp_path):
    fa = _fasta(tmp_path / "gen.fa", seed=2, qlen=120)
    pen = ["--match", "3", "--mismatch", "-2", "--gap-open", "-6", "--gap-extend", "-1"]
    port_out, ref_out = tmp_path / "port.txt", tmp_path / "ref.txt"
    assert main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa),
                 "-o", str(port_out), *pen]) == 0
    assert ref_main(["oracle", "-q", str(fa), "-l", str(fa), "-o", str(ref_out), *pen]) == 0
    assert ref_main(["diff", str(port_out), str(ref_out)]) == 0


def test_long_query_score_lines_equal_swtpu_cli(tmp_path):
    """A 200-base query takes the chained-tile path with no change to the
    CLI."""
    fa = _fasta(tmp_path / "gen.fa", seed=4, qlen=200)
    port_out, ref_out = tmp_path / "port.txt", tmp_path / "ref.txt"
    events = tmp_path / "events.jsonl"
    assert main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa),
                 "-o", str(port_out), "--events", str(events)]) == 0
    assert json.loads(events.read_text())["kind"] == "stream_long"
    assert ref_main(["--platform", "cpu", "score", "-q", str(fa), "-l", str(fa),
                     "-o", str(ref_out), "--backend", "scan"]) == 0
    assert len(parse_rtl_out_file(port_out)) == 25
    assert ref_main(["diff", str(port_out), str(ref_out)]) == 0


@pytest.mark.parametrize("flags", [["--backend", "pallas"], ["--score-width", "10"]])
def test_bucketed_score_lines_equal_swtpu_cli(tmp_path, flags):
    """The bucketed column path, exact and at a 10-bit score width, against
    swtpu's CLI with the same flags; a read equal to the 120-base query
    scores 600 exactly, past the 10-bit ceiling, so its line wraps."""
    fa = _fasta(tmp_path / "gen.fa", seed=5, qlen=120)
    recs = read_fasta(fa)
    write_fasta(fa, [*recs, FastaRecord("dbself", recs[0].seq)])
    port_out, ref_out = tmp_path / "port.txt", tmp_path / "ref.txt"
    events = tmp_path / "events.jsonl"
    assert main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa),
                 "-o", str(port_out), "--events", str(events), *flags]) == 0
    kinds = [json.loads(line)["kind"] for line in events.read_text().splitlines()]
    assert kinds == ["batch", "batch"]  # buckets 32 and 128
    assert ref_main(["--platform", "cpu", "score", "-q", str(fa), "-l", str(fa),
                     "-o", str(ref_out), *flags]) == 0
    got = parse_rtl_out_file(port_out)
    assert len(got) == 26 and got == parse_rtl_out_file(ref_out)
    assert ref_main(["diff", str(port_out), str(ref_out)]) == 0
    assert (got["dbself"] == 600) == (flags[0] == "--backend")


@pytest.mark.parametrize("qlen", [120, 450])
def test_stream_score_width_lines_equal_swtpu_cli(tmp_path, qlen):
    """--backend stream --score-width 12 against swtpu's CLI with the same
    flags: a short query (one tile) and a 450-base one (chained tiles); a
    read equal to the 450-base query scores 2,250 exactly, past the 12-bit
    ceiling, so that its line wraps."""
    fa = _fasta(tmp_path / "gen.fa", seed=8, n=30, qlen=qlen)
    recs = read_fasta(fa)
    write_fasta(fa, [*recs, FastaRecord("dbself", recs[0].seq)])
    flags = ["--backend", "stream", "--score-width", "12"]
    port_out, ref_out = tmp_path / "port.txt", tmp_path / "ref.txt"
    events = tmp_path / "events.jsonl"
    assert main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa),
                 "-o", str(port_out), "--events", str(events), *flags]) == 0
    kind = json.loads(events.read_text())["kind"]
    assert kind == ("stream" if qlen <= 128 else "stream_long")
    assert ref_main(["--platform", "cpu", "score", "-q", str(fa), "-l", str(fa),
                     "-o", str(ref_out), *flags]) == 0
    got = parse_rtl_out_file(port_out)
    assert len(got) == 31 and got == parse_rtl_out_file(ref_out)
    assert ref_main(["diff", str(port_out), str(ref_out)]) == 0
    assert (got["dbself"] == 5 * qlen) == (qlen == 120)


@pytest.mark.parametrize(
    "flags,match",
    [
        (["--backend", "scan", "--buckets", "32,64"], "exceeds bucket capacity 64"),
        (["--backend", "scan", "--score-width", "12"], "requires the stream or column"),
        (["--backend", "stream", "--score-width", "40"], "out of range \\(need 2..30\\)"),
        (["--backend", "pallas", "--buckets", "32,64"], "exceeds bucket capacity 64"),
        (["--buckets", "32,x"], "comma-separated ints"),
        (["--all-queries", "--resume", "job.npz"], "does not compose with --resume/--timeout"),
    ],
)
def test_score_flag_errors_exit_cleanly(tmp_path, flags, match):
    fa = _fasta(tmp_path / "gen.fa", seed=6)
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa), *flags])


def test_port_never_imports_jax(tmp_path):
    """The port's CPU slice and CLI in a fresh interpreter: neither JAX nor
    any module of swtpu may load (the test process has both): the port
    keeps its own copies of what it uses."""
    fa = _fasta(tmp_path / "gen.fa", seed=3)
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import swtpu_torch
        from swtpu_torch.cli import main
        rng = np.random.default_rng(0)
        reads = [rng.integers(0, 4, size=k).astype(np.int8) for k in (5, 0, 40, 17)]
        query = rng.integers(0, 4, size=30).astype(np.int8)
        res = swtpu_torch.ScoreBank(device="cpu").score_database(query, reads)
        assert (res.scores == swtpu_torch.score_many_vs_one(query, reads)).all()
        long_query = rng.integers(0, 4, size=150).astype(np.int8)
        res = swtpu_torch.ScoreBank(device="cpu").score_database(long_query, reads)
        assert (res.scores == swtpu_torch.score_many_vs_one(long_query, reads)).all()
        bank = swtpu_torch.ScoreBank(swtpu_torch.SWConfig(score_width=12), device="cpu")
        res = bank.score_database(long_query, reads)
        assert (res.scores == swtpu_torch.score_many_vs_one(long_query, reads)).all()
        bank = swtpu_torch.ScoreBank(device="cpu")
        db = bank.load_database(reads, max_query_len=256)
        res = bank.score_loaded(long_query, db)
        assert (res.scores == swtpu_torch.score_many_vs_one(long_query, reads)).all()
        assert bank.topk_loaded(long_query, db, k=2) == res.top_k(2)
        from swtpu_torch.server import ServeEngine
        assert len(ServeEngine(bank, list("abcd"), reads, db=db).handle("SEQ ACGT")) == 4
        assert main(["--device", "cpu", "score", "-q", {str(fa)!r}, "-l", {str(fa)!r},
                     "-o", {str(tmp_path / "out.txt")!r}]) == 0
        assert main(["--device", "cpu", "score", "-q", {str(fa)!r}, "-l", {str(fa)!r},
                     "-o", {str(tmp_path / "resumed.txt")!r},
                     "--resume", {str(tmp_path / "job.npz")!r}]) == 0
        assert main(["generate", "-n", "3", "-o", {str(tmp_path / "g.fa")!r}]) == 0
        assert main(["oracle", "-q", {str(fa)!r}, "-l", {str(fa)!r},
                     "-o", {str(tmp_path / "oracle.txt")!r}]) == 0
        assert main(["diff", {str(tmp_path / "out.txt")!r},
                     {str(tmp_path / "oracle.txt")!r}]) == 0
        import swtpu_torch.testing.faults
        bank = swtpu_torch.ScoreBank(swtpu_torch.SWConfig(stream_chunk_reads=2), device="cpu")
        res = bank.score_database(query, reads)
        assert (res.scores == swtpu_torch.score_many_vs_one(query, reads)).all()
        from swtpu_torch.parallel.mesh import make_mesh
        from swtpu_torch.parallel.multihost import score_database_multihost
        import swtpu_torch.testing.regress, swtpu_torch.testing.worker
        mesh = make_mesh(devices=["cpu"] * 2)
        res = swtpu_torch.ScoreBank(backend="scan", device="cpu").score_database(query, reads)
        assert (res.scores == swtpu_torch.score_many_vs_one(query, reads)).all()
        sdb = bank.load_database_sharded(reads, mesh)
        assert bank.topk_loaded_sharded(query, sdb, k=3) == res.top_k(3)
        _, _, local = score_database_multihost(query, reads, np.arange(4, dtype=np.int32),
                                               mesh=mesh, k=2)
        assert (local == res.scores).all()
        import swtpu_torch.bench, swtpu_torch.bench_scaling
        swtpu_torch.bench.CPU_PAIRS = (64, 256)  # the import graph, not the rate
        assert main(["--device", "cpu", "bench"]) == 0
        heavy = [m for m in sys.modules
                 if m in ("jax", "swtpu") or m.startswith(("jax.", "swtpu."))]
        print("HEAVY", heavy)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "HEAVY []" in res.stdout


@pytest.mark.parametrize("lone", [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, lone):
    """chip_smoke.py needs a CUDA device, and the repository beside it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs in full there")
    script = REPO / "chip_smoke.py"
    if lone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stdout
    assert '"ok": true' not in res.stdout


def _no_ns(text):
    """Score lines without their elapsed-time field, the one part of a
    line that differs between two runs."""
    return re.sub(r"@ *\d+ns:", "@ns:", text)


def test_oracle_lines_equal_swtpu_cli(tmp_path):
    fa = _fasta(tmp_path / "gen.fa", seed=9, qlen=70)
    pen = ["--match", "3", "--mismatch", "-2", "--gap-open", "-6", "--gap-extend", "-1"]
    port_out, ref_out = tmp_path / "port.txt", tmp_path / "ref.txt"
    assert main(["oracle", "-q", str(fa), "-l", str(fa), "-o", str(port_out), *pen]) == 0
    assert ref_main(["oracle", "-q", str(fa), "-l", str(fa), "-o", str(ref_out), *pen]) == 0
    assert _no_ns(port_out.read_text()) == _no_ns(ref_out.read_text())
    assert len(parse_rtl_out_file(port_out)) == 25


@pytest.mark.parametrize("argv", [["-n", "20", "-L", "64", "--seed", "3"], ["-n", "1"]])
def test_generate_equals_swtpu_cli(tmp_path, capsys, argv):
    path = tmp_path / "data.fa"
    assert main(["generate", "-o", str(path), *argv]) == 0
    got, err = path.read_bytes(), capsys.readouterr().err
    assert ref_main(["generate", "-o", str(path), *argv]) == 0
    assert (got, err) == (path.read_bytes(), capsys.readouterr().err)
    names = [r.name for r in read_fasta(path)]
    assert names[0] == "query" and names[1:] == [f"db{i}" for i in range(1, len(names))]


@pytest.mark.parametrize("case", ["equal", "mismatch", "ssearch"])
def test_diff_equals_swtpu_cli(tmp_path, capsys, case):
    """diff's report and exit code equal swtpu's: two equal score files, two
    that differ in two reads and in which reads they hold, and an RTL file
    against an ssearch36 table."""
    fa = _fasta(tmp_path / "gen.fa", seed=10)
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    assert main(["oracle", "-q", str(fa), "-l", str(fa), "-o", str(a)]) == 0
    scores = parse_rtl_out_file(a)
    if case == "equal":
        b.write_text(a.read_text())
    elif case == "mismatch":
        lines = a.read_text().splitlines()
        lines[3] = lines[3].rsplit(" ", 1)[0] + " 999"
        lines[7] = lines[7].rsplit(" ", 1)[0] + " -1"
        b.write_text("\n".join(lines[:-2] + ["@ 1ns: >extra score: 5"]) + "\n")
    else:
        b.write_text("".join(f"{k} 50 0 0 0 {v} x\n" for k, v in scores.items()))
    capsys.readouterr()
    rc = main(["diff", str(a), str(b)])
    got = capsys.readouterr().out
    assert (rc, got) == (ref_main(["diff", str(a), str(b)]), capsys.readouterr().out)
    assert rc == (case == "mismatch")
    assert got.startswith("# 25 common IDs" if case != "mismatch" else "# 23 common IDs")


def test_events_equals_swtpu_cli(tmp_path, capsys):
    """events summarises a log of the port's score (one stream record) and
    of score --all-queries (query records) as swtpu's does."""
    fa = _fasta(tmp_path / "gen.fa", seed=11)
    log = tmp_path / "events.jsonl"
    assert main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa), "-o",
                 str(tmp_path / "a.txt"), "--events", str(log)]) == 0
    assert main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa), "-o",
                 str(tmp_path / "b.txt"), "--events", str(log), "--all-queries",
                 "--backend", "pallas"]) == 0
    capsys.readouterr()
    assert main(["events", str(log)]) == 0
    got = capsys.readouterr().out
    assert ref_main(["events", str(log)]) == 0
    assert got == capsys.readouterr().out
    # one stream record, then a query record for each of the file's 26
    assert got.count("\n") == 28 and got.splitlines()[-1].startswith("# total: 27 events")


@pytest.mark.parametrize("writer", ["swtpu", "port"])
def test_score_resume_equals_swtpu_cli(tmp_path, monkeypatch, writer):
    """score --resume writes swtpu's lines, and a finished job's state file
    written by either CLI is adopted by the other: the rerun scores
    nothing again (bucketed backends: swtpu's scan, the port's pallas)."""
    fa = _fasta(tmp_path / "gen.fa", seed=12)
    state = tmp_path / "job.npz"
    port_out, ref_out = tmp_path / "port.txt", tmp_path / "ref.txt"
    port = lambda: main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa),  # noqa: E731
                         "-o", str(port_out), "--backend", "pallas", "--resume", str(state)])
    ref = lambda: ref_main(["--platform", "cpu", "score", "-q", str(fa), "-l", str(fa),  # noqa: E731
                            "-o", str(ref_out), "--backend", "scan", "--resume", str(state)])
    assert (ref if writer == "swtpu" else port)() == 0
    assert state.exists()
    if writer == "swtpu":
        def poisoned(*a, **kw):
            raise AssertionError("batch scored again after it was done")

        monkeypatch.setattr(bank_mod.ScoreBank, "_score_batch", poisoned)
    assert (port if writer == "swtpu" else ref)() == 0
    assert _no_ns(port_out.read_text()) == _no_ns(ref_out.read_text())
    assert len(parse_rtl_out_file(port_out)) == 25


def test_score_resume_stream_finishes_a_killed_job(tmp_path, monkeypatch):
    """The port's own --resume on the stream backend: a job killed after
    its first chunk of 8 reads is rerun, and only the last chunks are
    scored; the lines equal a one-shot score's."""
    fa = _fasta(tmp_path / "gen.fa", seed=13)
    state, out, one = tmp_path / "job.npz", tmp_path / "out.txt", tmp_path / "one.txt"
    argv = ["--device", "cpu", "score", "-q", str(fa), "-l", str(fa), "--resume", str(state)]
    real = bank_mod.sw_scores_stream
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real(*a, **kw)

    monkeypatch.setattr(bank_mod, "sw_scores_stream", flaky)
    with pytest.raises(RuntimeError, match="simulated crash"):
        main([*argv, "-o", str(out)])
    assert main([*argv, "-o", str(out)]) == 0
    assert calls["n"] == 5  # chunks 1 and 2 (crashed), then 2, 3 and 4 of 25 reads
    assert main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa), "-o", str(one)]) == 0
    assert _no_ns(out.read_text()) == _no_ns(one.read_text())


def test_score_profile_writes_a_trace(tmp_path, capsys):
    fa = _fasta(tmp_path / "gen.fa", seed=14)
    prof = tmp_path / "prof"
    assert main(["--device", "cpu", "score", "-q", str(fa), "-l", str(fa), "-o",
                 str(tmp_path / "out.txt"), "--profile", str(prof)]) == 0
    (trace,) = prof.glob("*.pt.trace.json")
    assert "traceEvents" in json.loads(trace.read_text())


def test_regress_lines_equal_swtpu_cli(capsys):
    """regress --suite suites/default.json on the CPU prints swtpu's lines
    (the seconds aside) and exits as swtpu's does."""
    suite = str(REPO / "suites" / "default.json")
    rc = main(["--device", "cpu", "regress", "--suite", suite])
    got = capsys.readouterr().out.splitlines()
    ref_rc = ref_main(["--platform", "cpu", "regress", "--suite", suite])
    want = capsys.readouterr().out.splitlines()
    seconds = re.compile(r"in \d+\.\ds$")
    assert [seconds.sub("in s", l) for l in got] == [seconds.sub("in s", l) for l in want]
    assert rc == ref_rc == 0
    assert got[-1].startswith("# 12/12 passed, 2 skipped in ")


def test_regress_without_a_card_names_the_cpu_flag():
    """The default device is the card: without one, regress exits at once
    and names --device cpu; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: regress runs on it")
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["regress", "--suite", str(REPO / "suites" / "default.json")])


def test_bench_cpu_prints_swtpu_line(capsys, monkeypatch):
    """bench --device cpu runs swtpu's CPU stage (the scan) and prints its
    one JSON line: swtpu's four keys, metric and baseline (at 256 and
    2,048 pairs: the stage's 1,024 and 4,096 take seconds of CPU)."""
    import bench as ref_bench

    from swtpu_torch import bench

    monkeypatch.setattr(bench, "CPU_PAIRS", (256, 2048))
    assert main(["--device", "cpu", "bench"]) == 0
    out, err = capsys.readouterr()
    assert len(out.splitlines()) == 1
    line = json.loads(out)
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert (line["metric"], line["unit"]) == (ref_bench.METRIC, "GCUPS")
    gcups = float(re.search(r"# stage cpu: ok in \d+s: \{'gcups': ([^,]+),", err).group(1))
    assert gcups > 0 and line["value"] == round(gcups, 1)  # swtpu's rounding
    assert line["vs_baseline"] == round(gcups / ref_bench.BASELINE_GCUPS, 3)


def test_bench_without_a_card_names_the_cpu_flag(capsys):
    """The default device is the card: without one, bench exits at once,
    names --device cpu and never runs the CPU stage."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: bench runs on it")
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["bench"])
    assert "stage" not in capsys.readouterr().err

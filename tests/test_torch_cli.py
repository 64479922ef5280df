"""The port's CLI and entry points: same score lines as swtpu's CLI, no JAX
in the port's process, and chip_smoke.py refusing to run without a card."""

import json
import os
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
        (["--backend", "scan"], "ROADMAP item 10"),
        (["--backend", "scan", "--score-width", "12"], "requires the stream or column"),
        (["--backend", "stream", "--score-width", "40"], "out of range \\(need 2..30\\)"),
        (["--backend", "pallas", "--buckets", "32,64"], "exceeds bucket capacity 64"),
        (["--buckets", "32,x"], "comma-separated ints"),
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

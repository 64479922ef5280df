"""The port's scan backend (swtpu_torch.ops.scan) against swtpu's
sw_scores_scan and the oracle at tolerance 0, at swtpu's own test shapes;
ScoreBank(backend="scan") and the CLI's --backend scan against swtpu's."""

import numpy as np
import pytest
import torch

from swtpu.bank import ScoreBank as RefBank
from swtpu.cli import main as ref_main
from swtpu.config import Penalties as RefPenalties
from swtpu.config import SWConfig as RefConfig
from swtpu.io import FastaRecord, write_fasta
from swtpu.io.encode import CODE_BASES
from swtpu.ops import sentinel_pad_batch
from swtpu.ops.scan import _maxplus_prefix as ref_maxplus_prefix
from swtpu.ops.scan import _shift_down as ref_shift_down
from swtpu.ops.scan import sw_scores_scan as ref_scan
from swtpu.oracle import score_many_vs_one, sw_score_batch
from swtpu.testing.goldens import parse_rtl_out_file
from swtpu_torch.bank import ScoreBank
from swtpu_torch.cli import main
from swtpu_torch.config import Penalties, SWConfig
from swtpu_torch.ops.common import Q_PAD, T_PAD
from swtpu_torch.ops.scan import _maxplus_prefix, _shift_down, sw_scores_scan
from swtpu_torch.utils.metrics import EventLog

torch.set_num_threads(1)


def _random_ragged(rng, B, m_max, n_max):
    q_lens = rng.integers(1, m_max + 1, size=B)
    t_lens = rng.integers(1, n_max + 1, size=B)
    q = rng.integers(0, 4, size=(B, m_max)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n_max)).astype(np.int8)
    return q, q_lens, t, t_lens


def _both(qp, tp, pen=None):
    """(port, swtpu) scores of one padded batch."""
    got = sw_scores_scan(torch.from_numpy(qp), torch.from_numpy(tp),
                         *([Penalties(*pen.astuple())] if pen else []))
    want = np.asarray(ref_scan(qp, tp, *([pen] if pen else [])))
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("B,m,n,seed", [(8, 16, 16, 0), (32, 33, 47, 1), (16, 128, 128, 2),
                                        (4, 256, 64, 256), (4, 512, 40, 512)])
def test_scan_equals_swtpu_and_oracle(B, m, n, seed):
    """swtpu's test shapes, its long queries (m = 256 and 512) among them."""
    rng = np.random.default_rng(seed)
    q, q_lens, t, t_lens = _random_ragged(rng, B, m, n)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got, want = _both(qp, tp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sw_score_batch(q, t, q_lens, t_lens))


def test_scan_custom_penalties():
    rng = np.random.default_rng(3)
    q, q_lens, t, t_lens = _random_ragged(rng, 16, 40, 60)
    pen = RefPenalties(match=3, mismatch=-2, gap_open=-5, gap_extend=-1)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got, want = _both(qp, tp, pen)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sw_score_batch(q, t, q_lens, t_lens, pen))


def test_scan_sentinel_pads_never_score():
    """An all-pad target scores 0 against a real query; numpy input works."""
    q = np.full((2, 8), Q_PAD, np.int8)
    q[:, :4] = [[0, 1, 2, 3], [3, 2, 1, 0]]
    t = np.full((2, 8), T_PAD, np.int8)
    np.testing.assert_array_equal(sw_scores_scan(q, t).numpy(), [0, 0])
    np.testing.assert_array_equal(np.asarray(ref_scan(q, t)), [0, 0])


def test_scan_helpers_equal_swtpu():
    """_shift_down and the max-plus prefix, int32, at a non-power-of-two
    width."""
    rng = np.random.default_rng(4)
    x = rng.integers(-50, 50, size=(3, 13)).astype(np.int32)
    np.testing.assert_array_equal(_shift_down(torch.from_numpy(x), 0).numpy(),
                                  np.asarray(ref_shift_down(x, 0)))
    np.testing.assert_array_equal(_maxplus_prefix(torch.from_numpy(x), -4).numpy(),
                                  np.asarray(ref_maxplus_prefix(x, -4)))


def _reads(rng, n, lo, hi):
    return [rng.integers(0, 4, size=int(rng.integers(lo, hi))).astype(np.int8)
            for _ in range(n)]


def test_scorebank_scan_score_database_and_pairs_equal_swtpu(tmp_path):
    """ScoreBank(backend="scan") on the CPU: score_database (both target
    forms, two buckets) and score_pairs against swtpu's scan bank, scores,
    cells, padded cells and the batch events."""
    rng = np.random.default_rng(5)
    cfg = SWConfig(target_buckets=(32, 128))
    ref_cfg = RefConfig(target_buckets=(32, 128))
    bank, ref = ScoreBank(cfg, backend="scan", device="cpu"), RefBank(ref_cfg, backend="scan")
    targets = _reads(rng, 30, 1, 120)
    query = rng.integers(0, 4, size=45).astype(np.int8)
    log = EventLog(tmp_path / "events.jsonl")
    got = bank.score_database(query, targets, event_log=log)
    want = ref.score_database(query, targets)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)
    np.testing.assert_array_equal(got.scores, score_many_vs_one(query, targets))
    log.close()
    assert [e.kind for e in EventLog.parse(tmp_path / "events.jsonl")] == ["batch", "batch"]
    lens = np.array([len(t) for t in targets], np.int32)
    mat = np.full((len(targets), 120), T_PAD, np.int8)
    for i, t in enumerate(targets):
        mat[i, : len(t)] = t
    np.testing.assert_array_equal(bank.score_database(query, (mat, lens)).scores, want.scores)
    queries = _reads(rng, 12, 4, 40)
    pairs = _reads(rng, 12, 4, 100)
    got = bank.score_pairs(queries, pairs)
    want = ref.score_pairs(queries, pairs)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert (got.cells, got.padded_cells) == (want.cells, want.padded_cells)


def test_scorebank_scan_refuses_score_width():
    """swtpu's refusal, and its message: wrap-parity needs the stream or
    column kernel, and a named scan backend is never overridden."""
    with pytest.raises(ValueError, match="score_width requires the 'stream' or 'pallas'") as e:
        ScoreBank(SWConfig(score_width=12), backend="scan", device="cpu")
    with pytest.raises(ValueError) as ref_e:
        RefBank(RefConfig(score_width=12), backend="scan")
    assert str(e.value) == str(ref_e.value)


def _fasta(path, rng, n=24):
    """`>query` of 50 bases, then n reads of 0-150 bases (db6 is the query)."""
    seqs = ["".join(CODE_BASES[int(c)] for c in rng.integers(0, 4, size=k))
            for k in [50, *rng.integers(0, 150, size=n)]]
    seqs[6] = seqs[0]
    write_fasta(path, [FastaRecord("query" if i == 0 else f"db{i}", s)
                       for i, s in enumerate(seqs)])
    return path


@pytest.mark.parametrize("extra", [[], ["--buckets", "32,64,256"]])
def test_cli_backend_scan_lines_equal_swtpu(tmp_path, capsys, extra):
    """`score --backend scan` on the port and on swtpu: the same scores and
    the same top lines."""
    fa = _fasta(tmp_path / "lib.fa", np.random.default_rng(6))
    port_out, ref_out = tmp_path / "port.txt", tmp_path / "ref.txt"
    flags = ["score", "-q", str(fa), "-l", str(fa), "--backend", "scan", "--topk", "3", *extra]
    assert main(["--device", "cpu", *flags, "-o", str(port_out)]) == 0
    port_err = capsys.readouterr().err
    assert ref_main(["--platform", "cpu", *flags, "-o", str(ref_out)]) == 0
    ref_err = capsys.readouterr().err
    got = parse_rtl_out_file(port_out)
    assert len(got) == 24 and got == parse_rtl_out_file(ref_out)
    assert got["db6"] == 250
    tops = [l for l in port_err.splitlines() if l.startswith("# top:")]
    assert tops and tops == [l for l in ref_err.splitlines() if l.startswith("# top:")]


def test_cli_serve_backend_scan_lines_equal_swtpu(tmp_path, capsys):
    """`serve --backend scan` (score_database a request) on both packages."""
    rng = np.random.default_rng(7)
    fa = _fasta(tmp_path / "lib.fa", rng, n=10)
    seq = "".join(CODE_BASES[int(c)] for c in rng.integers(0, 4, size=30))
    cmds = tmp_path / "cmds.txt"
    cmds.write_text(f"SEQ {seq}\nTOP 2 {seq}\nQUIT\n")
    assert main(["--device", "cpu", "serve", "-l", str(fa), "--input", str(cmds),
                 "--backend", "scan"]) == 0
    got = capsys.readouterr()
    assert "(scan)" in got.err
    assert ref_main(["--platform", "cpu", "serve", "-l", str(fa), "--input", str(cmds),
                     "--backend", "scan"]) == 0
    want = capsys.readouterr().out.splitlines()
    strip = [l.split("ns:", 1)[-1] for l in got.out.splitlines()]
    assert len(strip) == 10 + 2 and strip == [l.split("ns:", 1)[-1] for l in want]

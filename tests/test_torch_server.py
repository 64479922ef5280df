"""The port's serving daemon (swtpu_torch.server) and its CLI front ends,
`serve` and `score --all-queries`, on a CPU bank: concurrent clients
against one resident database, and the same lines as swtpu's engine and
CLI (the ns field aside)."""

import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

from swtpu.bank import ScoreBank as RefBank
from swtpu.cli import main as ref_main
from swtpu.io import FastaRecord, write_fasta
from swtpu.io.encode import CODE_BASES
from swtpu.oracle import score_many_vs_one
from swtpu.server import ServeEngine as RefServeEngine
from swtpu_torch import server
from swtpu_torch.bank import ScoreBank
from swtpu_torch.cli import main
from swtpu_torch.server import ServeEngine, client_request, serve_socket
from swtpu_torch.utils.metrics import EventLog

torch.set_num_threads(1)


def _targets(rng, n_reads):
    return [rng.integers(0, 4, size=int(rng.integers(8, 30))).astype(np.int8)
            for _ in range(n_reads)]


def _make_engine(targets, resident=True, event_log=None):
    """An engine on a CPU bank over `targets`: with a resident database,
    or (resident=False) one score_database call a request."""
    names = [f"db{i+1}" for i in range(len(targets))]
    bank = ScoreBank(backend="stream", device="cpu")
    db = bank.load_database(targets) if resident else None
    return ServeEngine(bank, names, targets, db=db, event_log=event_log)


def _seq_str(codes):
    return "".join(CODE_BASES[int(c)] for c in codes)


def _scores(lines):
    return [int(l.rsplit("\t", 1)[1]) for l in lines]


def _no_ns(lines):
    """Score lines with their `@ ... ns:` time stamp blanked."""
    return [re.sub(r"^@\s*\d+ns:", "@ns:", l) for l in lines]


def _serve_in_thread(**kw):
    """serve_socket in a daemon thread; (thread, server) once it listens."""
    ready = threading.Event()
    th = threading.Thread(target=serve_socket, kwargs=dict(ready_event=ready, **kw),
                          daemon=True)
    th.start()
    assert ready.wait(10), "server never bound"
    return th, ready.server


def _stop(th, srv):
    srv.shutdown()
    th.join(10)
    assert not th.is_alive()


@pytest.mark.parametrize("resident", [True, False])
def test_engine_handles_protocol_as_swtpu(resident, tmp_path):
    """The port's engine and swtpu's (its scan backend) answer the same
    lines: SEQ, TOP with the query's own read tied twice, an unknown
    command, a comment, a blank line and QUIT."""
    rng = np.random.default_rng(60)
    targets = _targets(rng, 5)
    q = rng.integers(0, 4, size=16).astype(np.int8)
    targets[1] = targets[3] = q  # reads db2 and db4 tie at the top
    log = EventLog(tmp_path / "events.jsonl")
    engine = _make_engine(targets, resident=resident, event_log=log)
    ref = RefServeEngine(RefBank(backend="scan"), engine.names, targets)
    want = score_many_vs_one(q, targets)
    for line in (f"SEQ {_seq_str(q)}", f"TOP 3 {_seq_str(q)}", "BOGUS x", "# note", ""):
        got, ref_lines = engine.handle(line), ref.handle(line)
        assert _no_ns(got) == _no_ns(ref_lines)
    assert _scores(engine.handle(f"SEQ {_seq_str(q)}")) == list(want)
    top = engine.handle(f"TOP 3 {_seq_str(q)}")
    assert top[:2] == ["# top: >db2 score: 80", "# top: >db4 score: 80"]
    assert engine.handle("BOGUS x") == ["# error: unknown command 'BOGUS' (SEQ/TOP/QUIT)"]
    assert engine.handle("QUIT") is None
    assert engine.served == 4
    log.close()
    kinds = [e.kind for e in EventLog.parse(tmp_path / "events.jsonl")]
    assert kinds == (["loaded", "loaded_topk"] * 2 if resident else ["stream"] * 4)


def test_two_concurrent_clients_unix_socket(tmp_path):
    """Two clients connect at once and interleave jobs on one resident
    database; every response is right and complete."""
    rng = np.random.default_rng(61)
    targets = _targets(rng, 6)
    engine = _make_engine(targets)
    path = str(tmp_path / "swtpu.sock")
    th, srv = _serve_in_thread(engine=engine, unix_path=path)
    queries = [rng.integers(0, 4, size=int(rng.integers(10, 25))).astype(np.int8)
               for _ in range(4)]
    wants = [score_many_vs_one(q, targets) for q in queries]
    results = {}

    def client(cid, my_queries):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(path)
        out = []
        for qi in my_queries:
            out.append(_scores(client_request(s, f"SEQ {_seq_str(queries[qi])}")))
            out.append(client_request(s, f"TOP 1 {_seq_str(queries[qi])}"))
        s.sendall(b"QUIT\n")
        s.close()
        results[cid] = out

    clients = [threading.Thread(target=client, args=(1, [0, 1])),
               threading.Thread(target=client, args=(2, [2, 3]))]
    for t in clients:
        t.start()
    for t in clients:
        t.join(60)
    try:
        assert not any(t.is_alive() for t in clients)
        assert set(results) == {1, 2}
        for cid, qis in ((1, [0, 1]), (2, [2, 3])):
            out = results[cid]
            for j, qi in enumerate(qis):
                assert out[2 * j] == list(wants[qi])
                assert f"score: {max(wants[qi])}" in out[2 * j + 1][0]
        assert engine.served == 8
    finally:
        _stop(th, srv)


def test_cli_serve_socket_end_to_end(tmp_path, monkeypatch):
    """`serve --socket` through the CLI, driven by a client over the wire,
    then shut down; the CLI returns 0 and reports what it served."""
    lib = tmp_path / "lib.fa"
    assert ref_main(["generate", "-n", "5", "-L", "24", "-o", str(lib), "--seed", "62"]) == 0
    path = str(tmp_path / "cli.sock")
    ready = threading.Event()
    real_serve = server.serve_socket
    monkeypatch.setattr(server, "serve_socket",
                        lambda engine, **kw: real_serve(engine, ready_event=ready, **kw))
    rc = {}
    th = threading.Thread(target=lambda: rc.setdefault("rc", main(
        ["--device", "cpu", "serve", "-l", str(lib), "--socket", path])), daemon=True)
    th.start()
    assert ready.wait(30), "server never bound"
    from swtpu.io.loader import load_encoded

    libdb = load_encoded(str(lib))
    reads = [libdb.read(i) for i, nm in enumerate(libdb.names) if not nm.startswith("query")]
    q = np.random.default_rng(63).integers(0, 4, size=14).astype(np.int8)
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(path)
    try:
        assert _scores(client_request(s, f"SEQ {_seq_str(q)}")) == list(
            score_many_vs_one(q, reads))
        assert client_request(s, "NOPE")[0].startswith("# error:")
    finally:
        s.close()
    _stop(th, ready.server)
    assert rc == {"rc": 0}


def test_tcp_port_serving():
    """serve_socket(port=0) speaks the same protocol over TCP."""
    rng = np.random.default_rng(64)
    targets = _targets(rng, 4)
    engine = _make_engine(targets)
    th, srv = _serve_in_thread(engine=engine, port=0)
    try:
        s = socket.create_connection(("127.0.0.1", srv.server_address[1]), timeout=10)
        q = rng.integers(0, 4, size=12).astype(np.int8)
        assert _scores(client_request(s, f"SEQ {_seq_str(q)}")) == list(
            score_many_vs_one(q, targets))
        s.close()
    finally:
        _stop(th, srv)


def test_unix_socket_path_reusable(tmp_path):
    """A stale socket file left by a dead daemon does not block the next
    one: the server unlinks it before binding, and again at shutdown."""
    rng = np.random.default_rng(65)
    targets = _targets(rng, 3)
    engine = _make_engine(targets)
    path = tmp_path / "reuse.sock"
    stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stale.bind(str(path))
    stale.close()  # the file stays on disk
    th, srv = _serve_in_thread(engine=engine, unix_path=str(path))
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(str(path))
        q = rng.integers(0, 4, size=10).astype(np.int8)
        assert len(client_request(s, f"SEQ {_seq_str(q)}")) == 3
        s.close()
    finally:
        _stop(th, srv)
    assert not path.exists()


def test_serve_engine_pipelines_dispatch():
    """The lock covers only the dispatch: when a result is copied back,
    the lock is free for the next client's dispatch."""
    rng = np.random.default_rng(66)
    targets = _targets(rng, 5)
    engine = _make_engine(targets)
    seen = {}
    orig_score, orig_topk = engine._score_finish, engine._topk_finish

    def score_finish(q, dev, t0):
        seen["seq_locked"] = engine._lock.locked()
        return orig_score(q, dev, t0)

    def topk_finish(st):
        seen["top_locked"] = engine._lock.locked()
        return orig_topk(st)

    engine._score_finish, engine._topk_finish = score_finish, topk_finish
    q = rng.integers(0, 4, size=12).astype(np.int8)
    assert _scores(engine.handle(f"SEQ {_seq_str(q)}")) == list(score_many_vs_one(q, targets))
    assert len(engine.handle(f"TOP 2 {_seq_str(q)}")) == 2
    assert seen == {"seq_locked": False, "top_locked": False}


def _fasta(path, rng, qlens, n=20, query_path=None):
    """Query records `query0`, `query1`, ... of `qlens` bases, then n reads
    of 0-90 bases (read 3 empty, read 7 the first query); the queries go
    to `query_path` instead where one is given.  Returns the queries."""
    queries = ["".join(CODE_BASES[int(c)] for c in rng.integers(0, 4, size=k))
               for k in qlens]
    reads = ["".join(CODE_BASES[int(c)] for c in rng.integers(0, 4, size=k))
             for k in rng.integers(0, 90, size=n)]
    reads[3], reads[7] = "", queries[0]
    qrecs = [FastaRecord(f"query{i}", s) for i, s in enumerate(queries)]
    rrecs = [FastaRecord(f"db{i}", s) for i, s in enumerate(reads)]
    if query_path is None:
        write_fasta(path, qrecs + rrecs)
    else:
        write_fasta(query_path, qrecs)
        write_fasta(path, rrecs)
    return queries


def test_cli_serve_input_lines_equal_swtpu(tmp_path, capsys):
    """`serve --input` on the port (resident, up to 512 bases) and on
    swtpu (its scan backend): the same lines, the ns field aside."""
    rng = np.random.default_rng(67)
    lib = tmp_path / "lib.fa"
    short, long_ = _fasta(lib, rng, (40, 300))
    cmds = tmp_path / "cmds.txt"
    cmds.write_text(f"SEQ {short}\nTOP 3 {short}\nSEQ {long_}\nHUH\nQUIT\nSEQ {short}\n")
    events = tmp_path / "events.jsonl"
    assert main(["--device", "cpu", "serve", "-l", str(lib), "--input", str(cmds),
                 "--events", str(events)]) == 0
    got = capsys.readouterr()
    assert "# served 3 queries" in got.err and "resident on cpu" in got.err
    assert ref_main(["--platform", "cpu", "serve", "-l", str(lib), "--input", str(cmds),
                     "--backend", "scan"]) == 0
    want = capsys.readouterr().out.splitlines()
    lines = got.out.splitlines()
    assert len(lines) == 20 + 3 + 20 + 1 and _no_ns(lines) == _no_ns(want)
    assert lines[20] == "# top: >db7 score: 200"
    assert [e.kind for e in EventLog.parse(events)] == ["loaded", "loaded_topk", "loaded"]


def test_cli_serve_sharded_lines_equal_serve_and_swtpu(tmp_path, capsys):
    """`serve --sharded` (the library on a mesh; on the CPU a mesh of the
    one device): the unsharded serve's lines, up to a 300-base query on
    chained tiles, and swtpu's `serve --sharded` lines (its stream backend
    in interpret mode over its 8 virtual devices), the ns field aside."""
    rng = np.random.default_rng(70)
    lib = tmp_path / "lib.fa"
    short, long_ = _fasta(lib, rng, (40, 300))
    cmds = tmp_path / "cmds.txt"
    cmds.write_text(f"SEQ {short}\nTOP 3 {short}\nSEQ {long_}\nHUH\nQUIT\n")
    events = tmp_path / "events.jsonl"
    base = ["--device", "cpu", "serve", "-l", str(lib), "--input", str(cmds)]
    assert main([*base, "--sharded", "--events", str(events)]) == 0
    got = capsys.readouterr()
    assert "across 1 device shards" in got.err and "# served 3 queries" in got.err
    assert main(base) == 0
    lines = got.out.splitlines()
    assert len(lines) == 20 + 3 + 20 + 1
    assert _no_ns(lines) == _no_ns(capsys.readouterr().out.splitlines())
    assert lines[20] == "# top: >db7 score: 200"
    assert [e.kind for e in EventLog.parse(events)] == [
        "loaded_sharded", "loaded_sharded_topk", "loaded_sharded"]
    short_cmds = tmp_path / "short.txt"
    short_cmds.write_text(f"SEQ {short}\nTOP 3 {short}\nQUIT\n")
    flags = ["serve", "-l", str(lib), "--input", str(short_cmds), "--sharded",
             "--max-query-len", "128", "--backend", "stream"]
    assert main(["--device", "cpu", *flags]) == 0
    got = capsys.readouterr().out.splitlines()
    assert ref_main(["--platform", "cpu", *flags]) == 0
    assert len(got) == 23 and _no_ns(got) == _no_ns(capsys.readouterr().out.splitlines())


@pytest.mark.parametrize("backend", ["stream", "pallas"])
def test_cli_score_all_queries_lines_equal_swtpu(tmp_path, capsys, backend):
    """`score --all-queries` on the port, a resident database in waves on
    the stream backend (queries of 40, 300 and 20 bases) and
    score_database a query on the bucketed one, against swtpu's CLI on
    its stream backend and on its scan backend (its bucketed one runs
    its kernels in interpret mode, minutes for a 300-base query)."""
    rng = np.random.default_rng(68)
    lib, qfa = tmp_path / "lib.fa", tmp_path / "q.fa"
    _fasta(lib, rng, (40, 300, 20), query_path=qfa)
    flags = ["score", "-q", str(qfa), "-l", str(lib), "--all-queries", "--topk", "2"]
    events = tmp_path / "events.jsonl"
    port_out, ref_out = tmp_path / "port.txt", tmp_path / "ref.txt"
    assert main(["--device", "cpu", *flags, "--backend", backend, "-o", str(port_out),
                 "--events", str(events)]) == 0
    port_err = capsys.readouterr().err
    ref_backend = {"stream": "stream", "pallas": "scan"}[backend]
    assert ref_main(["--platform", "cpu", *flags, "--backend", ref_backend,
                     "-o", str(ref_out)]) == 0
    ref_err = capsys.readouterr().err
    got = port_out.read_text().splitlines()
    assert len(got) == 3 * 21 and got[0] == "# query: query0" and got[21] == "# query: query1"
    assert _no_ns(got) == _no_ns(ref_out.read_text().splitlines())
    tops = [l for l in port_err.splitlines() if l.startswith("# top[")]
    assert len(tops) == 6 and tops == [l for l in ref_err.splitlines() if l.startswith("# top[")]
    assert tops[0] == "# top[query0]: >db7 score: 200"
    assert [e.kind for e in EventLog.parse(events)] == ["query"] * 3


@pytest.mark.parametrize(
    "argv,match",
    [
        (["serve", "--sharded", "--backend", "pallas"], "--sharded requires the stream backend"),
        (["serve", "--socket", "x.sock", "--port", "0"], "mutually exclusive"),
        (["serve", "--sharded", "--backend", "scan"], "--sharded requires the stream backend"),
        (["score", "--all-queries", "-t", "5"], "does not compose with --resume/--timeout"),
    ],
)
def test_cli_serving_flag_errors_exit_cleanly(tmp_path, argv, match):
    lib = tmp_path / "lib.fa"
    _fasta(lib, np.random.default_rng(69), (30,))
    files = ["-l", str(lib)] + (["-q", str(lib)] if argv[0] == "score" else [])
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", argv[0], *files, *argv[1:]])

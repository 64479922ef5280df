"""Multi-client serving daemon on a torch device.

The port of ``swtpu.server``: one long-lived process holds the
device-resident database and serves any number of concurrent clients over
a UNIX or TCP socket, one job in flight per client.  Only the dispatch
runs under the engine's lock, on the current CUDA stream, so the device
runs the jobs in dispatch order; each client's copy back runs outside the
lock, so one client waits on its scores while the next one's kernels are
already enqueued.

Wire protocol (line-oriented, the same commands as ``serve``'s stdin):
    SEQ <bases>        -> one `@..ns: >name score: S` line per read
    TOP <k> <bases>    -> k `# top: >name score: S` lines
    QUIT               -> closes this client's connection
Every response block ends with a single `.` line (the terminator clients
read to); errors respond `# error: ...` and the terminator, and keep the
connection open.
"""

from __future__ import annotations

import os
import socket
import socketserver
import threading
import time
from typing import List, Optional

from swtpu_torch.io.encode import encode_seq


def format_score_line(name: str, score: int, ns: int) -> str:
    """The RTL testbench's golden line format (`@<time>ns: >dbK score: S`,
    ScoreBank/ScoreBank_v1_tb.sv:280-282), shared by the CLI's writer and
    the daemon: the port's copy of ``swtpu.server.format_score_line``,
    byte for byte."""
    return f"@{ns:>9}ns: \t{'>' + name:>10} score: \t{int(score):>10}"


class ServeEngine:
    """The scoring engine behind every serve front end (the stdin loop,
    the socket server): owns the bank, the resident database and the
    dispatch lock.

    db: a :class:`swtpu_torch.bank.scorebank.LoadedDatabase` on the stream
    backend, or a :class:`swtpu_torch.bank.serving.ShardedLoadedDatabase`
    (mesh-resident); None scores each request with one ``score_database``
    call under the lock (the bucketed backends' route)."""

    def __init__(self, bank, names, targets, db=None, event_log=None):
        from swtpu_torch.bank.serving import ShardedLoadedDatabase

        self.bank = bank
        self.names = names
        self.targets = targets
        self.db = db
        self.event_log = event_log
        if db is None:
            self._score_dispatch = lambda q: bank.score_database(
                q, targets, event_log=event_log)
            self._score_finish = lambda q, res, t0: res
            self._topk_dispatch = lambda q, k: bank.score_database(
                q, targets, event_log=event_log).top_k(k)
            self._topk_finish = lambda devs: devs
        elif isinstance(db, ShardedLoadedDatabase):
            from swtpu_torch.bank.serving import (
                dispatch_loaded_sharded, finish_loaded_sharded, finish_topk_loaded_sharded,
            )

            self._score_dispatch = lambda q: dispatch_loaded_sharded(q, db)
            self._score_finish = lambda q, dev, t0: finish_loaded_sharded(
                bank, q, db, dev, t0, event_log=event_log)
            self._topk_dispatch = lambda q, k: (
                time.perf_counter(), q,
                dispatch_loaded_sharded(q, db, k=min(k, db.n_reads) or 1, full_scores=False))
            self._topk_finish = lambda st: finish_topk_loaded_sharded(
                st[1], db, st[2], st[0], event_log=event_log)
        else:
            self._score_dispatch = lambda q: bank._dispatch_loaded(q, db)
            self._score_finish = lambda q, dev, t0: bank._finish_loaded(
                dev, q, db, t0, event_log=event_log)
            self._topk_dispatch = lambda q, k: (
                time.perf_counter(), q, bank._dispatch_topk_loaded(q, db, k))
            self._topk_finish = lambda st: bank._finish_topk_loaded(
                st[2], st[1], db, st[0], event_log=event_log)
        self.t_start = time.perf_counter()
        self.served = 0
        # one dispatch at a time: the bank is one device, and clients
        # interleave at job granularity
        self._lock = threading.Lock()

    def handle(self, line: str) -> Optional[List[str]]:
        """One protocol line -> response lines (no terminator), or None for
        QUIT.  Protocol errors come back as `# error:` lines."""
        line = line.strip()
        if not line or line.startswith("#"):
            return []
        try:
            cmd, rest = (line.split(None, 1) + [""])[:2]
            cmd = cmd.upper()
            if cmd == "QUIT":
                return None
            if cmd == "SEQ":
                q = encode_seq(rest.strip())
                t0 = time.perf_counter()
                with self._lock:
                    dev = self._score_dispatch(q)
                    self.served += 1
                res = self._score_finish(q, dev, t0)
                out = []
                for name, s in zip(self.names, res.scores):
                    ns = int((time.perf_counter() - self.t_start) * 1e9)
                    out.append(format_score_line(name, s, ns))
                return out
            if cmd == "TOP":
                k_str, seq = rest.split(None, 1)
                q = encode_seq(seq.strip())
                with self._lock:
                    devs = self._topk_dispatch(q, int(k_str))
                    self.served += 1
                top = self._topk_finish(devs)
                return [f"# top: >{self.names[i]} score: {s}" for s, i in top]
            raise ValueError(f"unknown command {cmd!r} (SEQ/TOP/QUIT)")
        except (ValueError, KeyError) as e:
            return [f"# error: {e}"]


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        engine: ServeEngine = self.server.engine  # type: ignore[attr-defined]
        for raw in self.rfile:
            resp = engine.handle(raw.decode("utf-8", "replace"))
            if resp is None:  # QUIT
                break
            self.wfile.write(("\n".join(resp + ["."]) + "\n").encode())
            self.wfile.flush()


class _ThreadedUnixServer(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class _ThreadedTCPServer(socketserver.ThreadingMixIn, socketserver.TCPServer):
    daemon_threads = True
    allow_reuse_address = True


def serve_socket(
    engine: ServeEngine,
    unix_path: Optional[str] = None,
    port: Optional[int] = None,
    ready_event: Optional[threading.Event] = None,
):
    """Blocking socket server: one thread per client, dispatches
    serialised by the engine's lock.  Exactly one of unix_path / port
    (TCP on 127.0.0.1; 0 lets the OS pick).  With `ready_event`, sets it
    once the socket listens and hands the server over as
    ``ready_event.server`` (for ``shutdown()``)."""
    if (unix_path is None) == (port is None):
        raise ValueError("pass exactly one of unix_path / port")
    if unix_path is not None:
        # SO_REUSEADDR does nothing for AF_UNIX: a stale socket file from
        # an earlier daemon would fail the bind, so unlink it first
        try:
            if os.path.exists(unix_path):
                os.unlink(unix_path)
        except OSError:
            pass
        srv = _ThreadedUnixServer(unix_path, _Handler)
    else:
        srv = _ThreadedTCPServer(("127.0.0.1", port), _Handler)
    srv.engine = engine  # type: ignore[attr-defined]
    if ready_event is not None:
        ready_event.server = srv  # type: ignore[attr-defined]
        ready_event.set()
    try:
        srv.serve_forever(poll_interval=0.1)
    finally:
        srv.server_close()
        if unix_path is not None:
            try:
                os.unlink(unix_path)
            except OSError:
                pass


def client_request(sock: socket.socket, line: str) -> List[str]:
    """Send one command line and read the response lines up to the `.`
    terminator (which is dropped)."""
    sock.sendall((line.rstrip("\n") + "\n").encode())
    buf = bytearray()
    while not buf.endswith(b"\n.\n") and buf != b".\n":
        chunk = sock.recv(1 << 20)
        if not chunk:
            break
        buf += chunk
    return [l for l in buf.decode().splitlines() if l != "."]

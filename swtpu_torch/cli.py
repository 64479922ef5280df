"""swtpu_torch command-line scorer: swtpu's subcommands on a torch device.

    python -m swtpu_torch.cli [--device cuda|cpu] score -q query.fa \\
        -l library.fa [-o out.txt] [--topk K] [--events log.jsonl] \\
        [--backend auto|stream|pallas|scan] [--score-width W] [--buckets 32,128,...] \\
        [--all-queries] [--resume job.npz] [--profile DIR] [-t SECONDS]
    python -m swtpu_torch.cli [--device cuda|cpu] serve -l library.fa \\
        [--input commands.txt | --socket PATH | --port N] [--max-query-len 512] \\
        [--sharded]
    python -m swtpu_torch.cli oracle -q query.fa -l library.fa [-o out.txt]
    python -m swtpu_torch.cli generate -n 100 -L 128 -o data.fa [--seed 0]
    python -m swtpu_torch.cli diff a.txt b.txt
    python -m swtpu_torch.cli events log.jsonl
    python -m swtpu_torch.cli [--device cuda|cpu] regress [--suite suites/default.json]
    python -m swtpu_torch.cli [--device cuda|cpu] bench

`score --all-queries` scores every record of the query file; on the stream
backend the library loads onto the device once.  `score --resume` saves
the job's progress after every unit and, rerun, scores only what is left
(``swtpu_torch.bank.resume``); `--profile` writes a ``torch.profiler``
Chrome trace.  `serve` loads the library once and answers SEQ / TOP / QUIT
lines from stdin, a file or concurrent socket clients
(``swtpu_torch.server``); with `--sharded` the library is spread over
every visible GPU (``swtpu_torch.bank.serving``).  `oracle` scores with
the exact numpy oracle, `generate` writes a random FASTA, `diff` compares
two score files by read name and `events` summarises an event log; none of
these four needs a card, and each writes what swtpu's does.  `regress`
runs a config-driven regression suite (``swtpu_torch.testing.suite``) and
prints swtpu's PASS / FAIL / SKIP lines.  `bench` runs the headline GCUPS
benchmark (``swtpu_torch.bench``) and prints swtpu's one JSON line.

Output lines are swtpu's (``@<time>ns: >dbK score: S``, the reference RTL
testbench's golden format), so `diff` compares the two packages' outputs
directly.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from swtpu_torch.server import format_score_line


def _load(query_path: str, library_path: str):
    """Load query + library through the dense native pipeline: the library
    stays one int8 matrix end to end.  The query is the first record named
    `query*` (else the first record)."""
    from swtpu_torch.io.loader import load_encoded

    qdb = load_encoded(query_path)
    if not qdb.names:
        raise SystemExit(f"query file has no records: {query_path}")
    qidx = [i for i, nm in enumerate(qdb.names) if nm.startswith("query")] or [0]
    query = qdb.read(qidx[0]).copy()
    lib = load_encoded(library_path)
    return query, *_split_lib(lib)


def _split_lib(lib):
    """(names, db) of the library without its `query*` records."""
    from swtpu_torch.io.loader import EncodedDB

    rows = [i for i, nm in enumerate(lib.names) if not nm.startswith("query")]
    if len(rows) == len(lib.names):
        db = lib
    else:
        sel = np.asarray(rows, dtype=np.int64)
        db = EncodedDB([lib.names[i] for i in rows], lib.mat[sel], lib.lens[sel])
    return db.names, db


def _load_all_queries(query_path: str):
    """Every record of the query FASTA as (name, codes) pairs."""
    from swtpu_torch.io.loader import load_encoded

    qdb = load_encoded(query_path)
    if not qdb.names:
        raise SystemExit(f"query file has no records: {query_path}")
    return [(qdb.names[i], qdb.read(i).copy()) for i in range(len(qdb.names))]


def _emit(out, names, scores, t_start):
    for name, s in zip(names, scores):
        ns = int((time.perf_counter() - t_start) * 1e9)
        out.write(format_score_line(name, s, ns) + "\n")


def _score_all_queries(args, bank, names, targets, pairs, event_log=None) -> int:
    """Score every query record against the library.  On the stream
    backend the library loads onto the device once
    (``ScoreBank.load_database``) and each query ships only its register;
    the bucketed backend loops ``score_database``."""
    t0 = time.perf_counter()
    if bank.backend == "stream":
        db = bank.load_database(targets, max_query_len=max(len(q) for _, q in pairs))
        # waves: every query of a wave is enqueued before any result is
        # copied back (score_loaded_many); a wave bounds host memory to
        # WAVE * n_reads * 4 bytes of scores
        WAVE = 32

        def run_all():
            for lo in range(0, len(pairs), WAVE):
                chunk = pairs[lo : lo + WAVE]
                yield from bank.score_loaded_many([q for _, q in chunk], db)
    else:
        def run_all():
            for _, q in pairs:
                yield bank.score_database(q, targets)
    out = open(args.output, "w") if args.output else sys.stdout
    tot_cells = 0
    tot_s = 0.0
    try:
        for (name, _), res in zip(pairs, run_all()):
            out.write(f"# query: {name}\n")
            _emit(out, names, res.scores, t0)
            tot_cells += res.cells
            tot_s += res.elapsed_s
            if event_log is not None:
                from swtpu_torch.utils.metrics import BatchEvent

                event_log.emit(
                    BatchEvent(
                        "query", t_wall=time.time(), elapsed_s=res.elapsed_s,
                        reads=len(targets), cells=res.cells,
                        padded_cells=res.padded_cells, note=f"query={name}",
                    )
                )
            if args.topk:
                for s, i in res.top_k(args.topk):
                    print(f"# top[{name}]: >{names[i]} score: {s}", file=sys.stderr)
    finally:
        if args.output:
            out.close()
    print(
        f"# {len(pairs)} queries x {len(targets)} reads, {tot_cells} cells "
        f"in {tot_s*1e3:.1f} ms -> {tot_cells/max(tot_s,1e-9)/1e9:.2f} GCUPS "
        f"on {bank.device}",
        file=sys.stderr,
    )
    return 0


def cmd_score(args) -> int:
    from swtpu_torch.bank import ScoreBank
    from swtpu_torch.bank.resume import score_database_resumable
    from swtpu_torch.config import Penalties, SWConfig
    from swtpu_torch.utils.metrics import profile_trace

    if args.score_width and args.backend not in ("auto", "pallas", "stream"):
        # a clean SystemExit like every other argument error: wrap-parity
        # lives in the stream and column kernels
        raise SystemExit(
            f"--score-width requires the stream or column kernel: use "
            f"--backend stream/pallas (or auto), not {args.backend!r}"
        )
    if args.all_queries and (args.resume or args.timeout):
        raise SystemExit(
            "--all-queries does not compose with --resume/--timeout "
            "(each query is one short job; rerun is the restart unit)"
        )
    pen = Penalties(args.match, args.mismatch, args.gap_open, args.gap_extend)
    query, names, targets = _load(args.query, args.library)
    max_len = max((len(t) for t in targets), default=0)
    try:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated ints: {args.buckets!r}")
    cfg = SWConfig(
        penalties=pen, target_buckets=buckets,
        score_width=args.score_width or None,
    )
    bank = ScoreBank(cfg, backend=args.backend, device=args.device)
    # the stream backend's target axis is unbounded; a bucketed backend
    # fails cleanly here, never with a packer traceback mid-run
    if bank.backend != "stream" and max_len > buckets[-1]:
        raise SystemExit(
            f"read length {max_len} exceeds bucket capacity {buckets[-1]} "
            f"for this configuration (raise --buckets, or use the stream "
            "backend)"
        )
    event_log = None
    if args.events:
        from swtpu_torch.utils.metrics import EventLog

        event_log = EventLog(args.events)
    if args.all_queries:
        try:
            with profile_trace(args.profile, bank.device):
                return _score_all_queries(args, bank, names, targets,
                                          _load_all_queries(args.query), event_log)
        except ValueError as e:  # a width or state the kernels refuse
            raise SystemExit(str(e))
        finally:
            if event_log is not None:
                event_log.close()
    t0 = time.perf_counter()

    def _run():
        try:
            if args.resume:
                return score_database_resumable(bank, query, targets, args.resume)
            return bank.score_database(query, targets, event_log=event_log)
        except ValueError as e:  # a width or state the kernels refuse
            return e

    with profile_trace(args.profile, bank.device):
        res = _run_with_deadline(_run, args.timeout)
    if res is None:
        print(f"# TIMEOUT after {args.timeout}s", file=sys.stderr)
        if event_log is not None:
            event_log.close()
        return 16
    if event_log is not None:
        event_log.close()
    if isinstance(res, ValueError):
        raise SystemExit(str(res))
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        _emit(out, names, res.scores, t0)
    finally:
        if args.output:
            out.close()
    print(
        f"# {len(targets)} reads, {res.cells} cells in {res.elapsed_s*1e3:.1f} ms "
        f"-> {res.gcups:.2f} GCUPS on {bank.device} (pad efficiency "
        f"{res.cells/max(res.padded_cells,1):.1%})",
        file=sys.stderr,
    )
    if args.topk:
        for s, i in res.top_k(args.topk):
            print(f"# top: >{names[i]} score: {s}", file=sys.stderr)
    return 0


def _run_with_deadline(run, timeout):
    """run() on this thread, or with a hard deadline of `timeout` seconds
    (> 0) on a worker thread; None when the deadline passed first."""
    if timeout <= 0:
        return run()
    box = {}

    def _work():
        try:
            box["res"] = run()
        except Exception as e:  # re-raised on the calling thread below
            box["err"] = e

    th = threading.Thread(target=_work, daemon=True)
    th.start()
    th.join(timeout=timeout)
    if "err" in box:
        raise box["err"]
    return box.get("res")


def cmd_serve(args) -> int:
    """Load the library once (resident on the device on the stream
    backend), then answer SEQ / TOP / QUIT lines from stdin, `--input`, or
    concurrent clients on `--socket` / `--port` (``swtpu_torch.server``).
    Responses: one `@..ns: >name score: S` block per SEQ (as `score`
    writes), `# top: >name score: S` lines per TOP; an error prints
    `# error: ...` and the loop goes on."""
    from swtpu_torch.bank import ScoreBank
    from swtpu_torch.config import Penalties, SWConfig
    from swtpu_torch.io.loader import load_encoded
    from swtpu_torch.server import ServeEngine, serve_socket

    if args.socket and args.port is not None:
        raise SystemExit("--socket and --port are mutually exclusive")
    pen = Penalties(args.match, args.mismatch, args.gap_open, args.gap_extend)
    names, targets = _split_lib(load_encoded(args.library))
    bank = ScoreBank(SWConfig(penalties=pen), backend=args.backend, device=args.device)
    event_log = None
    if args.events:
        from swtpu_torch.utils.metrics import EventLog

        event_log = EventLog(args.events)
    db = None
    if bank.backend == "stream" and args.sharded:
        # mesh-resident serving: every visible GPU holds its shard (on
        # another device, a mesh of that one device)
        from swtpu_torch.parallel.mesh import make_mesh

        t0 = time.perf_counter()
        mesh = make_mesh() if bank.device.type == "cuda" else make_mesh(devices=[bank.device])
        db = bank.load_database_sharded(targets, mesh, max_query_len=args.max_query_len)
        print(f"# loaded {db.n_reads} reads across {db.n_shards} device shards in "
              f"{time.perf_counter()-t0:.2f}s (mesh-resident)", file=sys.stderr)
    elif bank.backend == "stream":
        t0 = time.perf_counter()
        db = bank.load_database(targets, max_query_len=args.max_query_len)
        print(f"# loaded {len(targets)} reads in {time.perf_counter()-t0:.2f}s "
              f"(resident on {bank.device})", file=sys.stderr)
    elif args.sharded:
        raise SystemExit("--sharded requires the stream backend")
    else:
        print(f"# serving {len(targets)} reads ({bank.backend})", file=sys.stderr)
    engine = ServeEngine(bank, names, targets, db=db, event_log=event_log)
    try:
        if args.socket or args.port is not None:
            where = args.socket or f"127.0.0.1:{args.port}"
            print(f"# serving on {where} (concurrent clients; SEQ/TOP/QUIT, "
                  "responses end with '.')", file=sys.stderr)
            try:
                serve_socket(engine, unix_path=args.socket or None, port=args.port)
            except KeyboardInterrupt:
                pass
        else:
            inp = open(args.input) if args.input else sys.stdin
            try:
                for line in inp:
                    resp = engine.handle(line)
                    if resp is None:  # QUIT
                        break
                    for out_line in resp:
                        print(out_line)
                    if resp:
                        sys.stdout.flush()
            finally:
                if args.input:
                    inp.close()
    finally:
        if event_log is not None:
            event_log.close()
    print(f"# served {engine.served} queries", file=sys.stderr)
    return 0


def cmd_oracle(args) -> int:
    """Score the library with the exact numpy oracle (no kernel, no
    card)."""
    from swtpu_torch.config import Penalties
    from swtpu_torch.oracle import score_many_vs_one

    pen = Penalties(args.match, args.mismatch, args.gap_open, args.gap_extend)
    query, names, targets = _load(args.query, args.library)
    t0 = time.perf_counter()
    scores = score_many_vs_one(query, targets, pen)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        _emit(out, names, scores, t0)
    finally:
        if args.output:
            out.close()
    return 0


def cmd_generate(args) -> int:
    """A random FASTA from a seed: the first record `>query`, the rest
    `>dbK` (the reference's data/generate.py layout)."""
    from swtpu_torch.io import CODE_BASES, FastaRecord, write_fasta

    rng = np.random.default_rng(args.seed)
    records: List[FastaRecord] = []
    for j in range(args.number):
        codes = rng.integers(0, 4, size=args.length)
        seq = "".join(CODE_BASES[int(c)] for c in codes)
        records.append(FastaRecord("query" if j == 0 else f"db{j}", seq))
    write_fasta(args.output, records)
    print(f"# wrote {args.number} reads x {args.length} nt to {args.output}", file=sys.stderr)
    return 0


def cmd_diff(args) -> int:
    """Compare two score files by read name, each in the RTL's
    `@..ns: >dbK score: S` lines or an ssearch36 -R table; exit 1 on any
    mismatch."""
    from swtpu_torch.testing.goldens import parse_rtl_out_file, parse_ssearch_scores

    def load(path):
        got = parse_rtl_out_file(path)
        return got if got else parse_ssearch_scores(path)

    a, b = load(args.a), load(args.b)
    common = sorted(set(a) & set(b))
    mism = {k: (a[k], b[k]) for k in common if a[k] != b[k]}
    only_a = sorted(set(a) - set(b))
    only_b = sorted(set(b) - set(a))
    print(f"# {len(common)} common IDs, {len(mism)} mismatches, "
          f"{len(only_a)} only in A, {len(only_b)} only in B")
    for k, (va, vb) in sorted(mism.items()):
        print(f"MISMATCH {k}: {va} != {vb}")
    return 1 if mism else 0


def cmd_events(args) -> int:
    """Print a JSONL event log one event a line, then its totals."""
    from swtpu_torch.utils.metrics import EventLog

    events = EventLog.parse(args.log)
    tot_cells = tot_reads = 0
    tot_s = 0.0
    for e in events:
        pad_eff = f"{e.cells/e.padded_cells:6.1%}" if e.padded_cells else "   n/a"
        print(
            f"{e.t_wall:14.3f} {e.kind:>8} reads={e.reads:<8} "
            f"cells={e.cells:<12} pad_eff={pad_eff} "
            f"{e.elapsed_s*1e3:9.2f} ms {e.gcups:8.2f} GCUPS {e.note}"
        )
        tot_cells += e.cells
        tot_reads += e.reads
        tot_s += e.elapsed_s
    if tot_s > 0:
        print(
            f"# total: {len(events)} events, {tot_reads} reads, "
            f"{tot_cells} cells in {tot_s*1e3:.1f} ms "
            f"-> {tot_cells/tot_s/1e9:.2f} GCUPS"
        )
    return 0


def cmd_regress(args) -> int:
    """Run a regression suite on --device; exit 1 on any failure."""
    import torch

    from swtpu_torch.testing.suite import main_cli

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"regress --device {args.device}: no CUDA device is available "
            "(pass --device cpu to run the suite on the CPU)"
        )
    return main_cli(args.suite, args.device)


def cmd_bench(args) -> int:
    """The headline GCUPS benchmark on --device; exit 1 when a stage fails."""
    from swtpu_torch.bench import main as bench_main

    return bench_main(args.device)


def _add_pen_args(p):
    p.add_argument("--match", type=int, default=5)
    p.add_argument("--mismatch", type=int, default=-4)
    p.add_argument("--gap-open", dest="gap_open", type=int, default=-12)
    p.add_argument("--gap-extend", dest="gap_extend", type=int, default=-4)


BACKEND_HELP = ("stream: the streamed wavefront; pallas: the bucketed column "
                "kernels; scan: the bucketed batches through the column scan "
                "(torch ops); auto: stream, or pallas with --score-width")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="swtpu_torch", description=__doc__)
    ap.add_argument(
        "--device", default="cuda",
        help="torch device the kernels run on (cuda: the CUDA kernels; "
        "cpu: their plain PyTorch versions)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("score", help="score a library against a query")
    ps.add_argument("-q", "--query", required=True)
    ps.add_argument("-l", "--library", required=True)
    ps.add_argument("-o", "--output")
    ps.add_argument(
        "-t", "--timeout", type=int, default=0,
        help="hard job deadline in seconds; exit 16 on expiry. 0 = none",
    )
    ps.add_argument("--topk", type=int, default=0)
    ps.add_argument(
        "--backend", default="auto", choices=["auto", "scan", "pallas", "stream"],
        help=BACKEND_HELP,
    )
    ps.add_argument(
        "--score-width", dest="score_width", type=int, default=0,
        help="emulate the RTL's SCORE_WIDTH-bit biased registers, including "
        "overflow wrap (0 = exact int32 scoring; the hardware default is 12)",
    )
    ps.add_argument(
        "--buckets", default="32,128,512,2048,8192",
        help="target-length bucket ladder for the bucketed backend "
        "(SWConfig.target_buckets); the stream backend ignores it — its "
        "target axis is unbounded",
    )
    ps.add_argument(
        "--all-queries", dest="all_queries", action="store_true",
        help="score every query-file record against the library (stream "
        "backend: the library loads onto the device once and each query "
        "ships only its register)",
    )
    ps.add_argument("--events", help="write per-batch JSONL event log here")
    ps.add_argument("--profile", help="write a torch.profiler Chrome trace into this "
                    "directory")
    ps.add_argument("--resume", help="resumable job state file: progress is saved "
                    "after every unit, and a rerun scores only what is left")
    _add_pen_args(ps)
    ps.set_defaults(fn=cmd_score)

    po = sub.add_parser("oracle", help="score with the numpy oracle (no kernel)")
    po.add_argument("-q", "--query", required=True)
    po.add_argument("-l", "--library", required=True)
    po.add_argument("-o", "--output")
    _add_pen_args(po)
    po.set_defaults(fn=cmd_oracle)

    pg = sub.add_parser("generate", help="generate a random FASTA")
    pg.add_argument("-n", "--number", type=int, default=100)
    pg.add_argument("-L", "--length", type=int, default=128)
    pg.add_argument("-o", "--output", required=True)
    pg.add_argument("--seed", type=int, default=0)
    pg.set_defaults(fn=cmd_generate)

    pv = sub.add_parser(
        "serve",
        help="load a library once (resident on the device) and score "
        "queries from stdin (SEQ/TOP/QUIT protocol)",
    )
    pv.add_argument("-l", "--library", required=True)
    pv.add_argument("--input", help="read commands from a file instead of stdin")
    pv.add_argument("--backend", default="auto",
                    choices=["auto", "scan", "pallas", "stream"], help=BACKEND_HELP)
    pv.add_argument(
        "--max-query-len", dest="max_query_len", type=int, default=512,
        help="query capacity the resident database is packed for",
    )
    pv.add_argument("--events", help="write per-query JSONL event log here")
    pv.add_argument(
        "--sharded", action="store_true",
        help="hold the library resident across all visible GPUs (mesh-sharded "
        "serving; queries broadcast, top-K merges across the shards)",
    )
    pv.add_argument(
        "--socket", help="serve concurrent clients on this UNIX socket "
        "path instead of stdin",
    )
    pv.add_argument(
        "--port", type=int, help="serve concurrent clients on this "
        "localhost TCP port instead of stdin",
    )
    _add_pen_args(pv)
    pv.set_defaults(fn=cmd_serve)

    pb = sub.add_parser("bench", help="run the headline GCUPS benchmark")
    pb.set_defaults(fn=cmd_bench)

    pd = sub.add_parser("diff", help="diff two score files by read ID")
    pd.add_argument("a")
    pd.add_argument("b")
    pd.set_defaults(fn=cmd_diff)

    pe = sub.add_parser("events", help="pretty-print a JSONL event log")
    pe.add_argument("log")
    pe.set_defaults(fn=cmd_events)

    pr = sub.add_parser("regress", help="run a config-driven regression suite")
    pr.add_argument("--suite", help="JSON suite file (defaults built in)")
    pr.set_defaults(fn=cmd_regress)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""swtpu_torch command-line scorer: the `score` subcommand of swtpu's CLI
on a torch device.

    python -m swtpu_torch.cli [--device cuda|cpu] score -q query.fa \\
        -l library.fa [-o out.txt] [--topk K] [--events log.jsonl] \\
        [--backend auto|stream|pallas] [--score-width W] [--buckets 32,128,...]

Output lines are swtpu's (``@<time>ns: >dbK score: S``, the reference RTL
testbench's golden format), so ``python -m swtpu.cli diff`` compares the
two packages' outputs directly.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import List, Optional

import numpy as np


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


def format_score_line(name: str, score: int, ns: int) -> str:
    """The RTL testbench's golden line format (`@<time>ns: >dbK score: S`,
    ScoreBank/ScoreBank_v1_tb.sv:280-282): the port's copy of
    ``swtpu.server.format_score_line``, byte for byte."""
    return f"@{ns:>9}ns: \t{'>' + name:>10} score: \t{int(score):>10}"


def _emit(out, names, scores, t_start):
    for name, s in zip(names, scores):
        ns = int((time.perf_counter() - t_start) * 1e9)
        out.write(format_score_line(name, s, ns) + "\n")


def cmd_score(args) -> int:
    from swtpu_torch.bank import ScoreBank
    from swtpu_torch.config import Penalties, SWConfig

    if args.score_width and args.backend not in ("auto", "pallas", "stream"):
        # a clean SystemExit like every other argument error: wrap-parity
        # lives in the stream and column kernels
        raise SystemExit(
            f"--score-width requires the stream or column kernel: use "
            f"--backend stream/pallas (or auto), not {args.backend!r}"
        )
    if args.backend == "scan":
        raise SystemExit(
            "--backend scan is not ported yet (ROADMAP item 10: scan "
            "backend); use --backend stream or pallas"
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
    t0 = time.perf_counter()

    def _run():
        try:
            return bank.score_database(query, targets, event_log=event_log)
        except ValueError as e:  # a width or state the kernels refuse
            return e

    if args.timeout > 0:
        # hard job deadline: report and exit non-zero instead of hanging
        box = {}

        def _work():
            try:
                box["res"] = _run()
            except Exception as e:  # re-raised on the main thread below
                box["err"] = e

        th = threading.Thread(target=_work, daemon=True)
        th.start()
        th.join(timeout=args.timeout)
        if "err" in box:
            raise box["err"]
        if "res" not in box:
            print(f"# TIMEOUT after {args.timeout}s", file=sys.stderr)
            if event_log is not None:
                event_log.close()
            return 16
        res = box["res"]
    else:
        res = _run()
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
        help="stream: the streamed wavefront; pallas: the bucketed column "
        "kernels; auto: stream, or pallas with --score-width (scan is not "
        "ported)",
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
    ps.add_argument("--events", help="write per-batch JSONL event log here")
    ps.add_argument("--match", type=int, default=5)
    ps.add_argument("--mismatch", type=int, default=-4)
    ps.add_argument("--gap-open", dest="gap_open", type=int, default=-12)
    ps.add_argument("--gap-extend", dest="gap_extend", type=int, default=-4)
    ps.set_defaults(fn=cmd_score)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

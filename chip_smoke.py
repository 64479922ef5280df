#!/usr/bin/env python3
"""Drive the swtpu_torch port's main path once on one CUDA GPU.

    python chip_smoke.py [--seed N]

Phases, each reported on its own line; any failure exits non-zero:
  1. device: a CUDA device is required; prints the card's name and power
     limit (nvidia-smi), its SM clock, torch's CUDA version and nvcc's
     version;
  2. build: compiles the wavefront, column, lane-major and microbenchmark
     kernels from swtpu_torch/ops/csrc (one nvcc per source, in parallel)
     and prints ptxas's report; loads the native host packer (g++) and
     fails if it did not load, so that host-stage times are its;
  3. kernel vs plain: each CUDA kernel's output must equal the plain
     PyTorch version's bit for bit: at 512 physical streams, the wavefront
     for every (segments, rows) that ScoreBank uses on CUDA and for
     rows=1, its ripple-H form at segments 1 and 4, and the chained tile
     over whole K-tile chains (K=2 at rows 16 and 1, K=4 at rows 16), a
     launch a tile, and the chain kernel (one launch a chain, also with
     one tile a block) on the same chains against both; the
     same wavefront shapes and both forms in the state modes, W-bit
     wrap-parity at W = 8, 12 and 16 on reads that pass the ceiling and
     float32 state (whose strip must also equal int32's), and whole chains
     of K=2 and K=4 at W = 12 (the 512-base query's own reads wrap) and in
     float32; the 16-bit states (int16, uint16 at +5/0 and at +5/-4 with
     no gap cost, bfloat16), two streams a thread, in both forms at rows
     1, 2, 4 and 8, at 512 physical streams and at 511 (the last pair's
     high half dead), and over whole K=2 chains at rows 8 on 512 and 511
     streams, a launch a tile and in one launch of the chain kernel (int16
     and exact uint16 also equal to int32; bfloat16 and
     wrapping uint16 must differ from it); on 4,096 ragged pairs, the
     column kernel (B4) at query widths 8, 32, 136 and 256, exact, at
     score widths 12 and 10 and in float32 and int16 state (those two also
     equal to int32), and the chained column tile (B5) over whole chains
     of K=2 and K=3, every tile's h/ms/is, exact, at width 10 and in
     float32 and int16; int16 (two pairs a warp) also at 4,095 pairs (the
     last warp's high half dead), B4 at widths 64 and 256 and a K=2
     chain; the lane-major kernel (B6) at 1 and 1,001
     pairs, query widths 1/40/128 and target widths 1/150/300; E1 for all
     16 (dtype, pattern) cases on its script's input at 2,000 steps (the
     table's shorter run); E2 for all 5 variants x 4 dtypes at 128
     streams x 256 steps with read starts, and on its script's inputs at
     512 streams, the kernel at 2,048 and 16,384 steps (the table's two
     runs) held on the first 2,048;
  4. main path: ScoreBank(device="cuda").score_database on five
     databases made from --seed: (a)-(c) short queries (the bench.py
     headline shape, a ragged short-query set and a mid-length set), then
     (d) and (e) long queries (a 256-base query against ragged reads, a
     512-base one against 128-base reads); a sample of 2048 reads and the
     top-10 reads must carry the oracle's scores, the wavefront kernel's
     launch counter must rise in every short case and the chain kernel's
     by one a call in every long case (its K tiles in one launch).  Then the bucketed
     column path, ScoreBank(backend="pallas", device="cuda"): (f) a
     128-base query against 262,144 ragged reads in three length buckets
     (three B4 launches per call), (g) case (e)'s query and reads (a B5
     chain of two tiles per call; every score must equal (e)'s, and the
     sample and top-10 the oracle's), and (h) score_pairs at the RTL's
     12-bit score width on 65,536 pairs of 24-512 bases, 1 in 64
     identical so that those over 409 bases wrap: 128 sampled pairs and
     16 wrapping ones must equal sw_score_single_biased (computed in
     worker processes).  Then pairs on the wavefront: (i) score_pairs on
     the default backend (stream) with 65,536 pairs over 4,096 distinct
     queries (8 wavefront launches a call), every score equal to the
     column path's (timed the same way, for the backend comparison) and
     2,048 sampled ones to the oracle's; (j) score_pairs
     at score width 12 on the stream backend, short pairs on the pair
     streams and 16 distinct 410-512-base queries on chained tiles (a
     chain of 4 tiles, one launch, each), every score equal to the column path's at width 12, 64
     sampled and 16 wrapping pairs to sw_score_single_biased; and
     score_database in the new modes: case (e) at width 12 equal to (e)'s
     exact scores, cases (a) and (d) with float32 state equal to their
     int32 scores; and at stream_rows=8 in int16 state on (c) and (e)
     (the sample and top-10 against the oracle) and in bfloat16 (256
     sampled reads against the plain path on the CPU), (e)'s 4 tiles one
     chain launch a call in each.  Then resident
     serving (phase "serving"): (k) load_database on (a)'s reads, every
     8,192nd replaced by one 128-base query (32 reads tied at the top),
     for 256 bases (segments 1, rows 16, K <= 2), score_loaded_many
     waves of 16 queries of 16-256 bases (warm, median of 3),
     score_loaded on each (warm,
     median of 3, beside score_database's on the same query) and
     topk_loaded(10) on three; the daemon: ServeEngine over (k)'s resident
     database and serve_socket on a UNIX socket in a thread, two client
     threads at once each sending SEQ (262,144 lines back), TOP 10 and
     QUIT, then a shutdown that must leave no thread or process; (l)
     load_database on (b)'s reads for 32 bases (segments 4, rows 4) and
     waves of 8 queries of 8-32 bases.  Every wave vector must equal
     score_database's on all reads, three queries a case the oracle's
     sample of 2,048 and top-10, every topk_loaded the full vector's
     top_k(10), and the daemon's lines score_loaded's and topk_loaded's.
     Each path's kernels' launch counters are set to 0 just before it
     and must have risen just after (serving: exactly one B1 a dispatch
     of a query of up to 128 bases, one B3 chain a longer one; its
     longest query's chain on the resident stream held as phase 5 holds
     the long cases' chains).
     Then the job layer (phase "jobs"), after the bucketed cases: (a) with
     stream_chunk_reads=65536 (4 chunks) and (b) with 100,000 (the last
     chunk 62,144 reads), every score equal to the one-shot call's and the
     oracle's sample and top-10, three warm walls of each in turns, one
     B1 launch a chunk, and one profiled call of each (device busy share,
     kernel launches, how much of each chunk's B1 ran while the host packed
     the next chunk, the largest packed stream); score_streams on (b)'s
     first 8,192 reads (B2's form, rows 1); a resumable job at (a) in
     chunks of 65,536 killed after its second chunk and rerun (two chunks
     scored, every score = the one-shot call's, the rerun's wall); seeded
     faults on (f)'s reads on the column path (every score = its
     score_database's; corrupted codes and scores caught by the guards);
     and the CLI on the card: score --resume twice (the rerun adopts the
     state and launches nothing) and --profile (a Chrome trace holding the
     wavefront kernel), each equal to the CLI's oracle by its diff.
     Then scoring across shards and processes (phase "sharded"), on a
     mesh of 4 shards that all lie on cuda:0 (the machine has one GPU):
     (m) make_sharded_stream_scorer on (a)'s reads (4 B1 a call) and on
     (d)'s (4 B3 chains of 2 tiles), every score = score_database's, the merged top-10 =
     its top_k(10), and its stages (shard packs, stack, copy, the rest)
     timed alone in turns with score_database; (n) make_sharded_topk on 4,096 ragged pairs on the
     column path (4 B4 a call) and on 256 pairs on the scan, = the oracle;
     (o) load_database_sharded over (k)'s reads: score_loaded_many_sharded,
     score_loaded_sharded and topk_loaded_sharded = the one-device resident
     answers (4 B1 a query of up to 128 bases, 4 B3 chains a longer
     one; the longest's chain on shard 0 held as in phase 5);
     (p) run_multihost in database mode on (c)'s reads in 2 worker
     processes on cuda:0 joined over gloo, plain, with a worker killed and
     with a lying worker, every score = (c)'s, each worker's B1 launches
     > 0, no process left; and the CLI's serve --sharded, its lines =
     serve's.  Walls (warm, median of 3) beside the one-device ones.
     Then the regression suites (phase "regress"): suites/default.json
     through run_suite on cuda and on cpu, the two outcome lists equal and
     each outcome passed or one of swtpu's skips (the stream corruptions
     caught on the card's wire path); suites/multihost.json through
     main_cli on cuda (each worker's B1 launches kept: "regress
     (workers)") and through `python -m swtpu_torch.cli regress` in a
     process of its own on the card, waited for or killed: 6 PASS lines,
     bad_shards=[1], both shards resumed, exit code 0, no process left;
     each suite's wall beside the card's name and power limit.
     Then swtpu's bench on the card (phase "bench"): `python -m
     swtpu_torch.cli bench` in a session of its own (exit code 0, the last
     stdout line swtpu's four keys with its metric and a value > 0, the
     stages on stderr, no process left); every stage of swtpu_torch.bench
     but `cpu` in this process, each launch's window = the oracle (the
     path "bench" of B1 and B4); `python -m swtpu_torch.bench_scaling` and
     its `--multihost` (1, 2 and 4 gloo workers on the card), their lines
     counted, no process left; and, once phase 5 has timed B1 in float32 at
     (a), the headline (the stage's and the CLI's) within 10 % of (a)'s
     cells over that time;
  5. kernel vs plain at the main path's shapes: each short case's batch,
     at the geometry ScoreBank chose for it, through both; the full strips
     must be bit-equal, but case (a)'s on its first 4096 steps, as the
     full run's and as a run of the cut in 8 slices (its plain strip in
     full took 163-200 s); the wavefront runs in the time slices its
     wrapper chooses, and is timed in one slice too.  Each long case's
     chain runs through the chain kernel (one launch, the main path's)
     and through the per-tile kernel at full length: the chain kernel's
     strip must equal the per-tile chain's in full and the plain chain's
     on the first 4096 steps (hold_chain), in int32, at W = 12 and in
     float32 at (d); every tile must equal, in full, the same
     kernel in one slice, and is held against the plain version on the
     first 4096 steps, both as the full run's first steps and as a run of
     the cut in 8 slices (see phase_chained_at_main_shape).  Each bucket
     batch of (f) and each tile of (g), in full, through B4/B5 and the
     plain versions.  In the state modes: at (a)'s batch the kernel at
     W = 12 and in float32 over the full strip against the int32 kernel,
     at W = 8 against the plain version on the first 4096 steps (the full
     run's, and a run of the cut in 8 slices); (d)'s chain at W = 12 and
     in float32 against the int32 chain (every tile's four strips in full:
     float32 equal, W = 12 equal plus the bias, since no (d) score nears
     2^11), and each W = 12 tile against the plain version on its first
     4096 steps; every mode timed beside int32.  The 16-bit states (two
     streams a thread): B1 at (a) at rows 8 and 4 and at (c), the slices
     from the batch's longest read, int16 and exact uint16 equal to int32
     in full, each state against the plain version ((a): its first 4096
     steps, full run's and in 8 slices; (c): in full); (d)'s and (e)'s
     chains at rows 8 in one launch (hold_chain, as the 32-bit chains),
     int16 and exact uint16 equal to the int32 chain; each timed beside
     int32 at the same rows (a chain also beside the per-tile chain) with
     its bound and share.  B4/B5 in float32 and int16 through
     sw_scores_column on every (f) bucket and (g)'s chain (launch counters
     set to 0 before each), equal to int32, timed beside it, and against
     the plain version at the largest bucket and on tile 0.  Then the top
     of swtpu's length ladders (phase "ladders", see phase_ladders): (q) a
     4,095-base query against 65,536 reads of 128 bases on the stream
     backend in int32 and float32 (a B3 chain of 32 tiles, one launch,
     a call) and on the column
     path (16 B5 tiles), (r) 16,384 reads of 513-2,048 bases (the 2,048
     bucket) on both, (s) score_pairs at score width 12 and exact on 1,024
     pairs of 2,049-4,095 x 513-2,048 bases (the stream backend's 16
     long-query jobs side by side on CUDA streams of their own: each job's
     chain from its CUDA events, the call's device span, the overlap and
     the streams), (t) load_database for 4,096 bases on
     (q)'s reads, and the CLI's score on (q)'s query: every score equal
     across backends and entry points, oracle samples, and B3 (the chain
     kernel at (q) and (s)'s longest job, three of (q)'s per-tile tiles),
     B4, B1 and every B5 tile against the plain versions;
  6. the shootout (experiments/torch_shootout.py's own functions) on
     65,536 pairs of 128 x 128: B4, B6 and the wavefront timed at both of
     its sizes, B4 == B6 on every pair and the wavefront == B4 on
     (q[0], t[i]) for every i; then B6 against its plain version on all
     65,536 pairs, the wavefront's strip at 512 streams (B2, rows 1)
     against its plain version, and E2's full int32 strip against the
     wavefront kernel at rows 1 on 512 streams x 4,096 steps;
  7. the microbenchmarks: E1's and E2's timing tables
     (experiments/torch_microbench_ops.py, torch_kernel_ablate.py at 512
     streams in each of the four dtypes) at those scripts' step counts.
Each phase's wall is printed on a line of its own ("phase seconds: ...").
The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches on its path, error, times and bound (the
wavefront and the chained tile also with their slices and registers, and
each state mode's time, bound, slices and registers at the main shape,
the 16-bit ones (B1 at (a) rows 8 and 4 and (c), B3's chains at (d) and
(e), rows 8) with their share of the bound, registers and spill bytes
and the streams a thread holds; the column states with their share and
registers).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOLERANCE = 0  # integer strips and scores: bit-equal
CHECK_STEPS = 4096  # steps of each long-case tile held against the plain version
CUT_SLICES = 8  # slices of the CHECK_STEPS cut's own run: 7 boundaries inside it
# main-path cases whose B1 strip phase 5 holds against the plain version
# on its first CHECK_STEPS steps, not in full: (a)'s plain strip alone took
# 163-200 s of the script's 1,200
CUT_MAIN = ("a_equal128_q128",)
STRIPS = ("acc", "oD", "oG", "oH")  # a chained tile's outputs


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# integer or float operations a cell (or element) of each recurrence, for
# the operations term of each kernel's bound.  An int32 add followed by a
# max counts once: Hopper's DPX instruction VIADDMNMX does both, and ptxas
# emits it for these kernels (their SASS holds 32-104 of them).
WAVEFRONT_OPS = 8  # s: compare + select; max(diag + s, 0); I: max, + extend; H: max; D: max; G: max(M + open, I)
# The column's count keeps A = I - (open + extend) in place of I, as B4's
# kernel does (column.cu), which folds I's + extend into the diagonal's
# add-max: diag: add-max; s: compare + select; max(diag + s, 0); I: max
# and two add-maxes; H: max (9 with I itself: the diagonal a max, I's
# + extend an add of its own)
COLUMN_OPS = 8
# The integer types fuse an add and the max after it (DPX: VIADDMNMX for
# int32, its packed 16x2 form for int16); the float types do not, so their
# counts hold both (bfloat16's max(diag + s, 0) shares its add's
# instruction all the same: its lanes count that, see lanes_of).
FUSED_ADD_MAX = ("int32", "int16")
# the wavefront's state modes beside exact int32: (label, score width,
# state dtype); the operations a cell they add to WAVEFRONT_OPS, counted
# from stream_wavefront.cu: the biased M update is an add, an and and a
# max (max(x & mask, zbit), the wrap and its sign-bit clamp) where the
# exact one is one fused add-max (2 more); float32 unfuses M's and G's
# add-max (2 more), on the fp32 lanes
STATE_MODES = (("biased W=8", 8, "int32"), ("biased W=12", 12, "int32"),
               ("biased W=16", 16, "int32"), ("float32", None, "float32"))
MODE_EXTRA_OPS = {"int32": 2, "float32": 2}  # biased int32; float32
MAIN_MODES = (("biased W=12", 12, "int32"), ("float32", None, "float32"))
MODE_DTYPES = {label: dtype for label, _, dtype in STATE_MODES}
# the wavefront's 16-bit states: (label, state dtype, penalties).  uint16
# cannot hold a negative open or extend penalty (swtpu's OverflowError), so
# it runs at mismatch 0 (exact) and at -4, which wraps every mismatch to
# 65,532.  Their work a cell beside WAVEFRONT_OPS: none more for the
# integer ones (a 16-bit add wraps by itself, and the packed 16x2 DPX
# add-max fuses as int32's does); bfloat16 unfuses M's and G's add-max (2
# more), as float32 does
SIXTEEN_BIT = (("int16", "int16", (5, -4, -12, -4)), ("uint16", "uint16", (5, 0, 0, 0)),
               ("uint16 wrap", "uint16", (5, -4, 0, 0)),
               ("bfloat16", "bfloat16", (5, -4, -12, -4)))
SIXTEEN_EXTRA_OPS = {"int16": 0, "uint16": 0, "bfloat16": 2}
MODE_DTYPES_16 = {label: dtype for label, dtype, _ in SIXTEEN_BIT}
SIXTEEN_ROWS = 8  # the 16-bit states' main-shape rows: swtpu refuses rows 16 with them
# (segments, rows, tail accumulator, physical streams) of their checks at
# phase 3's shapes.  A thread holds two streams in a 16-bit state, so an odd
# count leaves the last pair a dead high half (511)
SIXTEEN_CHECKS = ((1, 8, True, 512), (2, 8, True, 512), (4, 4, True, 512),
                  (1, 1, True, 512), (1, 1, False, 512), (4, 1, False, 512),
                  (1, 8, True, 511), (1, 1, False, 511), (2, 2, True, 511))
SIXTEEN_CHAIN_STREAMS = (512, 511)  # the K = 2 chains' physical streams
# E1 per element and op (fused, not fused; select is a compare and a
# predicated add); the step's floor modulo adds 3 per element
E1_OPS = {"addmax": (1, 2), "select": (2, 2), "roll_lane": (1, 2), "roll_sub": (1, 2)}
E1_MOD_OPS = 3
E1_SMS = {"int32": 4, "int16": 2, "float32": 4, "bfloat16": 2}  # SMs its cluster holds
# E2 per cell and step, fused: WAVEFRONT_OPS, the char's flag and code (2),
# and in full and norolls the read-start selects of the diagonal and of G
# (2); unfused, M's and G's add-max take 2 more (minimal's one add-max, 1)
E2_OPS = {"full": 12, "norolls": 12, "nosel": 10, "arith": 10, "minimal": 1}
# rows of E2's step that the strip depends on: in norolls and minimal no
# value moves between rows, so only row 127, the one the strip reads, is
# live (in norolls it never even sees a char); elsewhere all 128
E2_LIVE_ROWS = {"norolls": 1, "minimal": 1}


def e1_ops(pattern, dtype):
    return E1_OPS[pattern][dtype not in FUSED_ADD_MAX]


def e2_ops(variant, dtype):
    """Operations of one step per stream."""
    extra = 0 if dtype in FUSED_ADD_MAX else (1 if variant == "minimal" else 2)
    return E2_LIVE_ROWS.get(variant, 128) * (E2_OPS[variant] + extra)


# the card's elementwise results per clock per SM of the integer types: 64
# int32 lanes; two 16-bit results per 32-bit lane, whatever layout a
# kernel chose
LANES_PER_SM = {"int32": 64, "int16": 128, "uint16": 128}
# The float types' lanes come from the pipe model of
# swtpu_torch.tools.fp32_rates (model_lanes): their adds on the FMA pipe
# (float32's FADD at 128 thread instructions an SM a clock, bfloat16's
# HADD2.BF16 and HFMA2.BF16 at 64), their max, compare and select on the
# ALU pipe (64), all through the dispatch (128), the slowest of the three
# setting the time; bfloat16 two results an instruction, its max(diag + s,
# 0) fused into the add's HFMA2.BF16.RELU.  `python -m
# swtpu_torch.tools.fp32_rates` measures those rates and a mix of each
# type's wavefront step on the card and fails if the model is under what
# the mix reached.  E1's adds: one an op of each pattern (its max, compare
# or select the other) and the 3 of its floor modulo (a multiply, a floor
# and a multiply-add); E2's: the wavefront step's three a cell and its
# max(diag + s, 0), minimal's one add and no such max
E2_ADDS = {"full": 3, "norolls": 3, "nosel": 3, "arith": 3, "minimal": 1}
E2_RELUS = {"full": 1, "norolls": 1, "nosel": 1, "arith": 1, "minimal": 0}


def lanes_of(dtype, ops, adds=0, relus=0):
    """Results an SM a clock of `ops` operations in `dtype`: an integer
    type's lanes; for the float types fp32_rates' model, `adds` of the
    operations float adds and `relus` of them maxes with 0 right after
    one."""
    if dtype in LANES_PER_SM:
        return LANES_PER_SM[dtype]
    from swtpu_torch.tools.fp32_rates import model_lanes

    return model_lanes(dtype, ops, adds, relus)


def cell_lanes(kind, dtype, ops):
    """lanes_of `ops` operations a cell of the wavefront or the column."""
    from swtpu_torch.tools.fp32_rates import CELLS

    return lanes_of(dtype, ops, *CELLS[kind][1:])


def e1_lanes(pattern, dtype):
    """lanes_of one E1 step of 8 ops and the modulo, an element."""
    return lanes_of(dtype, 8 * e1_ops(pattern, dtype) + E1_MOD_OPS, 8 + E1_MOD_OPS)


def e2_lanes(variant, dtype):
    """lanes_of one E2 step."""
    live = E2_LIVE_ROWS.get(variant, 128)
    return lanes_of(dtype, e2_ops(variant, dtype), live * E2_ADDS[variant],
                    live * E2_RELUS[variant])


class Peaks:
    """The card's peak rates for the bounds: SM count x lanes x max SM
    clock for operations, HBM_BYTES_PER_S for bytes."""

    def __init__(self, sms: int, clock_hz: float):
        self.sms = sms
        self.clock_hz = clock_hz

    def bound(self, nbytes: float, ops: float, lanes: int = 64, sms: int | None = None):
        """(least ms for the work, what bounds it): the larger of the bytes
        over the memory rate and the operations over the lanes' peak, on
        every SM or on `sms` of them."""
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / ((sms or self.sms) * lanes * self.clock_hz)
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def live_children(plain=False) -> list[str]:
    """The command lines of this process's children that are still
    running (Linux /proc; none where /proc is missing); PlainJobs'
    workers, which run beside the card's work from phase to phase and end
    before the script does, only with `plain`."""
    pids = set()
    for f in Path("/proc/self/task").glob("*/children"):
        pids.update(f.read_text().split())
    live = []
    for pid in sorted(pids):
        try:
            state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:
            continue
        if state == "Z":  # exited, not yet reaped
            continue
        if not plain and PLAIN_MARK in cmd:
            continue
        live.append(f"{pid}: {cmd.decode(errors='replace').strip()[:200]}")
    return live


def strip_error(label, got, want, what=("kernel", "plain")) -> int:
    """Largest |kernel - plain| over a strip (or a score vector); fails
    above TOLERANCE.  `what` names the two sides."""
    err = int((got.long() - want.long()).abs().max())
    if err > TOLERANCE:
        bad = (got != want).nonzero()
        at = tuple(int(x) for x in bad[0])
        fail(f"{what[0]} vs {what[1]} {label}: {len(bad)} cells differ, first "
             f"{list(at)} {what[0]} {int(got[at])} {what[1]} {int(want[at])}")
    return err


def union_ms(intervals):
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


PLAIN_WORKER = """\
import sys, time
import torch
from swtpu_torch.ops import stream
torch.set_num_threads(1)
fn, args, kw = torch.load(sys.argv[1], weights_only=False)
t0 = time.perf_counter()
out = getattr(stream, fn)(*args, **kw)
torch.save((out, (time.perf_counter() - t0) * 1e3), sys.argv[2])
"""
PLAIN_MARK = b"fn, args, kw = torch.load(sys.argv[1]"  # in a worker's command line


class PlainCheck:
    """Kernel strips held against a plain version of swtpu_torch.ops.stream
    that runs meanwhile, or that runs when the result is asked for.
    `checks` are (label, k, got): the kernel's strip `got` must equal
    output k of the plain version (its only output: k 0).  `result()`
    holds them (strip_error) and returns (the largest error, the plain
    version's ms, where it ran: "card" or "cpu")."""

    def __init__(self, run, checks, where):
        self.run, self.checks, self.where = run, checks, where

    def result(self):
        try:
            want, ms = self.run()
        except Exception as e:  # a worker's fault is the check's
            fail(f"plain version for {self.checks[0][0]}: {e}")
        wants = want if isinstance(want, (tuple, list)) else (want,)
        err = 0
        for label, k, got in self.checks:
            err = max(err, strip_error(label, got, wants[k].to(got.device)))
        self.run = self.checks = None  # the inputs and strips go back to the card
        return err, ms, self.where


class PlainJobs:
    """The plain versions of the main-shape checks, which launch a few
    hundred small operations a step and so are bound by the host's
    launches on the card (16-21 s a B3 tile's first 4,096 steps at rows
    16 on an H100 host), run on the CPU in worker processes (one thread each) while the
    card's work goes on.  The plain version is the same PyTorch code on
    the same inputs, integer or exactly integer, so its strips are the
    card's.  `check(fn, args, checks, card=True)` runs it on the card
    instead, timed with CUDA events when its result is asked for (after
    the workers' jobs have started), where the kernels line reports its
    time.  The workers are plain subprocesses, at most
    `workers` at a time; `close()` (also at exit) kills any still
    running."""

    def __init__(self, workers=None):
        import atexit
        import os
        import tempfile
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self.workers = workers or max(1, min(6, (os.cpu_count() or 2) - 2))
        self.pool = ThreadPoolExecutor(self.workers)
        self.tmp = tempfile.TemporaryDirectory(prefix="plain_")
        self.procs, self.lock, self.n, self.closed = [], threading.Lock(), 0, False
        atexit.register(self.close)

    def _run(self, path):
        import sys

        import torch

        with self.lock:
            if self.closed:
                raise RuntimeError("the script is ending")
            proc = subprocess.Popen(
                [sys.executable, "-c", PLAIN_WORKER, path, path + ".out"], cwd=REPO,
                stderr=subprocess.PIPE, text=True)
            self.procs.append(proc)
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"worker exited {proc.returncode}: {err.strip()[-2000:]}")
        out, ms = torch.load(path + ".out", weights_only=False)
        return out, ms

    def check(self, fn, args, checks, card=False, **kw):
        """A PlainCheck of `checks` against swtpu_torch.ops.stream.`fn`(*args,
        **kw): on the CPU in a worker from now, or with `card` here on the
        card when its result is asked for."""
        import torch

        if card:
            from swtpu_torch.ops import stream
            from swtpu_torch.utils.timing import cuda_once

            return PlainCheck(lambda: cuda_once(lambda: getattr(stream, fn)(*args, **kw)),
                              checks, "card")
        self.n += 1
        path = str(Path(self.tmp.name) / f"plain_{self.n}.pt")
        torch.save((fn, [a.cpu() if torch.is_tensor(a) else a for a in args], kw), path)
        return PlainCheck(self.pool.submit(self._run, path).result, checks, "cpu")

    def close(self):
        with self.lock:
            self.closed = True
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        self.pool.shutdown(wait=True, cancel_futures=True)
        self.tmp.cleanup()


_PLAIN = []


def plain_jobs() -> PlainJobs:
    """The script's one PlainJobs, made at first use."""
    if not _PLAIN:
        _PLAIN.append(PlainJobs())
    return _PLAIN[0]


def laid_out_batch(query, db, segments, rows, phys):
    """A case's batch packed as ScoreBank packs it, on the card in the
    kernel layout, with the raw stream: the 2-bit wire turns pads into 0,
    which changes the strip past each stream's last read but no score."""
    import torch
    from swtpu_torch.bank.streams import pack_streams
    from swtpu_torch.ops.stream import _to_kernel_layout

    b = pack_streams(query, db.mat, n_streams=phys * segments,
                     segments=segments, lens=db.lens, rows=rows)
    return _to_kernel_layout(
        torch.from_numpy(b.q).cuda(), torch.from_numpy(b.stream).cuda(),
        segments, rows,
    )


def long_batch(query, db, rows, phys):
    """A long case's batch packed as ScoreBank packs it, on the card: q
    [N, K*128] int8 and the raw stream in the kernel layout [T, N]."""
    import torch
    from swtpu_torch.bank.streams import pack_streams_long

    b = pack_streams_long(query, db.mat, n_streams=phys, rows=rows, lens=db.lens)
    return torch.from_numpy(b.q).cuda(), torch.from_numpy(b.stream.T.copy()).cuda()


def run_chain(q, sk, rows, tile, penalties=None, keep=None, **mode):
    """The long-query chain (``_long_strip``) at `penalties` (None: the
    default ones) in the state `mode` (score_width, state_dtype) with
    `tile` running each tile; returns its last accumulator strip and every
    tile's (inputs, outputs), or only those of the tile indices in `keep`;
    a tile's inputs are the positional arguments of `tile`, which runs in
    `mode`."""
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import _long_strip

    tiles = []
    seen = [0]

    def record(*args, **kw):
        outs = tile(*args, **kw)
        if keep is None or seen[0] in keep:
            tiles.append((args, outs))
        seen[0] += 1
        return outs

    return _long_strip(q, sk, penalties or DEFAULT_PENALTIES, rows, tile=record,
                       **mode), tiles


def held_steps(n, T, K, p, rows):
    """Steps on which tile p of a K-tile chain over T steps is held against
    the plain tile so that the chain is held on its first n steps: tile
    p + 1 reads tile p's row 127 up to SL - 1 steps ahead (SL = 128 /
    rows), so tile p is held on n + (K - 1 - p) x (SL - 1) steps, rounded
    up to whole STEP_CHUNKs (the kernels' length quantum), at most T."""
    from swtpu_torch.ops.stream import STEP_CHUNK

    m = n + (K - 1 - p) * (128 // rows - 1)
    return min(T, -(-m // STEP_CHUNK) * STEP_CHUNK)


def plain_tiles(label, tiles, n=None, streams=slice(None), **mode):
    """Every tile of a per-tile chain (run_chain's (inputs, outputs)) held
    against the plain tile on the same inputs, all four strips, on the CPU
    (PlainJobs), on the columns `streams` of the strips.  With `n`, tile p
    is held on its first held_steps(n, ...) steps (its inputs cut there; a
    tile is causal in t): tile 0's inputs are the plain chain's, and a tile
    equal to the plain tile on its inputs over those steps hands the next
    one the plain chain's over the steps that one is held on, so the chain
    equals the plain chain on its first n steps; without `n`, every tile in
    full.  Streams are independent columns, so the tiles go side by side in
    one plain call a worker (their inputs and the kernel's strips
    concatenated on the stream axis, each cut to the longest window of the
    call's tiles, its first's): a worker's start-up, not a step, is what a
    tile alone would cost.  A list of PlainChecks (resolve_plain)."""
    import torch

    jobs = plain_jobs()
    per = -(-len(tiles) // jobs.workers)
    checks = []
    for first in range(0, len(tiles), per):
        group = tiles[first : first + per]
        qk, sk, _, _, _, pen, r = group[0][0]
        T = sk.shape[0]
        m = T if n is None else held_steps(n, T, len(tiles), first, r)
        inputs = [torch.cat([a[i][:, streams] if i == 0 else a[i][:m, streams]
                             for a, _ in group], 1).contiguous() for i in range(5)]
        last = first + len(group) - 1
        checks.append(jobs.check(
            "stream_chained_reference", (*inputs, pen, r),
            [(f"{label} tiles {first}-{last} {nm} first {m} steps", k,
              torch.cat([outs[k][:m, streams] for _, outs in group], 1))
             for k, nm in enumerate(STRIPS)], **mode))
    return checks


def resolve_plain(checks):
    """(largest error, the plain tiles' ms summed, where they ran) of
    plain_tiles' checks."""
    out = [c.result() for c in checks]
    return max(e for e, _, _ in out), sum(ms for _, ms, _ in out), out[0][2]


def hold_chain(label, q, sk, rows, penalties=None, plain=True, streams=slice(None), **mode):
    """The chain kernel (``_long_strip``'s route on the card in every
    state mode: one launch of stream_chain_cuda for every tile) against the
    per-tile chain (run_chain with stream_chained_cuda: a launch a tile, the
    host's shifts) on the whole last accumulator strip, both on the card,
    and with `plain` against the plain chain on its first CHECK_STEPS steps
    on the columns `streams`: every tile of the per-tile chain against the
    plain tile (plain_tiles).  Without `plain` the caller holds the tiles
    itself.  Returns (the chain's strip, its largest error against the
    per-tile chain, the plain checks: resolve_plain)."""
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import _long_strip, stream_chain_cuda, stream_chained_cuda

    pen = penalties or DEFAULT_PENALTIES
    before = stream_chain_cuda.launches, stream_chained_cuda.launches
    chain = _long_strip(q, sk, pen, rows, **mode)
    launched = (stream_chain_cuda.launches - before[0],
                stream_chained_cuda.launches - before[1])
    if launched != (1, 0):
        fail(f"{label}: the chain launched (chain, tile) {launched} times, want (1, 0)")
    per_tile, tiles = run_chain(q, sk, rows, stream_chained_cuda, pen,
                                keep=None if plain else (), **mode)
    err = strip_error(f"{label} chain", chain, per_tile, ("chain kernel", "per-tile chain"))
    checks = plain_tiles(label, tiles, CHECK_STEPS, streams, **mode) if plain else []
    return chain, err, checks


def resident_chain(label, query, stream, rows):
    """hold_chain on a resident [T, N] stream (a loaded database's, or a
    shard's) for `query` of more than 128 bases, its register laid out as
    ScoreBank._dispatch_loaded lays it out: the query in every stream,
    sentinel-padded to its K tiles."""
    import torch
    from swtpu_torch.ops import Q_PAD

    K = -(-len(query) // 128)
    q = torch.full((stream.shape[1], K * 128), Q_PAD, dtype=torch.int8, device=stream.device)
    q[:, : len(query)] = torch.from_numpy(query).to(stream.device)
    _, err, checks = hold_chain(label, q, stream, rows)
    return err, checks


def chain_facts(rows, T, K, quiet=True, **mode):
    """The chain kernel's geometry at K tiles over [T, 512] (ring, lags,
    slices) and its instantiation's registers, spills, resident blocks and
    shared bytes a block: the one with the pad shortcut (`quiet`, the
    penalties' pads_stay_at_zero) or the one without."""
    import torch
    from swtpu_torch.ops.stream import _sm_count, chain_geometry, stream_chain_info

    dtype = mode.get("state_dtype", "int32")
    g = chain_geometry(512, rows, T, K, _sm_count(torch.device("cuda")), dtype)
    regs, local, blocks, shared = stream_chain_info(rows, mode.get("score_width"), dtype,
                                                    quiet)
    return dict(ring=g.ring, lag_chunks=g.lag_chunks, wrap_lag_chunks=g.wrap_lag_chunks,
                slices=g.slices, wrap=g.wrap, registers=regs, spill_bytes=local,
                resident_blocks_per_sm=blocks, shared_bytes=shared)


def make_db(rng, n, lo, hi):
    """EncodedDB of n random reads with lengths in [lo, hi], pad code 4."""
    import numpy as np
    from swtpu_torch.bank.scorebank import EncodedDB

    lens = rng.integers(lo, hi + 1, size=n, dtype=np.int32)
    mat = rng.integers(0, 4, size=(n, hi), dtype=np.int8)
    mat[np.arange(hi)[None, :] >= lens[:, None]] = 4
    return EncodedDB([f"db{i}" for i in range(n)], mat, lens)


def make_pairs(rng, n, lo, hi):
    """n random (query, target) pairs of lengths in [lo, hi]; every 64th
    pair identical (target is query)."""
    import numpy as np

    lens = rng.integers(lo, hi + 1, size=(2, n))
    lens[1, ::64] = lens[0, ::64]
    codes = rng.integers(0, 4, size=int(lens.sum()), dtype=np.int8)
    seqs = np.split(codes, np.cumsum(lens.ravel())[:-1])
    queries, targets = seqs[:n], seqs[n:]
    for i in range(0, n, 64):
        targets[i] = queries[i]
    return queries, targets


def with_copies(db, query, every):
    """`db` with every `every`-th read (from read 0) replaced by `query`
    itself, the matrix widened to hold it."""
    import numpy as np
    from swtpu_torch.bank.scorebank import EncodedDB

    n, w = db.mat.shape
    mat = np.full((n, max(w, len(query))), 4, np.int8)
    mat[:, :w] = db.mat
    lens = db.lens.copy()
    mat[::every] = 4
    mat[::every, : len(query)] = query
    lens[::every] = len(query)
    return EncodedDB(db.names, mat, lens)


def mode_penalties(width, qlen):
    """The penalties of a state-mode check: the default ones, except at a
    width over 8, where a match so large that a read equal to a query of
    `qlen` bases passes the ceiling (one tile's query cannot reach 2^11 at
    +5 a match)."""
    from swtpu_torch import DEFAULT_PENALTIES, Penalties

    if width is None or width <= 8:
        return DEFAULT_PENALTIES
    return Penalties(match=(1 << (width - 1)) // qlen + 3, mismatch=-4, gap_open=-12,
                     gap_extend=-4)


def query_pairs(rng, n_queries, per, qrange, trange, self_every=0, self_len=None):
    """Pairs over n_queries distinct random queries with lengths in qrange,
    `per` targets each with lengths in trange, in a random order; with
    `self_every`, every self_every-th target of a query is the query, or
    with `self_len` (lo, hi) a window of it of lo..hi bases at a random
    offset."""
    import numpy as np

    qs = [rng.integers(0, 4, size=k).astype(np.int8)
          for k in rng.integers(qrange[0], qrange[1] + 1, size=n_queries)]
    owner = rng.permutation(np.repeat(np.arange(n_queries), per))
    lens = rng.integers(trange[0], trange[1] + 1, size=len(owner))
    targets = [rng.integers(0, 4, size=k).astype(np.int8) for k in lens]
    if self_every:
        seen = np.zeros(n_queries, np.int64)
        for i, u in enumerate(owner):
            if seen[u] % self_every == 0:
                if self_len is None:
                    targets[i] = qs[u].copy()
                else:
                    k = int(rng.integers(self_len[0], self_len[1] + 1))
                    off = int(rng.integers(0, len(qs[u]) - k + 1))
                    targets[i] = qs[u][off : off + k].copy()
            seen[u] += 1
    return [qs[u] for u in owner], targets


def pair_oracle(queries, targets, idx):
    """The exact oracle's scores of the pairs at `idx`, in one batch."""
    import numpy as np
    from swtpu_torch.oracle import sw_score_batch

    m = max(len(queries[i]) for i in idx)
    n = max(len(targets[i]) for i in idx)
    q = np.zeros((len(idx), m), np.int8)
    t = np.zeros((len(idx), n), np.int8)
    for k, i in enumerate(idx):
        q[k, : len(queries[i])] = queries[i]
        t[k, : len(targets[i])] = targets[i]
    return sw_score_batch(q, t, [len(queries[i]) for i in idx], [len(targets[i]) for i in idx])


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    if not (REPO / "swtpu_torch").is_dir():
        fail(f"no swtpu_torch package beside {Path(__file__).name}: run it "
             "from a checkout of the repository")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = subprocess.run(
        [str(Path(CUDA_HOME or "") / "bin" / "nvcc"), "--version"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"phase device: ok {torch.cuda.get_device_name(0)} | {sms} SMs, max SM "
          f"clock {clock} MHz | torch {torch.__version__} CUDA {torch.version.cuda} "
          f"| nvcc {nvcc[-1] if nvcc else 'not found'}")
    return card, Peaks(sms, float(clock) * 1e6)


def phase_build():
    from swtpu_torch.ops._build import build_log_path, library_path, load_library
    from swtpu_torch.runtime import native

    t0 = time.perf_counter()
    load_library()
    dt = time.perf_counter() - t0
    if not native.native_available():
        fail("the native host packer did not load (g++ missing or failed): host "
             "stages would run the numpy fallback")
    print(f"phase build: ok {dt:.2f} s -> {library_path().name}; host packer: "
          f"native ({native.library_path().name})")
    kernel = "?"
    for line in build_log_path().read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {kernel}: {line.strip()}")


def phase_kernel_vs_plain(rng):
    """Strips of kernel and plain version on the same packed inputs."""
    import numpy as np
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import stream_strip_cuda, stream_strip_reference
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    results = []
    for seg, rows in ((1, 16), (2, 8), (4, 4), (1, 1)):
        S = 512
        db = make_db(rng, S * seg * 10, 24, 256)  # T ~ 1.4k steps
        query = rng.integers(0, 4, size=128 // seg).astype(np.int8)
        qk, sk = laid_out_batch(query, db, seg, rows, S)
        got = stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows)
        want, plain_ms = cuda_once(
            lambda: stream_strip_reference(qk, sk, DEFAULT_PENALTIES, seg, rows)
        )
        err = strip_error(f"seg={seg} rows={rows}", got, want)
        ms = cuda_ms(lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows), 10)
        T, N = sk.shape
        print(f"phase kernel_vs_plain: ok seg={seg} rows={rows} strip [{T}, {N}] "
              f"bit-equal | kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
        results.append(dict(segments=seg, rows=rows, T=T, N=N, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms))
    return results


def phase_ripple_vs_plain(rng):
    """The wavefront's ripple-H form (rows 1) against its plain version."""
    import numpy as np
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import stream_strip_cuda, stream_strip_reference
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    results = []
    for seg in (1, 4):
        S = 512
        db = make_db(rng, S * seg * 10, 24, 256)
        query = rng.integers(0, 4, size=128 // seg).astype(np.int8)
        qk, sk = laid_out_batch(query, db, seg, 1, S)
        args = (qk, sk, DEFAULT_PENALTIES, seg, 1, False)
        got = stream_strip_cuda(*args)
        want, plain_ms = cuda_once(lambda: stream_strip_reference(*args))
        err = strip_error(f"ripple-H seg={seg}", got, want)
        ms = cuda_ms(lambda: stream_strip_cuda(*args), 10)
        T, N = sk.shape
        print(f"phase kernel_vs_plain: ok ripple-H seg={seg} rows=1 strip [{T}, {N}] "
              f"bit-equal | kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
        results.append(dict(form="ripple-H", segments=seg, rows=1, T=T, N=N,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms))
    return results


CHAIN_CHECKS = ((2, 16), (2, 1), (4, 16))  # (tiles K, rows)


def phase_chained_vs_plain(rng):
    """Whole K-tile chains through the chained kernel a tile at a time,
    every tile's four strips against the plain tile on the same inputs
    (plain_tiles: the plain chain, tile by tile, on CPU workers side by
    side), and through the chain kernel (one launch for every tile),
    whose last strip must equal the per-tile chain's."""
    import numpy as np
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import RING_WARPS, _long_strip, stream_chained_cuda
    from swtpu_torch.utils.timing import cuda_ms

    results, pending = [], []
    for K, rows in CHAIN_CHECKS:
        S = 512
        db = make_db(rng, S * 10, 24, 256)  # T ~ 1.5k steps
        query = rng.integers(0, 4, size=128 * K).astype(np.int8)
        q, sk = long_batch(query, db, rows, S)
        acc, tiles = run_chain(q, sk, rows, stream_chained_cuda)
        label = f"chain K={K} rows={rows}"
        checks = plain_tiles(label, tiles)
        chain = _long_strip(q, sk, DEFAULT_PENALTIES, rows)
        err = strip_error(f"{label} chain kernel", chain, acc, ("chain kernel", "tiles"))
        ring = min(K, RING_WARPS)
        del chain
        ms = cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows), 5)
        tiles_ms = cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows,
                                               tile=stream_chained_cuda), 5)
        tile_ms = cuda_ms(lambda: stream_chained_cuda(*tiles[0][0]), 10)
        T, N = sk.shape
        del tiles
        pending.append((label, K, rows, T, N, err, ms, tiles_ms, tile_ms, ring, checks))
    for label, K, rows, T, N, err, ms, tiles_ms, tile_ms, ring, checks in pending:
        e, plain_ms, where = resolve_plain(checks)
        err = max(err, e)
        print(f"phase kernel_vs_plain: ok {label} strips [{T}, {N}] bit-equal (4 per "
              f"tile, the plain chain tile by tile; the chain kernel's last acc = the "
              f"per-tile chain's, ring {ring}) | chain kernel {ms:.4f} ms, a launch "
              f"a tile {tiles_ms:.4f} ms (kernel {tile_ms:.4f} ms per tile), plain chain "
              f"{plain_ms:.1f} ms (its tiles summed, on the {where})")
        results.append(dict(tiles=K, rows=rows, T=T, N=N, max_abs_err=err,
                            ms=ms, per_tile_chain_ms=tiles_ms, tile_ms=tile_ms,
                            plain_ms=plain_ms, plain_on=where))
    return results


# (segments, rows, tail accumulator) of the state-mode checks: ScoreBank's
# CUDA geometries, and rows 1 in both forms
MODE_CHECKS = ((1, 16, True), (2, 8, True), (4, 4, True), (1, 1, True), (1, 1, False),
               (4, 1, False))
COPY_EVERY = 97  # reads of a state-mode check that are the query itself
MODE_STREAMS = 512  # physical streams of the state-mode checks


def phase_modes_vs_plain(rng):
    """The wavefront in each state mode against its plain version, bit for
    bit, at 512 physical streams, on reads of which every COPY_EVERY-th is
    the query, so that each biased width wraps (mode_penalties); the
    biased strip must differ from the exact one there, and the float32
    strip must equal the int32 kernel's everywhere."""
    import numpy as np
    from swtpu_torch.ops.stream import stream_strip_cuda, stream_strip_reference
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    results = []
    for seg, rows, tail_acc in MODE_CHECKS:
        S = MODE_STREAMS
        query = rng.integers(0, 4, size=128 // seg).astype(np.int8)
        db = with_copies(make_db(rng, S * seg * 4, 24, 256), query, COPY_EVERY)
        qk, sk = laid_out_batch(query, db, seg, rows, S)
        form = "tail-acc" if tail_acc else "ripple-H"
        for label, width, dtype in STATE_MODES:
            pen = mode_penalties(width, len(query))
            mode = dict(score_width=width, state_dtype=dtype)
            args = (qk, sk, pen, seg, rows, tail_acc)
            got = stream_strip_cuda(*args, **mode)
            want, plain_ms = cuda_once(lambda: stream_strip_reference(*args, **mode))
            name = f"{label} {form} seg={seg} rows={rows}"
            err = strip_error(name, got, want)
            exact = stream_strip_cuda(*args)
            wrapped = int((got != exact).sum())
            if dtype == "float32":
                err = max(err, strip_error(name, got, exact, ("float32", "int32")))
            elif wrapped == 0:
                fail(f"{name}: no strip cell wrapped")
            ms = cuda_ms(lambda: stream_strip_cuda(*args, **mode), 10)
            int32_ms = cuda_ms(lambda: stream_strip_cuda(*args), 10)
            T, N = sk.shape
            print(f"phase kernel_vs_plain: ok {name} strip [{T}, {N}] bit-equal"
                  f"{'' if dtype == 'float32' else f', {wrapped} cells wrapped'}"
                  f"{' (= the int32 strip)' if dtype == 'float32' else ''} | kernel "
                  f"{ms:.4f} ms (int32 {int32_ms:.4f}), plain {plain_ms:.1f} ms")
            results.append(dict(mode=label, form=form, segments=seg, rows=rows, T=T, N=N,
                                match=pen.match, wrapped_cells=wrapped, max_abs_err=err,
                                ms=ms, int32_ms=int32_ms, plain_ms=plain_ms))
    return results


CHAIN_MODE_CHECKS = (2, 4)  # tiles K at rows 16; K = 4 (512 bases) wraps at W = 12


def phase_chain_modes_vs_plain(rng):
    """Whole chains in the state modes through the kernel a tile at a time,
    every tile's four strips against the plain tile on the same inputs
    (plain_tiles: the plain chain, tile by tile, on CPU workers side by
    side); at K = 4 the reads equal to the 512-base query pass 2^11 and
    wrap.  The chain kernel's last accumulator must equal the per-tile
    chain's."""
    import numpy as np
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.stream import _long_strip, stream_chained_cuda
    from swtpu_torch.utils.timing import cuda_ms

    results, pending = [], []
    rows = 16
    for K in CHAIN_MODE_CHECKS:
        S = MODE_STREAMS
        query = rng.integers(0, 4, size=128 * K).astype(np.int8)
        db = with_copies(make_db(rng, S * 4, 24, 256), query, COPY_EVERY)
        q, sk = long_batch(query, db, rows, S)
        exact, _ = run_chain(q, sk, rows, stream_chained_cuda, keep=())
        for label, width, dtype in MAIN_MODES:
            mode = dict(score_width=width, state_dtype=dtype)
            acc, tiles = run_chain(q, sk, rows, stream_chained_cuda, **mode)
            name = f"{label} chain K={K} rows={rows}"
            checks = plain_tiles(name, tiles, **mode)
            del tiles
            chain = _long_strip(q, sk, DEFAULT_PENALTIES, rows, **mode)
            err = strip_error(f"{name} chain kernel", chain, acc, ("chain", "tiles"))
            del chain
            bias = 0 if width is None else 1 << (width - 1)
            wrapped = int((acc - bias != exact).sum())
            if dtype == "float32":
                err = max(err, strip_error(name, acc, exact, ("float32", "int32")))
            elif K == 4 and wrapped == 0:
                fail(f"{name}: no cell of the last accumulator strip wrapped")
            ms = cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows, **mode), 5)
            T, N = sk.shape
            pending.append((label, K, name, T, N, wrapped, err, ms, checks))
    for label, K, name, T, N, wrapped, err, ms, checks in pending:
        e, plain_ms, where = resolve_plain(checks)
        err = max(err, e)
        print(f"phase kernel_vs_plain: ok {name} strips [{T}, {N}] bit-equal (4 per tile, "
              f"the plain chain tile by tile; the chain kernel's last acc = the per-tile "
              f"chain's){f', {wrapped} cells wrapped' if wrapped else ''} | chain kernel "
              f"{ms:.4f} ms, plain chain {plain_ms:.1f} ms (its tiles summed, on the "
              f"{where})")
        results.append(dict(mode=label, tiles=K, rows=rows, T=T, N=N,
                            wrapped_cells=wrapped, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, plain_on=where))
    return results


MAIN_CASES = (
    # (name, reads, read length range, query length): segments/rows follow
    ("a_equal128_q128", 262144, (128, 128), 128),  # seg 1, rows 16, regular
    ("b_ragged_q32", 262144, (24, 256), 32),  # seg 4, rows 4, scatter
    ("c_ragged_q64", 65536, (24, 256), 64),  # seg 2, rows 8
)
LONG_CASES = (
    # chained tiles: segments 1, rows 16, 512 physical streams, K = qlen/128
    ("d_ragged_q256", 262144, (24, 256), 256),  # the reference AFU's 256-PE query
    ("e_equal128_q512", 65536, (128, 128), 512),  # swtpu's long-query shape
)


def timed_runs(name, run):
    """One warm call and three timed ones of `run`, which must give the
    same scores each time; (result, median wall s, the walls, peak GB)."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    res = run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = run()
        walls.append(time.perf_counter() - t0)
        if not np.array_equal(again.scores, res.scores):
            fail(f"{name}: scores differ between runs")
    return res, statistics.median(walls), walls, torch.cuda.max_memory_allocated() / 1e9


def first_difference(name, got, want, what, at=None):
    """Fails at the first index where two score vectors differ, named as
    its entry of `at` where given."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        fail(f"{name}: {got.shape} scores against {what}'s {want.shape}")
    if not np.array_equal(got, want):
        k = int(np.flatnonzero(got != want)[0])
        fail(f"{name} {k if at is None else at[k]} scored {got[k]}, {what} {want[k]}")


def check_oracle(name, res, query, db, sample, want):
    """The sampled reads' scores must be `want` (the oracle's), and the
    top-10 reads must carry the oracle's scores."""
    from swtpu_torch import score_many_vs_one

    first_difference(f"{name}: read", res.scores[sample], want, "oracle", at=sample)
    top = res.top_k(10)
    top_want = score_many_vs_one(query, [db.read(i) for _, i in top])
    if [s for s, _ in top] != top_want.tolist():
        fail(f"{name}: top-10 {top} vs oracle {top_want.tolist()}")


def phase_main_path(rng, card, main_cases):
    import numpy as np
    from swtpu_torch import SWConfig, ScoreBank, score_many_vs_one
    from swtpu_torch.ops.stream import stream_chain_cuda, stream_strip_cuda

    bank = ScoreBank(SWConfig(), device="cuda")
    cases = []
    for name, n, (lo, hi), qlen in main_cases:
        db = make_db(rng, n, lo, hi)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        K = -(-qlen // 128)
        wrapper = stream_chain_cuda if K > 1 else stream_strip_cuda
        before = wrapper.launches
        res, wall, walls, peak_gb = timed_runs(name, lambda: bank.score_database(query, db))
        launched = wrapper.launches - before
        if K > 1 and launched != 4:
            fail(f"{name}: the chain kernel launched {launched} times in 4 runs "
                 f"of one chain of {K} tiles")
        if launched < 4:
            fail(f"{name}: wavefront kernel launched {launched} times in 4 runs")
        if res.scores.shape != (n,) or res.scores.dtype != np.int32:
            fail(f"{name}: scores {res.scores.shape} {res.scores.dtype}")
        sample = np.sort(rng.choice(n, size=2048, replace=False))
        want = score_many_vs_one(query, [db.read(i) for i in sample])
        check_oracle(name, res, query, db, sample, want)
        gcups = res.cells / wall / 1e9
        print(f"phase main_path: ok {name} reads={n} query={qlen} tiles={K} "
              f"cells={res.cells} padded={res.padded_cells} launches={launched} "
              f"peak device memory {peak_gb:.2f} GB | sample 2048 + "
              f"top-10 = oracle | wall median of 3 {wall*1e3:.2f} ms "
              f"(runs {', '.join(f'{w*1e3:.2f}' for w in walls)}) -> "
              f"{gcups:.2f} GCUPS on {card}", flush=True)
        cases.append(dict(name=name, query=query, db=db, wall_s=wall,
                          gcups=gcups, cells=res.cells, scores=res.scores,
                          sample=sample, oracle=want))
    return bank, cases


# pairs on the wavefront: (name, distinct queries, targets each, query
# lengths, target lengths, a query's own read every so many targets)
I_CASE = ("i_pairs_stream", 4096, 16, (24, 128), (24, 512), 0)
J_SHORT = ("j_pairs_stream_w12_mixed", 2048, 8, (24, 128), (24, 512), 0)
J_LONG = (16, 64, (410, 512), (24, 512), 8)  # 4 chained tiles each; 1 in 8 wraps
J_WIDTH = 12
PAIR_ORACLE = 2048  # pairs of (i) held against the exact oracle
J_SAMPLE = (64, 16)  # pairs of (j) held against the biased oracle: random, wrapping


def launches_of(run, column=False):
    """run() with the stream kernels' launch counters set to 0 just before
    it; (its result, (wavefront launches, chained launches)) read just
    after; with `column`, the column kernels' too: (B1, B3, B4, B5).  B3's
    launches are those of a whole chain (stream_chain_cuda, the main path's
    in every state) and of a single tile (stream_chained_cuda)."""
    from swtpu_torch.ops.column import column_chained_cuda, column_scores_cuda
    from swtpu_torch.ops.stream import stream_chain_cuda, stream_chained_cuda, stream_strip_cuda

    kernels = [(stream_strip_cuda,), (stream_chain_cuda, stream_chained_cuda)]
    if column:
        kernels += [(column_scores_cuda,), (column_chained_cuda,)]
    for wrappers in kernels:
        for w in wrappers:
            w.launches = 0
    out = run()
    return out, tuple(sum(w.launches for w in wrappers) for wrappers in kernels)


def phase_pairs_path(rng, card):
    """(i) and (j): score_pairs on the stream backend, through the user's
    entry points, timed as the other cases are; every score against the
    column path's, samples against the oracles."""
    import numpy as np
    from swtpu_torch import SWConfig, ScoreBank
    from swtpu_torch.bank.scorebank import stream_geometry

    out = []
    # (i): the default backend, which is now the stream's
    name, nq, per, qr, tr, _ = I_CASE
    queries, targets = query_pairs(rng, nq, per, qr, tr)
    bank = ScoreBank(device="cuda")
    if bank.backend != "stream":
        fail(f"{name}: the default backend is {bank.backend!r}, not the stream")
    (res, wall, walls, peak), (b1, b3) = launches_of(
        lambda: timed_runs(name, lambda: bank.score_pairs(queries, targets)))
    want_calls = -(-nq // stream_geometry(max(qr), bank.config, bank.device)[2])
    if b1 != 4 * want_calls or b3:
        fail(f"{name}: (wavefront, chained) launched ({b1}, {b3}) times in 4 calls, want "
             f"({4 * want_calls}, 0)")
    cbank = ScoreBank(backend="pallas", device="cuda")
    col, col_wall, _, _ = timed_runs(name, lambda: cbank.score_pairs(queries, targets))
    if not np.array_equal(res.scores, col.scores):
        k = int(np.flatnonzero(res.scores != col.scores)[0])
        fail(f"{name}: pair {k} scored {res.scores[k]}, the column path {col.scores[k]}")
    idx = np.sort(rng.choice(len(queries), size=PAIR_ORACLE, replace=False))
    t0 = time.perf_counter()
    want = pair_oracle(queries, targets, idx)
    oracle_s = time.perf_counter() - t0
    if not np.array_equal(res.scores[idx], want):
        k = int(np.flatnonzero(res.scores[idx] != want)[0])
        fail(f"{name}: pair {idx[k]} scored {res.scores[idx[k]]}, oracle {want[k]}")
    gcups = res.cells / wall / 1e9
    print(f"phase main_path: ok {name} pairs={len(queries)} distinct queries={nq} "
          f"cells={res.cells} padded={res.padded_cells} launches wavefront={b1} "
          f"peak device memory {peak:.2f} GB | all = the column path, {PAIR_ORACLE} sampled "
          f"= oracle ({oracle_s:.1f} s) | wall median of 3 {wall*1e3:.2f} ms (runs "
          f"{', '.join(f'{w*1e3:.2f}' for w in walls)}), the column path {col_wall*1e3:.2f} "
          f"ms -> {gcups:.2f} GCUPS on {card}", flush=True)
    out.append(dict(name=name, pairs=len(queries), cells=res.cells,
                    padded_cells=res.padded_cells, wall_s=wall, gcups=gcups,
                    launches=[b1, b3], column_wall_s=col_wall, peak_gb=peak))

    # (j): score_width 12 on the stream backend, short and long queries
    name, nq, per, qr, tr, _ = J_SHORT
    queries, targets = query_pairs(rng, nq, per, qr, tr)
    n_long, per_long, qr_long, tr_long, self_every = J_LONG
    longs, ltargets = query_pairs(rng, n_long, per_long, qr_long, tr_long, self_every)
    queries, targets = queries + longs, targets + ltargets
    wbank = ScoreBank(SWConfig(score_width=J_WIDTH), backend="stream", device="cuda")
    (res, wall, walls, peak), (b1, b3) = launches_of(
        lambda: timed_runs(name, lambda: wbank.score_pairs(queries, targets)))
    want_calls = -(-nq // stream_geometry(max(qr), wbank.config, wbank.device)[2])
    if b1 < 4 * want_calls or b3 != 4 * n_long:  # a chain of 4 tiles a long query
        fail(f"{name}: (wavefront, chained) launched ({b1}, {b3}) times in 4 calls, want "
             f"(>= {4 * want_calls}, {4 * n_long})")
    cbank = ScoreBank(SWConfig(score_width=J_WIDTH), device="cuda")
    col, col_wall, _, _ = timed_runs(name, lambda: cbank.score_pairs(queries, targets))
    if not np.array_equal(res.scores, col.scores):
        k = int(np.flatnonzero(res.scores != col.scores)[0])
        fail(f"{name}: pair {k} scored {res.scores[k]}, the column path {col.scores[k]}")
    first_long = len(queries) - len(longs)
    wrapping = {}
    for i in range(first_long, len(queries)):
        if np.array_equal(queries[i], targets[i]):
            wrapping.setdefault(queries[i].tobytes(), i)
    n_random, n_wrap = J_SAMPLE
    if len(wrapping) != n_wrap:
        fail(f"{name}: {len(wrapping)} long queries have their own read, want {n_wrap}")
    picked = np.concatenate([rng.choice(len(queries), size=n_random, replace=False),
                             sorted(wrapping.values())])
    t0 = time.perf_counter()
    want = biased_oracle([(queries[i], targets[i]) for i in picked], J_WIDTH)
    oracle_s = time.perf_counter() - t0
    if res.scores[picked].tolist() != want:
        k = int(np.flatnonzero(res.scores[picked] != np.asarray(want))[0])
        fail(f"{name}: pair {picked[k]} scored {res.scores[picked[k]]}, biased oracle "
             f"{want[k]}")
    wrapped = sum(int(res.scores[i]) < 5 * len(queries[i]) for i in picked[n_random:])
    if wrapped != n_wrap:
        fail(f"{name}: only {wrapped} of {n_wrap} pairs past the {J_WIDTH}-bit ceiling wrapped")
    gcups = res.cells / wall / 1e9
    print(f"phase main_path: ok {name} pairs={len(queries)} ({len(queries) - len(longs)} "
          f"over {nq} short queries, {len(longs)} over {n_long} of {qr_long[0]}-{qr_long[1]} "
          f"bases) score_width={J_WIDTH} cells={res.cells} padded={res.padded_cells} "
          f"launches wavefront={b1} chained={b3} peak device memory {peak:.2f} GB | all = "
          f"the column path at width {J_WIDTH}, {n_random} sampled + {n_wrap} wrapping pairs "
          f"= sw_score_single_biased ({oracle_s:.1f} s), all {n_wrap} wrapped | wall median "
          f"of 3 {wall*1e3:.2f} ms (runs {', '.join(f'{w*1e3:.2f}' for w in walls)}), the "
          f"column path {col_wall*1e3:.2f} ms -> {gcups:.2f} GCUPS on {card}", flush=True)
    out.append(dict(name=name, pairs=len(queries), cells=res.cells,
                    padded_cells=res.padded_cells, wall_s=wall, gcups=gcups,
                    launches=[b1, b3], column_wall_s=col_wall, peak_gb=peak))
    return out


def phase_mode_databases(card, cases, long_cases):
    """score_database in the new modes on the main cases' data: (e) at
    width 12 on the stream backend, equal to (e)'s exact scores (none
    reaches 2^11); (a) and (d) with float32 state, equal to their int32
    scores."""
    import numpy as np
    from swtpu_torch import SWConfig, ScoreBank

    case_a, case_d, case_e = cases[0], long_cases[0], long_cases[1]
    runs = (
        ("e_w12_stream", case_e, SWConfig(score_width=J_WIDTH), (0, 4)),
        ("a_float32", case_a, SWConfig(stream_state_dtype="float32"), (4, 0)),
        ("d_float32", case_d, SWConfig(stream_state_dtype="float32"), (0, 4)),
    )
    if int(case_e["scores"].max()) >= 1 << (J_WIDTH - 1):
        fail(f"case (e) scores reach 2^{J_WIDTH - 1}: width {J_WIDTH} would wrap them")
    out = []
    for name, c, cfg, want_launches in runs:
        bank = ScoreBank(cfg, backend="stream", device="cuda")
        (res, wall, walls, peak), launched = launches_of(
            lambda: timed_runs(name, lambda: bank.score_database(c["query"], c["db"])))
        if launched != want_launches:
            fail(f"{name}: (wavefront, chained) launched {launched} times in 4 calls, want "
                 f"{want_launches}")
        if not np.array_equal(res.scores, c["scores"]):
            k = int(np.flatnonzero(res.scores != c["scores"])[0])
            fail(f"{name}: read {k} scored {res.scores[k]}, the exact int32 run "
                 f"{c['scores'][k]}")
        gcups = res.cells / wall / 1e9
        print(f"phase main_path: ok {name} reads={len(c['db'].lens)} launches "
              f"wavefront={launched[0]} chained={launched[1]} | all = {c['name']}'s exact "
              f"int32 scores | wall median of 3 {wall*1e3:.2f} ms (runs "
              f"{', '.join(f'{w*1e3:.2f}' for w in walls)}; int32 {c['wall_s']*1e3:.2f}) -> "
              f"{gcups:.2f} GCUPS on {card}", flush=True)
        out.append(dict(name=name, case=c["name"], cells=res.cells, wall_s=wall,
                        int32_wall_s=c["wall_s"], gcups=gcups, launches=list(launched),
                        peak_gb=peak))
    return out


def phase_kernel_at_main_shape(bank, cases):
    """Kernel vs plain version on each main-path case's own batch at the
    geometry ScoreBank chose for it, in the slices the wrapper chose: the
    full strip, but (a)'s (CUT_MAIN) on its first CHECK_STEPS steps only
    (the full run's, and a run of the cut in CUT_SLICES slices; a strip is
    causal in t), as the modes' and the tiles' checks are; the kernel's
    time in those slices and in one, and the plain version's: (a)'s on the
    card, the others' on the CPU beside the card's work (PlainJobs)."""
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.ops.stream import stream_strip_cuda, wavefront_geometry
    from swtpu_torch.utils.timing import cuda_ms

    plain = plain_jobs()
    results, checks = [], []
    for i, c in enumerate(cases):
        seg, rows, phys = stream_geometry(len(c["query"]), bank.config, bank.device)
        qk, sk = laid_out_batch(c["query"], c["db"], seg, rows, phys)
        # the slices the bank's call takes: from the batch's longest read
        longest = int(c["db"].lens.max())
        got = stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows, longest_read=longest)
        slices, steps = stream_strip_cuda.slices, stream_strip_cuda.slice_steps
        what = f"{c['name']} seg={seg} rows={rows} in {slices} slices"
        T, N = sk.shape
        n = CHECK_STEPS if c["name"] in CUT_MAIN else T
        cut = sk[:n].contiguous()
        held = [(what if n == T else f"{what}, first {n} steps", 0, got[:n].clone())]
        if n < T:
            held.append((f"{c['name']} first {n} steps in {CUT_SLICES} slices", 0,
                         stream_strip_cuda(qk, cut, DEFAULT_PENALTIES, seg, rows,
                                           slices=CUT_SLICES)))
        del got
        checks.append(plain.check("stream_strip_reference",
                                  (qk, cut, DEFAULT_PENALTIES, seg, rows), held, card=i == 0))
        # 10 calls: the first launch's host work, which the events count,
        # then weighs a tenth (the plain versions' CPU workers load the host)
        ms = cuda_ms(lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows,
                                               longest_read=longest), 10)
        ms_one = cuda_ms(
            lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows, slices=1), 3)
        g = wavefront_geometry(rows, seg)
        results.append(dict(name=c["name"], segments=seg, rows=rows, T=T, N=N,
                            lanes_a_stream=g.lanes, sublanes_a_thread=g.sublanes,
                            rows_a_thread=rows * g.sublanes, longest_read=longest,
                            slices=slices, slice_steps=steps, ms=ms, ms_one_slice=ms_one,
                            check_steps=n))
        del qk, sk, cut
    for c, r, check in zip(cases, results, checks):
        err, plain_ms, where = check.result()
        r.update(max_abs_err=err, plain_ms=plain_ms, plain_on=where)
        ms, n, T = r["ms"], r["check_steps"], r["T"]
        print(f"phase kernel_main_shape: ok {c['name']} seg={r['segments']} "
              f"rows={r['rows']} ({r['lanes_a_stream']} threads a stream, "
              f"{r['sublanes_a_thread']} sublanes a thread) strip [{T}, {r['N']}] in "
              f"{r['slices']} slices of up to {r['slice_steps']} steps (longest read "
              f"{r['longest_read']}), bit-equal on "
              f"{'all' if n == T else f'the first {n}'} steps | "
              f"kernel {ms:.3f} ms -> {c['cells'] / ms / 1e6:.2f} GCUPS in the kernel "
              f"({ms / (c['wall_s'] * 1e3):.1%} of the wall time), in one slice "
              f"{r['ms_one_slice']:.3f} ms, plain {plain_ms:.1f} ms on {n} steps "
              f"(on the {where})", flush=True)
    return results


def phase_chained_at_main_shape(bank, cases):
    """Each long case's batch, at the geometry ScoreBank chose for it,
    through the kernel chain at full length in the slices the wrapper
    chose (timed as the main path runs it).  Every tile's four strips must
    equal, in full, the same kernel's in one slice (timed too).  Then
    every tile against the plain version on its first held_steps steps
    (CHECK_STEPS for the last tile, SL - 1 more a tile above it) of every
    stream: both get the same inputs, the stream rows and the kernel's own
    shifted boundary strips, cut to those rows.  A tile is causal in t
    (step t reads only steps <= t of its inputs), so the first rows of its
    four output strips are exactly what the cut inputs give: the check is
    exact for those steps.  It holds the full run's first steps, and a run
    of the cut in CUT_SLICES slices, so that slice boundaries fall inside
    the steps held.  The plain version
    takes ~1.8 ms per step at rows 16, so the full length would take
    minutes per tile.  Every tile runs its plain version on the CPU beside
    the card's work (PlainJobs).  The main path's chain kernel (one
    launch for the K tiles, timed beside the chain of a launch a tile) is
    held against the per-tile chain in full (hold_chain), and so against
    the plain chain on the first CHECK_STEPS steps: every tile of the
    per-tile chain equals the plain tile on its held steps, which hand the
    next tile the plain chain's inputs on its own."""
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.ops.stream import _long_strip, stream_chained_cuda
    from swtpu_torch.utils.timing import cuda_ms

    n = CHECK_STEPS
    plain = plain_jobs()
    results = []
    for c in cases:
        _, rows, phys = stream_geometry(len(c["query"]), bank.config, bank.device)
        q, sk = long_batch(c["query"], c["db"], rows, phys)
        _, tiles = run_chain(q, sk, rows, stream_chained_cuda)
        slices, steps = stream_chained_cuda.slices, stream_chained_cuda.slice_steps
        _, err, _ = hold_chain(c["name"], q, sk, rows, plain=False)  # tiles held below
        chain_ms = cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows), 3)
        tiles_chain_ms = cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows,
                                                     tile=stream_chained_cuda), 3)
        facts = chain_facts(rows, sk.shape[0], q.shape[1] // 128)
        tile_ms, tile_ms_one, check_ms, checks, held_n = [], [], [], [], []
        for p, (args, outs) in enumerate(tiles):
            one = stream_chained_cuda(*args, slices=1)
            for name, g, w in zip(STRIPS, outs, one):
                err = max(err, strip_error(f"{c['name']} tile {p} {name}", g, w,
                                           (f"{slices} slices", "one slice")))
            del one
            tile_ms.append(cuda_ms(lambda: stream_chained_cuda(*args), 3))
            tile_ms_one.append(cuda_ms(lambda: stream_chained_cuda(*args, slices=1), 3))
            qk, _, bD, bG, bH, pen, r = args
            m = held_steps(n, sk.shape[0], len(tiles), p, rows)
            held_n.append(m)
            cut = [x[:m].contiguous() for x in (sk, bD, bG, bH)]
            got_cut = stream_chained_cuda(qk, *cut, pen, r, slices=CUT_SLICES)
            held = []
            for k, (name, g, gc) in enumerate(zip(STRIPS, outs, got_cut)):
                label = f"{c['name']} tile {p} {name} first {m} steps"
                held += [(label, k, g[:m].clone()), (f"{label} in {CUT_SLICES} slices", k, gc)]
            checks.append(plain.check("stream_chained_reference", (qk, *cut, pen, r), held))
            check_ms.append(cuda_ms(
                lambda: stream_chained_cuda(qk, *cut, pen, r, slices=CUT_SLICES), 10))
            del cut, got_cut
        del tiles
        results.append((c, rows, sk.shape, slices, steps, chain_ms, err, tile_ms,
                        tile_ms_one, check_ms, checks, tiles_chain_ms, facts, held_n))
        del q, sk
    out = []
    for c, rows, (T, N), slices, steps, chain_ms, err, tile_ms, tile_ms_one, check_ms, \
            checks, tiles_chain_ms, facts, held_n in results:
        plain_ms, plain_on = [], []
        for check in checks:
            e, ms, where = check.result()
            err = max(err, e)
            plain_ms.append(ms)
            plain_on.append(where)
        # the plain chain's time on those steps: its tiles' summed
        chain_plain_ms, chain_plain_on = sum(plain_ms), plain_on[0]
        print(f"phase chained_main_shape: ok {c['name']} rows={rows} tiles={len(tile_ms)} "
              f"strips [{T}, {N}] | chain kernel {chain_ms:.3f} ms -> "
              f"{c['cells'] / chain_ms / 1e6:.2f} GCUPS in the chain "
              f"({chain_ms / (c['wall_s'] * 1e3):.1%} of the wall time; ring "
              f"{facts['ring']}, {facts['slices']} slices, {facts['registers']} registers, "
              f"{facts['shared_bytes']} shared bytes a block), = the chain of a launch a tile "
              f"({tiles_chain_ms:.3f} ms) in full and the plain chain on the first {n} steps "
              f"({chain_plain_ms:.1f} ms on the {chain_plain_on}) | every tile "
              f"in {slices} slices of up to {steps} steps = one slice (4 strips, full "
              f"length): {', '.join(f'{x:.3f}' for x in tile_ms)} ms, one slice "
              f"{', '.join(f'{x:.3f}' for x in tile_ms_one)} ms | first "
              f"{', '.join(map(str, held_n))} steps of the tiles "
              f"bit-equal to the plain version (4 strips; the full run's, and "
              f"a run of the cut in {CUT_SLICES} slices: kernel "
              f"{', '.join(f'{x:.4f}' for x in check_ms)} ms), plain "
              f"{', '.join(f'{x:.1f} ({w})' for x, w in zip(plain_ms, plain_on))} ms per "
              "tile", flush=True)
        out.append(dict(name=c["name"], rows=rows, tiles=len(tile_ms), T=T, N=N,
                        slices=slices, slice_steps=steps, max_abs_err=err,
                        chain_ms=chain_ms, per_tile_chain_ms=tiles_chain_ms, chain=facts,
                        chain_plain_ms=chain_plain_ms, chain_plain_on=chain_plain_on,
                        tile_ms=tile_ms, tile_ms_one_slice=tile_ms_one,
                        check_steps=n, check_held=held_n, check_slices=CUT_SLICES,
                        check_ms=check_ms,
                        plain_ms=plain_ms, plain_on=plain_on))
    return out


def time_modes(run, reps):
    """Device ms of run(label, score_width=, state_dtype=) for int32 and
    each of MAIN_MODES, in turns (int32, the modes, int32 again); {label:
    ms}, int32 the mean of its two."""
    from swtpu_torch.utils.timing import cuda_ms

    first = cuda_ms(lambda: run("int32"), reps)
    out = {label: cuda_ms(lambda: run(label, score_width=w, state_dtype=d), reps)
           for label, w, d in MAIN_MODES}
    out["int32"] = (first + cuda_ms(lambda: run("int32"), reps)) / 2
    return out


def phase_modes_at_main_shape(bank, case_a, case_d):
    """The state modes at the main shapes.  (a)'s batch: the W = 12 and
    float32 kernels over the full strip against the int32 kernel (no (a)
    score nears 2^11, so the unbiased strip is the exact one), and the
    W = 8 kernel against its plain version on the first CHECK_STEPS steps
    (the full run's, and a run of the cut in CUT_SLICES slices; a strip is
    causal in t), the float32 one too for the plain version's time.  (d)'s
    chain at W = 12 and in float32 against the int32 chain, every tile's
    four strips in full (float32 equal; W = 12 equal plus the bias, as no
    (d) value nears 2^11), and each W = 12 tile against the plain version
    on its first held_steps steps (the W = 12 chain's first CHECK_STEPS).
    Every mode timed beside int32, on its own chain's inputs.  The chain
    kernel in each mode against the per-tile chain in full and the plain
    chain on the first CHECK_STEPS steps (hold_chain), timed beside int32.
    The plain versions run on the CPU beside the card's work (PlainJobs)."""
    from swtpu_torch import DEFAULT_PENALTIES as P
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.ops.stream import (
        _long_strip, stream_chained_cuda, stream_kernel_info, stream_strip_cuda,
    )

    n = CHECK_STEPS
    plain = plain_jobs()
    seg, rows, phys = stream_geometry(len(case_a["query"]), bank.config, bank.device)
    qk, sk = laid_out_batch(case_a["query"], case_a["db"], seg, rows, phys)
    exact = stream_strip_cuda(qk, sk, P, seg, rows)
    a = dict(name=case_a["name"], T=sk.shape[0], N=sk.shape[1], rows=rows, modes={})
    err = 0
    for label, width, dtype in MAIN_MODES:
        got = stream_strip_cuda(qk, sk, P, seg, rows, score_width=width, state_dtype=dtype)
        err = max(err, strip_error(f"(a) {label} full strip", got, exact, (label, "int32")))
        regs, _, blocks = stream_kernel_info(rows, score_width=width, state_dtype=dtype)
        a["modes"][label] = dict(slices=stream_strip_cuda.slices,
                                 slice_steps=stream_strip_cuda.slice_steps, registers=regs,
                                 resident_blocks_per_sm=blocks)
        del got
    del exact
    a["ms"] = time_modes(lambda _, **m: stream_strip_cuda(qk, sk, P, seg, rows, **m), 3)
    cut = sk[:n].contiguous()
    held = [(f"(a) W=8 first {n} steps", 0,
             stream_strip_cuda(qk, sk, P, seg, rows, score_width=8)[:n].clone()),
            (f"(a) W=8 first {n} steps in {CUT_SLICES} slices", 0,
             stream_strip_cuda(qk, cut, P, seg, rows, slices=CUT_SLICES, score_width=8))]
    a_checks = {"biased W=8": plain.check("stream_strip_reference", (qk, cut, P, seg, rows),
                                          held, score_width=8)}
    held = [(f"(a) float32 first {n} steps", 0,
             stream_strip_cuda(qk, cut, P, seg, rows, state_dtype="float32"))]
    a_checks["float32"] = plain.check("stream_strip_reference", (qk, cut, P, seg, rows), held,
                                      state_dtype="float32")
    a_err = err
    del qk, sk, cut, held

    _, rows, phys = stream_geometry(len(case_d["query"]), bank.config, bank.device)
    q, sk = long_batch(case_d["query"], case_d["db"], rows, phys)
    _, tiles = run_chain(q, sk, rows, stream_chained_cuda)
    d = dict(name=case_d["name"], T=sk.shape[0], N=sk.shape[1], rows=rows, modes={},
             tile_ms=[], plain_ms=[])
    err = 0
    d_checks = []  # (label, tile, its PlainCheck)
    chain_checks = {}  # a mode's chain held against the plain tiles by hold_chain
    inputs = {"int32": [args for args, _ in tiles]}  # each mode's tiles' own inputs
    for label, width, dtype in MAIN_MODES:
        bias = 0 if width is None else 1 << (width - 1)
        _, mtiles = run_chain(q, sk, rows, stream_chained_cuda, score_width=width,
                              state_dtype=dtype)
        regs, _, blocks = stream_kernel_info(rows, chained=True, score_width=width,
                                             state_dtype=dtype)
        d["modes"][label] = dict(slices=stream_chained_cuda.slices,
                                 slice_steps=stream_chained_cuda.slice_steps,
                                 registers=regs, resident_blocks_per_sm=blocks,
                                 chain=chain_facts(rows, sk.shape[0], q.shape[1] // 128,
                                                   score_width=width, state_dtype=dtype))
        # W = 12's tiles are each held against the plain tile below
        _, cerr, checks = hold_chain(f"(d) {label}", q, sk, rows, plain=width is None,
                                     score_width=width, state_dtype=dtype)
        err = max(err, cerr)
        chain_checks[label] = checks
        for p, ((_, outs), (margs, mouts)) in enumerate(zip(tiles, mtiles)):
            for name, g, w in zip(STRIPS, mouts, outs):
                err = max(err, strip_error(f"(d) {label} tile {p} {name} - {bias}", g - bias,
                                           w, (label, "int32")))
            if width is None:
                continue
            mqk, _, bD, bG, bH, pen, r = margs
            m = held_steps(n, sk.shape[0], len(mtiles), p, rows)
            cutin = [x[:m].contiguous() for x in (sk, bD, bG, bH)]
            got_cut = stream_chained_cuda(mqk, *cutin, pen, r, slices=CUT_SLICES,
                                          score_width=width, state_dtype=dtype)
            held = []
            for k, (name, g, gc) in enumerate(zip(STRIPS, mouts, got_cut)):
                label_n = f"(d) {label} tile {p} {name} first {m} steps"
                held += [(label_n, k, g[:m].clone()),
                         (f"{label_n} in {CUT_SLICES} slices", k, gc)]
            d_checks.append((label, p, plain.check(
                "stream_chained_reference", (mqk, *cutin, pen, r), held, score_width=width,
                state_dtype=dtype)))
            del cutin, got_cut, held
    # float32's plain chained tile is timed in phase 3 (its whole chains)
        inputs[label] = [args for args, _ in mtiles]
        del mtiles
    del tiles
    for p in range(len(inputs["int32"])):
        d["tile_ms"].append(time_modes(
            lambda label, **m: stream_chained_cuda(*inputs[label][p], **m), 3))
    del inputs
    d["chain_ms"] = time_modes(lambda _, **m: _long_strip(q, sk, P, rows, **m), 3)
    for label, check in a_checks.items():
        e, ms, where = check.result()
        a_err = max(a_err, e)
        a.setdefault("plain_ms", {})[label] = ms
    a.update(max_abs_err=a_err, check_steps=n, plain_on=where)
    plain8_ms, plainf_ms = a["plain_ms"]["biased W=8"], a["plain_ms"]["float32"]
    print(f"phase modes_main_shape: ok {a['name']} seg={seg} rows={a['rows']} strip "
          f"[{a['T']}, {a['N']}]: W=12 and float32 = the int32 kernel (full strip), W=8 "
          f"and float32 = the plain version on the first {n} steps (full run's and in "
          f"{CUT_SLICES} slices) | kernel " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in a["ms"].items())
          + f"; plain on {n} steps (on the {where}) W=8 {plain8_ms:.1f} ms, float32 "
          f"{plainf_ms:.1f} ms | "
          + ", ".join(f"{k}: {v['slices']} slices, {v['registers']} registers"
                      for k, v in a["modes"].items()), flush=True)
    for label, p, check in d_checks:
        e, ms, where = check.result()
        err = max(err, e)
        d["plain_ms"].append((label, p, ms))
    for label, checks in chain_checks.items():
        # the plain chain's time on the first n steps: its tiles' summed
        if checks:
            e, ms, _ = resolve_plain(checks)
            err = max(err, e)
        else:
            ms = sum(x for k, p, x in d["plain_ms"] if k == label and p >= 0)
        d["plain_ms"].append((f"{label} chain", -1, ms))
    d.update(max_abs_err=err, check_steps=n, plain_on=where)
    print(f"phase modes_main_shape: ok {d['name']} rows={rows} tiles={len(d['tile_ms'])} "
          f"strips [{d['T']}, {d['N']}]: float32 = int32 and W=12 = int32 + 2^11 (4 strips "
          f"of every tile, full length), W=12 = the plain version on every tile's held "
          f"steps, the chain's first {n} (full run's and in {CUT_SLICES} slices); the "
          f"chain kernel = the "
          f"per-tile chain in full and the plain chain on {n} steps in each mode | chain "
          f"kernel " + ", ".join(f"{k} {v:.3f} ms" for k, v in d["chain_ms"].items())
          + "; a tile " + "; ".join(
              ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()) for t in d["tile_ms"])
          + f"; plain on {n} steps (on the {where}) " + ", ".join(
              f"{k} tile {p} {x:.1f} ms" if p >= 0 else f"{k} {x:.1f} ms"
              for k, p, x in d["plain_ms"]) + " | "
          + ", ".join(f"{k}: {v['slices']} slices, {v['registers']} registers"
                      for k, v in d["modes"].items()), flush=True)
    return a, d


def exact_or_not(name, label, got, exact, qlen):
    """A 16-bit state's strip against the int32 kernel's: int16 and exact
    uint16 equal it; so does bfloat16 while no score passes 256 (a query of
    32 bases tops out at 160); past it bfloat16 rounds, and wrapping uint16
    always wraps, so they must differ from it."""
    if label in ("int16", "uint16") or (label == "bfloat16" and 5 * qlen <= 256):
        return strip_error(name, got, exact, (label, "int32"))
    if not (got != exact).any():
        fail(f"{name}: equal to the int32 strip, so nothing rounded or wrapped")
    return 0


def phase_16bit_vs_plain(rng):
    """The wavefront in each 16-bit state (SIXTEEN_BIT), two streams a
    thread, against its plain version, bit for bit, at 512 physical streams
    and at 511 (a dead high half) on reads of which every COPY_EVERY-th is
    the query (bfloat16 rounds those below their exact score; uint16 wrap
    sends every read with a mismatch past 65,531): both forms at rows 1,
    and rows 2, 4 and 8 (the 16-bit states refuse 16); then whole K = 2
    chains at rows 8 on 512 and 511 streams, every tile's four strips and
    the last accumulator.  Each also against the int32 kernel at the same
    penalties (exact_or_not)."""
    import numpy as np
    from swtpu_torch import Penalties
    from swtpu_torch.ops.stream import (
        stream_kernel_info, stream_strip_cuda, stream_strip_reference,
    )
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    strips, chains = [], []
    for seg, rows, tail_acc, S in SIXTEEN_CHECKS:
        query = rng.integers(0, 4, size=128 // seg).astype(np.int8)
        db = with_copies(make_db(rng, S * seg * 4, 24, 256), query, COPY_EVERY)
        qk, sk = laid_out_batch(query, db, seg, rows, S)
        form = "tail-acc" if tail_acc else "ripple-H"
        for label, dtype, pen in SIXTEEN_BIT:
            args = (qk, sk, Penalties(*pen), seg, rows, tail_acc)
            got = stream_strip_cuda(*args, state_dtype=dtype)
            want, plain_ms = cuda_once(lambda: stream_strip_reference(*args, state_dtype=dtype))
            name = f"{label} {form} seg={seg} rows={rows} S={S}"
            exact = stream_strip_cuda(*args)
            err = max(strip_error(name, got, want),
                      exact_or_not(name, label, got, exact, len(query)))
            ms = cuda_ms(lambda: stream_strip_cuda(*args, state_dtype=dtype), 10)
            int32_ms = cuda_ms(lambda: stream_strip_cuda(*args), 10)
            T, N = sk.shape
            strips.append(dict(mode=label, form=form, segments=seg, rows=rows, T=T, N=N,
                               differ_from_int32=int((got != exact).sum()), max_abs_err=err,
                               ms=ms, int32_ms=int32_ms, plain_ms=plain_ms,
                               registers=stream_kernel_info(rows, tail_acc,
                                                            state_dtype=dtype)[0]))
        print(f"phase kernel_vs_plain: ok 16-bit {form} seg={seg} rows={rows} S={S} strip "
              f"[{T}, {N}] bit-equal in " + ", ".join(
                  f"{r['mode']} ({r['differ_from_int32']} cells off int32; kernel "
                  f"{r['ms']:.4f} ms, int32 {r['int32_ms']:.4f}, plain {r['plain_ms']:.1f})"
                  for r in strips[-len(SIXTEEN_BIT):]), flush=True)
    rows = SIXTEEN_ROWS
    for S in SIXTEEN_CHAIN_STREAMS:
        chains += chains_16bit(rng, S, rows)
    return strips, chains


def chains_16bit(rng, S, rows):
    """Whole K = 2 chains on S physical streams in each 16-bit state
    against the plain version (phase_16bit_vs_plain): the per-tile chain
    (a launch a tile, the host's shifts) every tile's four strips and its
    last accumulator, and the chain in one launch (``_long_strip``'s
    route) its last accumulator."""
    import numpy as np
    from swtpu_torch import Penalties
    from swtpu_torch.ops.stream import (
        _long_strip, stream_chain_info, stream_chained_cuda, stream_chained_reference,
        stream_kernel_info,
    )
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    chains = []
    query = rng.integers(0, 4, size=256).astype(np.int8)
    db = with_copies(make_db(rng, S * 4, 24, 256), query, COPY_EVERY)
    q, sk = long_batch(query, db, rows, S)
    for label, dtype, pen in SIXTEEN_BIT:
        pen = Penalties(*pen)
        exact, _ = run_chain(q, sk, rows, stream_chained_cuda, pen)
        acc, tiles = run_chain(q, sk, rows, stream_chained_cuda, pen, state_dtype=dtype)
        (want, want_tiles), plain_ms = cuda_once(
            lambda: run_chain(q, sk, rows, stream_chained_reference, pen, state_dtype=dtype))
        name = f"{label} chain K=2 rows={rows} S={S}"
        (chain, launched) = launches_of(lambda: _long_strip(q, sk, pen, rows,
                                                            state_dtype=dtype))
        if launched != (0, 1):
            fail(f"{name}: the chain made (B1, B3) {launched} launches, want one chain")
        err = max(strip_error(f"{name} last acc", acc, want),
                  strip_error(f"{name} chain kernel", chain, want),
                  exact_or_not(name, label, acc, exact, len(query)))
        for p, ((_, outs), (_, wouts)) in enumerate(zip(tiles, want_tiles)):
            for strip, g, w in zip(STRIPS, outs, wouts):
                err = max(err, strip_error(f"{name} tile {p} {strip}", g, w))
        ms = cuda_ms(lambda: _long_strip(q, sk, pen, rows, state_dtype=dtype), 5)
        tiles_ms = cuda_ms(lambda: _long_strip(q, sk, pen, rows, tile=stream_chained_cuda,
                                               state_dtype=dtype), 5)
        int32_ms = cuda_ms(lambda: _long_strip(q, sk, pen, rows), 5)
        T, N = sk.shape
        chains.append(dict(mode=label, tiles=2, rows=rows, T=T, N=N,
                           differ_from_int32=int((acc != exact).sum()), max_abs_err=err,
                           ms=ms, per_tile_chain_ms=tiles_ms, int32_ms=int32_ms,
                           plain_ms=plain_ms,
                           registers=stream_chain_info(rows, state_dtype=dtype)[0],
                           tile_registers=stream_kernel_info(rows, chained=True,
                                                             state_dtype=dtype)[0]))
    print(f"phase kernel_vs_plain: ok 16-bit chain K=2 rows={rows} S={S} strips [{T}, {N}] "
          f"bit-equal (the one-launch chain's and the per-tile chain's last acc, 4 per "
          f"tile) in " + ", ".join(
              f"{r['mode']} ({r['differ_from_int32']} cells off int32; chain {r['ms']:.4f} "
              f"ms, a launch a tile {r['per_tile_chain_ms']:.4f}, int32 "
              f"{r['int32_ms']:.4f}, plain {r['plain_ms']:.1f})" for r in chains),
          flush=True)
    return chains


# the 16-bit states' B1 shapes: (label, index of the main case, segments,
# rows, held in full): (a) at rows 8 and 4 on its first CHECK_STEPS steps,
# (c) (segments 2, rows 8, ScoreBank's geometry for it) in full
SIXTEEN_B1 = (("(a) rows 8", 0, 1, 8, False), ("(a) rows 4", 0, 1, 4, False),
              ("(c) rows 8", 2, 2, 8, True))


def phase_16bit_at_main_shape(cases, long_cases, peaks):
    """The 16-bit states at the main shapes.  B1 (two streams a thread, 8
    threads a pair at rows 4 and 8) at SIXTEEN_B1's shapes, the slices
    from the batch's longest read as the bank passes it: int16 and exact
    uint16 equal to the int32 kernel at the same rows over the full strip;
    every state against the plain version ((a): the first CHECK_STEPS
    steps, the full run's and a run of the cut in CUT_SLICES slices; (c):
    in full).  B3 at rows SIXTEEN_ROWS on (d)'s and (e)'s chains in one
    launch (hold_chain: = the per-tile chain in full, every tile = the
    plain tile on the steps that hold the chain on its first CHECK_STEPS);
    int16 and exact uint16 also = the int32 chain.  Each timed beside int32
    at the same rows and, a chain, beside the per-tile chain (K launches of
    the same kernel at K = 1 and the host's shifts), in turns; each with
    its bound (peaks) and share, slices and registers.  The plain versions
    run on the CPU beside the card's work (PlainJobs)."""
    from swtpu_torch import DEFAULT_PENALTIES, Penalties
    from swtpu_torch.ops.stream import (
        _long_strip, pads_stay_at_zero, stream_chain_cuda, stream_chained_cuda,
        stream_kernel_info, stream_strip_cuda, streams_per_thread,
    )
    from swtpu_torch.utils.timing import cuda_ms

    n = CHECK_STEPS
    plain = plain_jobs()
    b1, chains, pending = [], [], []

    def ops_lanes(dtype):
        ops = WAVEFRONT_OPS + SIXTEEN_EXTRA_OPS[dtype]
        return ops, cell_lanes("wavefront", dtype, ops)

    for label, k, seg, rows, full in SIXTEEN_B1:
        case = cases[k]
        qk, sk = laid_out_batch(case["query"], case["db"], seg, rows, MODE_STREAMS)
        longest = int(case["db"].lens.max())
        T, N = sk.shape
        S = N // seg
        cut = sk if full else sk[:n].contiguous()
        row = dict(name=case["name"], shape=label, T=T, N=N, segments=seg, rows=rows,
                   longest_read=longest, check_steps=T if full else n, modes={},
                   int32_slices=stream_strip_cuda.slices)
        err = 0
        for mode, dtype, pen in SIXTEEN_BIT:
            pen = Penalties(*pen)
            kw = dict(state_dtype=dtype, longest_read=longest)
            got = stream_strip_cuda(qk, sk, pen, seg, rows, **kw)
            slices, steps = stream_strip_cuda.slices, stream_strip_cuda.slice_steps
            # the int32 kernel at the state's penalties
            exact = stream_strip_cuda(qk, sk, pen, seg, rows, longest_read=longest)
            if mode in ("int16", "uint16"):
                err = max(err, strip_error(f"{label} {mode} full strip", got, exact,
                                           (mode, "int32")))
            held = [(f"{label} {mode} first {cut.shape[0]} steps", 0,
                     got[: cut.shape[0]].clone())]
            if not full:
                held.append((f"{label} {mode} first {n} steps in {CUT_SLICES} slices", 0,
                             stream_strip_cuda(qk, cut, pen, seg, rows, slices=CUT_SLICES,
                                               state_dtype=dtype)))
            pending.append((row, mode, plain.check("stream_strip_reference",
                                                    (qk, cut, pen, seg, rows), held,
                                                    state_dtype=dtype)))
            regs, spill, blocks = stream_kernel_info(rows, state_dtype=dtype)
            ops, lanes = ops_lanes(dtype)
            bound = peaks.bound(128 * S + T * N * 5, 128 * T * S * ops, lanes)
            row["modes"][mode] = dict(
                state_dtype=dtype, penalties=list(pen.astuple()), slices=slices,
                slice_steps=steps, registers=regs, spill_bytes=spill,
                resident_blocks_per_sm=blocks, streams_per_thread=streams_per_thread(dtype),
                bound_ms=bound[0], bound_by=bound[1],
                differ_from_int32=int((got != exact).sum()))
            if spill:
                fail(f"B1 rows {rows} {dtype} spills {spill} bytes a thread")
            del got, held
        # timed in turns: int32, every state, int32 again (10 calls each)
        int32 = [cuda_ms(lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows,
                                                   longest_read=longest), 10)]
        for mode, dtype, pen in SIXTEEN_BIT:
            m = row["modes"][mode]
            m["ms"] = cuda_ms(lambda: stream_strip_cuda(
                qk, sk, Penalties(*pen), seg, rows, state_dtype=dtype,
                longest_read=longest), 10)
            m["bound_share"] = m["bound_ms"] / m["ms"]
        int32.append(cuda_ms(lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows,
                                                       longest_read=longest), 10))
        row.update(int32_ms=sum(int32) / 2, int32_registers=stream_kernel_info(rows)[0],
                   max_abs_err=err)
        b1.append(row)
        del qk, sk, cut

    rows = SIXTEEN_ROWS
    for case in long_cases:
        q, sk = long_batch(case["query"], case["db"], rows, MODE_STREAMS)
        T, N = sk.shape
        K = q.shape[1] // 128
        row = dict(name=case["name"], T=T, N=N, tiles=K, rows=rows, check_steps=n, modes={})
        err = 0
        for mode, dtype, pen in SIXTEEN_BIT:
            pen = Penalties(*pen)
            chain, e, checks = hold_chain(f"{case['name'][0]} rows {rows} {mode}", q, sk,
                                          rows, pen, state_dtype=dtype)
            slices, steps = stream_chain_cuda.slices, stream_chain_cuda.slice_steps
            err = max(err, e)
            exact = _long_strip(q, sk, pen, rows)  # the int32 chain at the same penalties
            if mode in ("int16", "uint16"):
                err = max(err, strip_error(f"{case['name'][0]} rows {rows} {mode} chain",
                                           chain, exact, (mode, "int32")))
            pending.append((row, mode, checks))
            facts = chain_facts(rows, T, K, pads_stay_at_zero(pen, dtype), state_dtype=dtype)
            if facts["slices"] != slices:
                fail(f"the chain at rows {rows} in {dtype} ran {slices} slices, its "
                     f"geometry gives {facts['slices']}")
            if facts["spill_bytes"]:
                fail(f"the chain kernel at rows {rows} in {dtype} spills "
                     f"{facts['spill_bytes']} bytes a thread")
            tile_regs, tile_spill, tile_blocks = stream_kernel_info(rows, chained=True,
                                                                    state_dtype=dtype)
            if tile_spill:
                fail(f"the per-tile chain kernel at rows {rows} in {dtype} spills "
                     f"{tile_spill} bytes a thread")
            ops, lanes = ops_lanes(dtype)
            # every tile's register and the stream read once, the last strip
            # written once, K tiles' operations
            bound = peaks.bound(K * 128 * N + T * N * (1 + 4), K * 128 * T * N * ops, lanes)
            row["modes"][mode] = dict(
                state_dtype=dtype, penalties=list(pen.astuple()), slices=slices,
                slice_steps=steps, chain=facts, tile_registers=tile_regs,
                tile_resident_blocks_per_sm=tile_blocks, bound_ms=bound[0],
                bound_by=bound[1], differ_from_int32=int((chain != exact).sum()))
            del chain, exact
        int32 = [cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows), 5)]
        for mode, dtype, pen in SIXTEEN_BIT:
            m = row["modes"][mode]
            pen = Penalties(*pen)
            m["ms"] = cuda_ms(lambda: _long_strip(q, sk, pen, rows, state_dtype=dtype), 5)
            m["per_tile_chain_ms"] = cuda_ms(lambda: _long_strip(
                q, sk, pen, rows, tile=stream_chained_cuda, state_dtype=dtype), 5)
            m["bound_share"] = m["bound_ms"] / m["ms"]
        int32.append(cuda_ms(lambda: _long_strip(q, sk, DEFAULT_PENALTIES, rows), 5))
        row.update(int32_ms=sum(int32) / 2, max_abs_err=err)
        chains.append(row)
        del q, sk

    for row, mode, check in pending:
        e, ms, where = resolve_plain(check) if isinstance(check, list) else check.result()
        row["max_abs_err"] = max(row["max_abs_err"], e)
        row["modes"][mode]["plain_ms"] = ms
        row["plain_on"] = where
    for row in b1:
        print(f"phase 16bit_main_shape: ok B1 {row['name']} seg={row['segments']} rows="
              f"{row['rows']} strip [{row['T']}, {row['N']}], longest read "
              f"{row['longest_read']}: int16 and uint16 = the int32 kernel (full strip), "
              f"every state = the plain version on the first {row['check_steps']} steps"
              f"{'' if row['check_steps'] == row['T'] else f' (and in {CUT_SLICES} slices)'}"
              f" | int32 {row['int32_ms']:.3f} ms ({row['int32_slices']} slices), " + ", ".join(
                  f"{k} {v['ms']:.3f} ms: {100 * v['bound_share']:.1f} % of "
                  f"{v['bound_ms']:.3f} ({v['slices']} slices, {v['registers']} registers; "
                  f"plain {v['plain_ms']:.1f} ms)" for k, v in row["modes"].items())
              + f" (plain on the {row['plain_on']})", flush=True)
    for row in chains:
        print(f"phase 16bit_main_shape: ok B3 {row['name']} rows={row['rows']} chain of "
              f"{row['tiles']} tiles [{row['T']}, {row['N']}], one launch: = the per-tile "
              f"chain in full, = the plain chain on its first {n} steps (every tile), "
              f"int16 and uint16 = the int32 chain | int32 chain {row['int32_ms']:.3f} ms, "
              + ", ".join(
                  f"{k} {v['ms']:.3f} ms: {100 * v['bound_share']:.1f} % of "
                  f"{v['bound_ms']:.3f} (a launch a tile {v['per_tile_chain_ms']:.3f}; "
                  f"{v['slices']} slices, ring {v['chain']['ring']}, "
                  f"{v['chain']['registers']} registers; plain tiles "
                  f"{v['plain_ms']:.1f} ms)" for k, v in row["modes"].items())
              + f" (plain on the {row['plain_on']})", flush=True)
    return b1, chains


BF16_SAMPLE = 256  # reads of a bfloat16 bank run held against the plain path


def phase_16bit_databases(card, case_c, case_e):
    """ScoreBank(stream_state_dtype=..., stream_rows=SIXTEEN_ROWS,
    device="cuda").score_database on case (c)'s database and (e)'s long
    query, each path's launch counters set to 0 just before it (B1 once a
    call on (c), one B3 chain a call on (e): its 4 tiles in one launch):
    int16's seeded sample of 2048 reads and top-10 against the oracle; bfloat16's
    first BF16_SAMPLE sampled reads against the port's plain path on the
    CPU on those reads (a bfloat16 score does not depend on rows or on the
    stream a read rides)."""
    import numpy as np
    from swtpu_torch import SWConfig, ScoreBank

    out = []
    for dtype in ("int16", "bfloat16"):
        cfg = SWConfig(stream_state_dtype=dtype, stream_rows=SIXTEEN_ROWS)
        for c, want_launches in ((case_c, (4, 0)), (case_e, (0, 4))):
            name = f"{c['name'][0]}_{dtype}_rows{SIXTEEN_ROWS}"
            bank = ScoreBank(cfg, device="cuda")
            (res, wall, walls, peak), launched = launches_of(
                lambda: timed_runs(name, lambda: bank.score_database(c["query"], c["db"])))
            if launched != want_launches:
                fail(f"{name}: (wavefront, chained) launched {launched} times in 4 calls, "
                     f"want {want_launches}")
            if dtype == "int16":
                check_oracle(name, res, c["query"], c["db"], c["sample"], c["oracle"])
                held = f"sample {len(c['sample'])} + top-10 = oracle"
            else:
                sample = c["sample"][:BF16_SAMPLE]
                t0 = time.perf_counter()
                want = ScoreBank(cfg, device="cpu").score_database(
                    c["query"], [c["db"].read(i) for i in sample]).scores
                plain_s = time.perf_counter() - t0
                if not np.array_equal(res.scores[sample], want):
                    k = int(np.flatnonzero(res.scores[sample] != want)[0])
                    fail(f"{name}: read {sample[k]} scored {res.scores[sample[k]]}, the "
                         f"plain path on the CPU {want[k]}")
                held = (f"{BF16_SAMPLE} sampled = the plain path on the CPU "
                        f"({plain_s:.1f} s)")
            below = int((res.scores < c["scores"]).sum())
            if dtype == "int16" and below:
                fail(f"{name}: {below} reads below the int32 scores")
            gcups = res.cells / wall / 1e9
            print(f"phase main_path: ok {name} reads={len(c['db'].lens)} launches "
                  f"wavefront={launched[0]} chained={launched[1]} peak device memory "
                  f"{peak:.2f} GB | {held}; {below} reads below the exact scores | wall "
                  f"median of 3 {wall*1e3:.2f} ms (runs "
                  f"{', '.join(f'{w*1e3:.2f}' for w in walls)}; int32 rows 16 "
                  f"{c['wall_s']*1e3:.2f}) -> {gcups:.2f} GCUPS on {card}", flush=True)
            out.append(dict(name=name, case=c["name"], state_dtype=dtype, rows=SIXTEEN_ROWS,
                            cells=res.cells, wall_s=wall, int32_wall_s=c["wall_s"],
                            gcups=gcups, launches=list(launched), peak_gb=peak,
                            below_exact=below))
    return out


# resident serving: (name, the main case whose reads load, max_query_len,
# query lengths).  (k) loads (a)'s reads for 256 bases (segments 1, rows
# 16, K <= 2: B1 for the queries of up to 128 bases, a B3 chain of two
# tiles for the longer ones); (l) loads (b)'s reads for 32 (segments 4, rows 4)
K_SERVING = ("k serving", 0, 256, (16, 32, 64, 100, 128, 200, 256, 24, 48, 80,
                                   112, 128, 160, 192, 224, 240))
L_SERVING = ("l serving", 1, 32, (8, 12, 16, 20, 24, 28, 30, 32))
SERVE_TIED = 4  # (k)'s 128-base query: every SERVE_EVERY-th read is it
SERVE_EVERY = 8192  # 32 reads tie at the top score, so a top-10 cuts the group
SERVE_HELD = {"k serving": (3, 4, 6), "l serving": (0, 4, 7)}  # against the oracle
SERVE_SAMPLE = 2048  # reads of each held query's oracle sample
SERVE_TOPK = (3, 4, 6)  # (k)'s queries whose topk_loaded(10) is timed
DAEMON_QUERIES = (4, 5)  # (k)'s queries the two daemon clients send
TOPK = 10


def walls_of(run, reps=3):
    """run() once warm, then `reps` times on the host clock (run returns
    host values, so each call has waited for the card); (the results,
    the timed walls)."""
    results = [run()]
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        results.append(run())
        walls.append(time.perf_counter() - t0)
    return results, walls


def ms_list(walls):
    return ", ".join(f"{w*1e3:.3f}" for w in walls)


def dispatch_launches(queries):
    """(wavefront, chained) launches of one dispatch of each query on a
    resident database: one B1 for a query of up to 128 bases, else one B3
    chain of its 128-base tiles."""
    import numpy as np

    return np.array([sum(len(q) <= 128 for q in queries),
                     sum(len(q) > 128 for q in queries)])


def serve_resident(bank, name, db, queries, max_query_len, topk_idx):
    """A case's serving path through the user's entry points: load_database,
    score_loaded_many waves of all the queries (warm, median of 3), then
    score_loaded (warm, median of 3) on every query and topk_loaded(TOPK)
    on the `topk_idx` ones.  Every wave, score_loaded and topk_loaded
    result must repeat the first wave's."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loaded = bank.load_database(db, max_query_len=max_query_len)
    load_s = time.perf_counter() - t0
    waves, wave_walls = walls_of(lambda: bank.score_loaded_many(queries, loaded))
    wave = waves[0]
    for again in waves[1:]:
        if any(not np.array_equal(a.scores, w.scores) for a, w in zip(again, wave)):
            fail(f"{name}: the waves' scores differ between waves")
    loaded_walls = []
    for i, q in enumerate(queries):
        results, walls = walls_of(lambda: bank.score_loaded(q, loaded))
        if any(not np.array_equal(r.scores, wave[i].scores) for r in results):
            fail(f"{name}: score_loaded of query {i} differs from the wave's")
        loaded_walls.append(walls)
    topk = {}
    for i in topk_idx:
        results, walls = walls_of(lambda: bank.topk_loaded(queries[i], loaded, k=TOPK))
        if any(r != results[0] for r in results):
            fail(f"{name}: topk_loaded of query {i} differs between calls")
        topk[i] = (results[0], walls)
    return dict(loaded=loaded, load_s=load_s, wave=wave, wave_walls=wave_walls,
                loaded_walls=loaded_walls, topk=topk)


def serve_daemon(bank, db, loaded, queries):
    """ServeEngine over a loaded database, serve_socket on a UNIX socket in
    a thread, and one client thread per query, all at once: each sends SEQ,
    then TOP TOPK, then QUIT.  The server is shut down after; (each
    client's {"SEQ": (lines, wall s), "TOP": ...}, requests served)."""
    import socket
    import tempfile
    import threading

    from swtpu_torch.io.encode import decode_seq
    from swtpu_torch.server import ServeEngine, client_request, serve_socket

    engine = ServeEngine(bank, db.names, db, db=loaded)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "serve.sock")
        ready = threading.Event()
        server = threading.Thread(target=serve_socket, daemon=True, kwargs=dict(
            engine=engine, unix_path=path, ready_event=ready))
        server.start()
        if not ready.wait(30):
            fail("daemon: the server never bound its socket")

        def client(cid, seq):
            got = {}
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(path)
            try:
                for cmd, line in (("SEQ", f"SEQ {seq}"), ("TOP", f"TOP {TOPK} {seq}")):
                    t0 = time.perf_counter()
                    lines = client_request(s, line)
                    got[cmd] = (lines, time.perf_counter() - t0)
                s.sendall(b"QUIT\n")
            finally:
                s.close()
            results[cid] = got

        clients = [threading.Thread(target=client, args=(i, decode_seq(q)))
                   for i, q in enumerate(queries)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(300)
        ready.server.shutdown()
        server.join(30)
        if server.is_alive() or any(t.is_alive() for t in clients):
            fail("daemon: a server or client thread is still running")
    if sorted(results) != list(range(len(queries))):
        fail(f"daemon: clients {sorted(results)} of {len(queries)} finished")
    return results, engine.served


def phase_serving(rng, card, main_cases):
    """(k), (l) and the daemon: resident serving through the user's entry
    points, each path's launch counters set to 0 just before it and read
    just after ((k)'s window holds the daemon too).  Then, outside those
    windows: every wave score vector against score_database on the same
    query and database (all reads; timed beside score_loaded), three
    queries of each case against the oracle (sample + top-10), every
    topk_loaded against ScoreResult.top_k of the full vector (ties at
    (k)'s top), and the daemon's lines against score_loaded and
    topk_loaded.  (k)'s longest query's chain on the resident stream: the
    chain kernel against the per-tile chain in full and the plain chain on
    the first CHECK_STEPS steps (resident_chain)."""
    import numpy as np
    import torch
    from swtpu_torch import ScoreBank, score_many_vs_one

    bank = ScoreBank(device="cuda")
    out = []
    chain_held = None
    for name, case, cap, lengths in (K_SERVING, L_SERVING):
        queries = [rng.integers(0, 4, size=k).astype(np.int8) for k in lengths]
        db = main_cases[case]["db"]
        topk_idx = ()
        if name == K_SERVING[0]:
            db = with_copies(db, queries[SERVE_TIED], SERVE_EVERY)
            topk_idx = SERVE_TOPK

        def path():
            r = serve_resident(bank, name, db, queries, cap, topk_idx)
            if name == K_SERVING[0]:
                r["daemon"] = serve_daemon(bank, db, r["loaded"],
                                           [queries[i] for i in DAEMON_QUERIES])
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            return r

        r, launched = launches_of(path)
        left = live_children()
        if left:
            fail(f"{name}: processes still running after the daemon's shutdown: {left}")
        loaded, wave = r["loaded"], r["wave"]
        if loaded.k_max > 1:
            longest = max(queries, key=len)
            chain_held = (name, len(longest), *resident_chain(
                f"{name} query of {len(longest)} bases", longest, loaded.stream, loaded.rows))
        # 4 waves and 4 score_loaded a query, 4 topk_loaded a topk query,
        # and a SEQ and a TOP a daemon client
        want = 8 * dispatch_launches(queries)
        want += 4 * dispatch_launches([queries[i] for i in topk_idx])
        if "daemon" in r:
            want += 2 * dispatch_launches([queries[i] for i in DAEMON_QUERIES])
        if list(launched) != want.tolist() or sum(launched) == 0:
            fail(f"{name}: (wavefront, chained) launched {launched} times, want "
                 f"{want.tolist()}")
        n = loaded.n_reads
        T, N = loaded.stream.shape
        wave_s = statistics.median(r["wave_walls"])
        ls = loaded.load_s
        print(f"phase serving: {name} loaded {n} reads of {main_cases[case]['name']}"
              f"{' (copies of query %d every %d reads)' % (SERVE_TIED, SERVE_EVERY) if topk_idx else ''} "
              f"for {cap} bases: stream [{T}, {N}] segments={loaded.segments} rows={loaded.rows} "
              f"k_max={loaded.k_max} in {r['load_s']*1e3:.2f} ms (pack {ls['pack']*1e3:.2f}, "
              f"wire {ls['wire']*1e3:.2f}, H2D + unpack + transpose {ls['device']*1e3:.2f}) | "
              f"wave of {len(queries)} queries median of 3 {wave_s*1e3:.2f} ms (runs "
              f"{ms_list(r['wave_walls'])}) -> {wave_s/len(queries)*1e3:.3f} ms a query | "
              f"launches wavefront="
              f"{launched[0]} chained={launched[1]} | peak device memory "
              f"{r['peak_gb']:.2f} GB on {card}", flush=True)
        rows = []
        for i, q in enumerate(queries):
            results, walls = walls_of(lambda: bank.score_database(q, db))
            for res in results:
                if not np.array_equal(res.scores, wave[i].scores):
                    k = int(np.flatnonzero(res.scores != wave[i].scores)[0])
                    fail(f"{name}: query {i} read {k}: the wave {wave[i].scores[k]}, "
                         f"score_database {res.scores[k]}")
            lw = r["loaded_walls"][i]
            rows.append(dict(qlen=len(q), tiles=-(-len(q) // 128),
                             loaded_ms=statistics.median(lw) * 1e3,
                             loaded_runs_ms=[w * 1e3 for w in lw],
                             database_ms=statistics.median(walls) * 1e3,
                             database_runs_ms=[w * 1e3 for w in walls]))
            print(f"phase serving: {name} query {i} of {len(q)} bases: score_loaded median "
                  f"of 3 {rows[-1]['loaded_ms']:.3f} ms (runs {ms_list(lw)}), "
                  f"score_database {rows[-1]['database_ms']:.2f} ms (runs {ms_list(walls)}) | "
                  f"the wave's scores = score_database's on all {n} reads", flush=True)
        t0 = time.perf_counter()
        for i in SERVE_HELD[name]:
            sample = np.sort(rng.choice(n, size=SERVE_SAMPLE, replace=False))
            want = score_many_vs_one(queries[i], [db.read(j) for j in sample])
            check_oracle(f"{name} query {i}", wave[i], queries[i], db, sample, want)
        oracle_s = time.perf_counter() - t0
        topk_rows = {}
        for i, (top, walls) in r["topk"].items():
            if top != wave[i].top_k(TOPK):
                fail(f"{name}: topk_loaded of query {i} {top}, top_k of the full vector "
                     f"{wave[i].top_k(TOPK)}")
            topk_rows[i] = dict(qlen=len(queries[i]), ms=statistics.median(walls) * 1e3,
                                runs_ms=[w * 1e3 for w in walls])
        if topk_idx:
            tied = r["topk"][SERVE_TIED][0]
            best = 5 * len(queries[SERVE_TIED])
            if tied != [(best, j * SERVE_EVERY) for j in range(TOPK)]:
                fail(f"{name}: the tied query's top-{TOPK} {tied}, want the first {TOPK} "
                     f"copies at {best}")
            print(f"phase serving: {name} topk_loaded(k={TOPK}) = ScoreResult.top_k({TOPK}) "
                  f"of the full vector for queries {list(topk_idx)} (query {SERVE_TIED}: "
                  f"{TOPK} of {-(-n // SERVE_EVERY)} reads tied at {best}) | median of 3 "
                  + ", ".join(f"query {i} {t['ms']:.3f} ms (runs {', '.join(f'{x:.3f}' for x in t['runs_ms'])})"
                              for i, t in topk_rows.items()), flush=True)
        print(f"phase serving: ok {name} | all {len(queries)} wave vectors = score_database, "
              f"queries {list(SERVE_HELD[name])} sample {SERVE_SAMPLE} + top-10 = oracle "
              f"({oracle_s:.1f} s)", flush=True)
        entry = dict(name=name, case=main_cases[case]["name"], max_query_len=cap,
                     reads=n, shape=[int(T), int(N)], segments=loaded.segments,
                     rows=loaded.rows, k_max=loaded.k_max, load_s=r["load_s"],
                     load_stages_s=ls, wave_queries=len(queries), wave_s=wave_s,
                     wave_runs_s=r["wave_walls"], wave_ms_a_query=wave_s / len(queries) * 1e3,
                     queries=rows, topk=topk_rows, launches=[int(x) for x in launched],
                     peak_gb=r["peak_gb"])
        if topk_idx:  # (k)'s reads and one-device answers, for phase "sharded"
            entry["_inputs"] = dict(db=db, queries=queries, wave=[w.scores for w in wave],
                                    topk={i: top for i, (top, _) in r["topk"].items()},
                                    loaded_ms=[x["loaded_ms"] for x in rows])
        if "daemon" in r:
            clients, n_served = r["daemon"]
            client_walls = {}
            for cid, qi in enumerate(DAEMON_QUERIES):
                (seq_lines, seq_s), (top_lines, top_s) = (clients[cid]["SEQ"],
                                                           clients[cid]["TOP"])
                got = np.array([int(l.rsplit("\t", 1)[1]) for l in seq_lines], np.int32)
                if len(seq_lines) != n or not np.array_equal(got, wave[qi].scores):
                    fail(f"daemon: client {cid}'s SEQ gave {len(seq_lines)} lines, not "
                         f"score_loaded's {n} scores")
                want_top = [f"# top: >{db.names[j]} score: {s}"
                            for s, j in bank.topk_loaded(queries[qi], loaded, k=TOPK)]
                if top_lines != want_top:
                    fail(f"daemon: client {cid}'s TOP {top_lines} vs topk_loaded {want_top}")
                client_walls[cid] = dict(query=qi, qlen=len(queries[qi]),
                                         seq_ms=seq_s * 1e3, top_ms=top_s * 1e3)
            if n_served != 2 * len(DAEMON_QUERIES):
                fail(f"daemon: served {n_served} requests, want {2 * len(DAEMON_QUERIES)}")
            print(f"phase serving: ok daemon over {name}'s database: {len(DAEMON_QUERIES)} "
                  f"concurrent UNIX-socket clients, SEQ ({n} lines) = score_loaded, TOP "
                  f"{TOPK} = topk_loaded; walls at the client: " + "; ".join(
                      f"client {c} ({w['qlen']} bases) SEQ {w['seq_ms']:.2f} ms, TOP "
                      f"{w['top_ms']:.2f} ms" for c, w in client_walls.items())
                  + "; server shut down, no process left", flush=True)
            entry["daemon"] = dict(clients=client_walls, served=n_served)
        out.append(entry)
    name, qlen, err, checks = chain_held
    e, ms, where = resolve_plain(checks)
    if max(err, e):
        fail(f"{name}: the chain kernel on the resident stream differs by {max(err, e)}")
    print(f"phase serving: ok {name} the {qlen}-base query's chain kernel on the resident "
          f"stream = the per-tile chain in full and the plain chain on its first "
          f"{CHECK_STEPS} steps ({ms:.1f} ms on the {where})", flush=True)
    out[0]["chain_held"] = dict(qlen=qlen, plain_ms=ms, plain_on=where)
    return out


# the job layer (phase "jobs"): (a)'s reads in chunks of JOBS_CHUNK_A (4
# chunks), (b)'s in chunks of JOBS_CHUNK_B (the last of 62,144 reads), a
# resumable job at (a) killed after JOBS_KILL_AFTER chunks, faults on (f)'s
# reads on the column path, and the CLI's --resume and --profile
JOBS_CHUNK_A = 65536
JOBS_CHUNK_B = 100000
JOBS_KILL_AFTER = 2
# seeded faults on the column path: with 3 batches, the first reorders
# them and drops none; the second (swtpu's own test's) also drops 3
JOBS_FAULTS = (dict(seed=7, reorder_percent=100, drop_percent=40),
               dict(seed=7, reorder_percent=100, drop_percent=40, delay_ms_max=1))
JOBS_CLI_READS = (2000, 128)  # the CLI's library: reads and their length
JOBS_STREAMS_READS = 8192  # (b)'s first reads through score_streams
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # a Chrome trace's device events


def union_us(spans):
    """[(start, end)] -> [(start, end)] merged, sorted."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(spans, other):
    """µs of `spans` (merged) that `other` (merged) also covers."""
    return sum(max(0.0, min(b, d) - max(a, c)) for a, b in union_us(spans)
               for c, d in union_us(other))


HOST_STAGES = (("pack_streams", "jobs:pack"), ("pack_stream_wire", "jobs:wire"),
               ("sw_scores_stream_packed", "jobs:dispatch"),
               ("sw_scores_stream", "jobs:dispatch"))  # scorebank's names, marked


def profiled_call(run, tmp):
    """One call of run() under torch.profiler, with the stream path's host
    stages (pack_streams, pack_stream_wire, the pinned staging and the
    dispatch of each chunk's ops) marked as ranges: (device busy share of
    the wall, kernel launches, each wavefront kernel's span and how much of
    it ran while the host worked on a stage, the host stages' ms, wall ms,
    largest packed stream's bytes), from the exported Chrome trace, where
    host and device share one clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from swtpu_torch.bank import scorebank as bank_mod

    stream_bytes = []

    def marked(fn, label):
        def wrapped(*a, **kw):
            with record_function(label):
                out = fn(*a, **kw)
            if label == "jobs:pack":
                stream_bytes.append(out.stream.nbytes)
            return out
        return wrapped

    real = {name: getattr(bank_mod, name) for name, _ in HOST_STAGES}
    real_put = bank_mod._PinnedStager.put
    for name, label in HOST_STAGES:
        setattr(bank_mod, name, marked(real[name], label))
    bank_mod._PinnedStager.put = marked(real_put, "jobs:stage")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in real.items():
            setattr(bank_mod, name, fn)
        bank_mod._PinnedStager.put = real_put
    path = Path(tmp) / f"trace{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    path.unlink()
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        fail("jobs: the profiler recorded no kernel on the card")
    wave = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels
                  if "stream_wavefront" in e["name"])
    host = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("jobs:"):
            host.setdefault(e["name"][5:], []).append((e["ts"], e["ts"] + e["dur"]))
    every = [s for spans in host.values() for s in spans]
    busy = sum(b - a for a, b in union_us(device)) / 1e3
    return dict(busy_ms=busy, wall_ms=wall_ms, busy_share=busy / wall_ms,
                kernels=len(kernels), max_stream_bytes=max(stream_bytes),
                host_ms={k: sum(b - a for a, b in union_us(v)) / 1e3
                         for k, v in sorted(host.items())},
                wavefront_ms=[(b - a) / 1e3 for a, b in wave],
                wavefront_under_host_ms=[overlap_us([w], every) / 1e3 for w in wave])


def phase_jobs(card, main_cases, f_case):
    """The job layer through the user's entry points, each path's launch
    counters set to 0 just before it and read just after: the chunked
    dispatch at (a) and (b) (every score = the one-shot call's on all reads,
    the oracle's sample and top-10; three warm walls of each, interleaved;
    one profiled chunked and one-shot call: busy share, launches, and how
    much of each chunk's wavefront ran under the next chunk's packing),
    score_streams on (b)'s first reads, a resumable job at (a) killed after
    JOBS_KILL_AFTER chunks and rerun (only the rest scored, = the one-shot
    scores), seeded faults on (f)'s reads on the column path (= its
    score_database; both corruptions caught by the guards), and the CLI's
    score --resume (rerun: nothing scored again) and --profile (a trace with
    the wavefront in it), each = the CLI's oracle by its diff."""
    import tempfile

    import numpy as np
    from swtpu_torch import SWConfig, ScoreBank
    from swtpu_torch.bank import resume
    from swtpu_torch.bank import scorebank as bank_mod
    from swtpu_torch.bank.streams import score_streams
    from swtpu_torch.cli import main as cli
    from swtpu_torch.ops.column import column_chained_cuda, column_scores_cuda
    from swtpu_torch.testing.faults import FaultConfig, score_database_with_faults
    from swtpu_torch.utils.guards import IntegrityError

    t_phase = time.perf_counter()
    one = ScoreBank(device="cuda")
    out = dict(chunked=[])
    launches = {}
    tmpdir = tempfile.TemporaryDirectory()
    tmp = Path(tmpdir.name)
    try:
        for case, chunk in ((main_cases[0], JOBS_CHUNK_A), (main_cases[1], JOBS_CHUNK_B)):
            name = f"{case['name'][0]} jobs chunked"
            query, db = case["query"], case["db"]
            n = len(db.lens)
            n_chunks = -(-n // chunk)
            chunked = ScoreBank(SWConfig(stream_chunk_reads=chunk), device="cuda")
            runs = {"one_shot": lambda: one.score_database(query, db),
                    "chunked": lambda: chunked.score_database(query, db)}
            walls = {k: [] for k in runs}
            b1 = b3 = 0
            for rep in range(4):  # a warm call of each, then three timed, in turns
                for k, run in runs.items():
                    t0 = time.perf_counter()
                    res, (l1, l3) = launches_of(run)
                    wall = time.perf_counter() - t0
                    if rep:
                        walls[k].append(wall)
                    if k == "chunked":
                        b1, b3, got = b1 + l1, b3 + l3, res
                    else:
                        one_res = res
                    if not np.array_equal(res.scores, case["scores"]):
                        i = int(np.flatnonzero(res.scores != case["scores"])[0])
                        fail(f"{name}: {k} read {i} scored {res.scores[i]}, the one-shot "
                             f"call {case['scores'][i]}")
            if (b1, b3) != (4 * n_chunks, 0):
                fail(f"{name}: (wavefront, chained) launched ({b1}, {b3}) times in 4 calls, "
                     f"want ({4 * n_chunks}, 0)")
            if got.cells != case["cells"]:
                fail(f"{name}: cells {got.cells}, the one-shot call {case['cells']}")
            check_oracle(name, got, query, db, case["sample"], case["oracle"])
            prof = {k: profiled_call(run, tmp) for k, run in runs.items()}
            pc = prof["chunked"]
            if len(pc["wavefront_ms"]) != n_chunks:
                fail(f"{name}: the profiled call ran {len(pc['wavefront_ms'])} wavefront "
                     f"kernels, want {n_chunks}")
            med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
            row = dict(name=name, reads=n, chunk_reads=chunk, chunks=n_chunks,
                       cells=got.cells, padded_cells=got.padded_cells,
                       one_shot_padded_cells=one_res.padded_cells,
                       walls_ms={k: [w * 1e3 for w in v] for k, v in walls.items()},
                       median_ms=med, launches=[b1, b3],
                       profiled=prof)
            out["chunked"].append(row)
            launches[name] = [b1, b3]
            print(f"phase jobs: ok {name} reads={n} chunks={n_chunks} of {chunk} | every "
                  f"score = the one-shot call's, sample 2048 + top-10 = oracle | warm walls "
                  f"median of 3, in turns: chunked {med['chunked']:.2f} ms (runs "
                  f"{ms_list(walls['chunked'])}), one-shot {med['one_shot']:.2f} ms (runs "
                  f"{ms_list(walls['one_shot'])}) | launches wavefront={b1} in 4 calls | "
                  f"profiled: chunked {pc['wall_ms']:.2f} ms, {pc['busy_share']:.1%} busy, "
                  f"{pc['kernels']} kernels; one-shot {prof['one_shot']['wall_ms']:.2f} ms, "
                  f"{prof['one_shot']['busy_share']:.1%} busy, {prof['one_shot']['kernels']} "
                  f"kernels; chunked host stages ms "
                  + ", ".join(f"{k} {v:.2f}" for k, v in pc["host_ms"].items())
                  + " | each chunk's wavefront ms (of it while the host worked on a stage): "
                  + ", ".join(f"{w:.3f} ({h:.3f})" for w, h in zip(
                      pc["wavefront_ms"], pc["wavefront_under_host_ms"]))
                  + f" | largest packed stream {pc['max_stream_bytes'] / 1e6:.2f} MB, one-shot "
                  f"{prof['one_shot']['max_stream_bytes'] / 1e6:.2f} MB on {card}", flush=True)

        # score_streams: pack, the wavefront at rows 1 (B2's form), gather
        case = main_cases[1]
        reads = [case["db"].read(i) for i in range(JOBS_STREAMS_READS)]
        got, (b1, b3) = launches_of(lambda: score_streams(case["query"], reads,
                                                          n_streams=512, device="cuda"))
        if (b1, b3) != (1, 0) or not np.array_equal(got, case["scores"][:JOBS_STREAMS_READS]):
            fail(f"jobs score_streams: launches ({b1}, {b3}), scores = the bank's: "
                 f"{np.array_equal(got, case['scores'][:JOBS_STREAMS_READS])}")
        launches["jobs score_streams"] = [b1, b3]
        print(f"phase jobs: ok score_streams on {JOBS_STREAMS_READS} reads of "
              f"{case['name']} (512 streams, rows 1) = ScoreBank's scores | launches "
              f"wavefront={b1}", flush=True)

        # resume at (a): killed after JOBS_KILL_AFTER chunks, then rerun
        case = main_cases[0]
        query, db = case["query"], case["db"]
        state = tmp / "a_job.npz"
        # the entry each chunk's one-shot call goes through: the wire's on
        # the card
        entry = ("sw_scores_stream_packed" if one.config.wire_2bit
                 and one.device.type == "cuda" else "sw_scores_stream")
        real = getattr(bank_mod, entry)
        calls = {"n": 0}

        def killed(*a, **kw):
            calls["n"] += 1
            if calls["n"] > JOBS_KILL_AFTER:
                raise RuntimeError(f"killed after chunk {JOBS_KILL_AFTER}")
            return real(*a, **kw)

        def counted(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)

        setattr(bank_mod, entry, killed)
        try:
            resume.score_database_resumable(one, query, db, state, chunk_reads=JOBS_CHUNK_A)
            fail("jobs resume: the killed job ran to its end")
        except RuntimeError as e:
            if "killed after" not in str(e):
                raise
        finally:
            setattr(bank_mod, entry, real)
        n_chunks = -(-len(db.lens) // JOBS_CHUNK_A)
        done = np.load(state)["done"].tolist()
        if done != [True] * JOBS_KILL_AFTER + [False] * (n_chunks - JOBS_KILL_AFTER):
            fail(f"jobs resume: the killed job's state has done={done}")
        calls["n"] = 0
        setattr(bank_mod, entry, counted)
        try:
            t0 = time.perf_counter()
            res, (b1, b3) = launches_of(lambda: resume.score_database_resumable(
                one, query, db, state, chunk_reads=JOBS_CHUNK_A))
            rerun_s = time.perf_counter() - t0
        finally:
            setattr(bank_mod, entry, real)
        t0 = time.perf_counter()
        resume._fingerprint(query, db, one.config, extra=f"stream/{JOBS_CHUNK_A}")
        fingerprint_s = time.perf_counter() - t0
        left = n_chunks - JOBS_KILL_AFTER
        if (calls["n"], b1, b3) != (left, left, 0):
            fail(f"jobs resume: the rerun scored {calls['n']} chunks with ({b1}, {b3}) "
                 f"launches, want {left}")
        if not np.array_equal(res.scores, case["scores"]) or res.cells != case["cells"]:
            fail("jobs resume: the resumed scores or cells differ from the one-shot call's")
        launches["a jobs resume"] = [b1, b3]
        out["resume"] = dict(chunk_reads=JOBS_CHUNK_A, chunks=n_chunks,
                             killed_after=JOBS_KILL_AFTER, rerun_chunks=calls["n"],
                             rerun_ms=rerun_s * 1e3, fingerprint_ms=fingerprint_s * 1e3,
                             launches=[b1, b3])
        print(f"phase jobs: ok a jobs resume: {n_chunks} chunks of {JOBS_CHUNK_A}, killed "
              f"after {JOBS_KILL_AFTER}; the rerun scored {calls['n']} chunks "
              f"(launches wavefront={b1}) in {rerun_s * 1e3:.2f} ms (the job's fingerprint "
              f"alone {fingerprint_s * 1e3:.2f} ms), every score = the one-shot call's on "
              f"{card}", flush=True)

        # faults on (f)'s reads, the column path
        query, db = f_case["query"], f_case["db"]
        reads = db.as_list()
        pallas = ScoreBank(backend="pallas", device="cuda")
        want = pallas.score_database(query, db).scores
        runs = []
        column_scores_cuda.launches = column_chained_cuda.launches = 0
        for cfg in JOBS_FAULTS:
            t0 = time.perf_counter()
            scores, inj = score_database_with_faults(pallas, query, reads, FaultConfig(**cfg))
            runs.append(dict(config=cfg, ms=(time.perf_counter() - t0) * 1e3,
                             drops=inj.injected_drops, reorders=inj.injected_reorders))
            if not np.array_equal(scores, want):
                i = int(np.flatnonzero(scores != want)[0])
                fail(f"jobs faults {cfg}: read {i} scored {scores[i]}, score_database "
                     f"{want[i]}")
        b4, b5 = column_scores_cuda.launches, column_chained_cuda.launches
        if b4 < len(JOBS_FAULTS) or [r["reorders"] for r in runs] != [1, 1] or not runs[1]["drops"]:
            fail(f"jobs faults: B4 launched {b4} times; drops and reorders {runs}")
        launches["f jobs faults"] = [b4, b5]
        caught = {}
        guarded = ScoreBank(backend="pallas", device="cuda", verify_integrity=True)
        for kind in ("codes", "scores"):
            try:
                score_database_with_faults(guarded, query, reads, FaultConfig(
                    seed=7, corrupt_percent=100, corrupt_kind=kind))
                fail(f"jobs faults: a corrupted {kind} batch was not caught")
            except IntegrityError as e:
                caught[kind] = str(e)
        out["faults"] = dict(reads=len(reads), runs=runs, launches=[b4, b5], caught=caught)
        print(f"phase jobs: ok f jobs faults: {len(reads)} reads of {f_case['name']}: "
              + "; ".join(f"FaultConfig({r['config']}) {r['drops']} drops, {r['reorders']} "
                          f"reorders, {r['ms']:.2f} ms" for r in runs)
              + f"; launches column={b4}; every score = score_database's; corrupted codes "
              f"and scores caught: {caught}", flush=True)

        # the CLI on the card: score --resume twice, --profile, each = oracle
        fa, oracle = tmp / "lib.fa", tmp / "oracle.txt"
        n_reads, length = JOBS_CLI_READS
        rc = [cli(["generate", "-n", str(n_reads + 1), "-L", str(length), "-o", str(fa)]),
              cli(["oracle", "-q", str(fa), "-l", str(fa), "-o", str(oracle)])]
        cli_launches = []
        for k in range(2):
            got, (b1, b3) = launches_of(lambda: cli([
                "score", "-q", str(fa), "-l", str(fa), "-o", str(tmp / f"resume{k}.txt"),
                "--resume", str(tmp / "cli_job.npz")]))
            rc += [got, cli(["diff", str(tmp / f"resume{k}.txt"), str(oracle)])]
            cli_launches.append([b1, b3])
        prof_dir = tmp / "profile"
        got, (b1, b3) = launches_of(lambda: cli([
            "score", "-q", str(fa), "-l", str(fa), "-o", str(tmp / "profiled.txt"),
            "--profile", str(prof_dir)]))
        rc += [got, cli(["diff", str(tmp / "profiled.txt"), str(oracle)])]
        cli_launches.append([b1, b3])
        traces = list(prof_dir.glob("*.pt.trace.json"))
        names = {e.get("name", "") for t in traces
                 for e in json.loads(t.read_text())["traceEvents"] if e.get("cat") == "kernel"}
        if any(rc) or cli_launches != [[1, 0], [0, 0], [1, 0]] or len(traces) != 1 or not any(
                "stream_wavefront" in k for k in names):
            fail(f"jobs cli: exit codes {rc}, launches {cli_launches}, traces {traces}, "
                 f"kernels in the trace {sorted(names)[:5]}")
        launches["jobs cli"] = [sum(x[0] for x in cli_launches), 0]
        out["cli"] = dict(reads=n_reads, length=length, launches=cli_launches,
                          trace_kernels=sorted(names))
        print(f"phase jobs: ok cli: score --resume ({n_reads} reads x {length}) = oracle, "
              f"rerun adopted its state (no launch), score --profile wrote "
              f"{traces[0].name} with {len(names)} kernel names, the wavefront among them",
              flush=True)
    finally:
        tmpdir.cleanup()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase jobs: ok in {out['seconds']:.1f} s", flush=True)
    return out


# multi-device scoring on one card (phase "sharded"): a mesh of SHARDS
# shards that all lie on cuda:0, the counterpart of swtpu's virtual devices
SHARDS = 4
N_PAIRS = (4096, (24, 128), (24, 256))  # (n) on the column path: pairs, lengths
N_SCAN = (256, (8, 64), (8, 64))  # (n) on the scan: pairs, lengths
P_PROCS = 2  # (p)'s worker processes, all on cuda:0, joined over gloo
P_RUNS = (("plain", {}), ("kill", dict(kill_worker=1)), ("liar", dict(adversary_worker=1)))
SERVE_SHARDED_READS = (2000, 128)  # serve --sharded's library: reads and length


def phase_sharded(card, main_cases, long_cases, serving, seed):
    """Scoring across shards and processes through the user's entry points,
    each part's launch counters set to 0 just before it and read just after:
    (m) make_sharded_stream_scorer over (a)'s reads (SHARDS B1 a call) and
    (d)'s (SHARDS B3 chains of 2 tiles), every score = score_database's and the top-10 =
    its top_k(10), then its stages timed alone in turns with
    score_database; (n) make_sharded_topk on the column path (SHARDS B4 a
    call) and on the scan, = the oracle; (o) load_database_sharded over
    (k)'s reads, score_loaded_many_sharded, score_loaded_sharded and
    topk_loaded_sharded = the one-device resident answers of phase
    "serving", and the longest query's chain kernel on shard 0's stream
    held as resident_chain holds it; (p) run_multihost in database mode on (c)'s reads in
    P_PROCS processes on cuda:0 (plain, a worker killed, a lying worker),
    every score = (c)'s, each worker's B1 launches > 0, no process left;
    and the CLI's serve --sharded, its lines = serve's.  Walls: warm,
    median of 3, beside the one-device ones of earlier phases."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from swtpu_torch import SWConfig, ScoreBank
    from swtpu_torch.bank.scorebank import ScoreResult, stream_geometry
    from swtpu_torch.bank.streams import (
        _pack_shards, _stack_shards, pack_streams_sharded, scatter_sharded_scores,
    )
    from swtpu_torch.cli import main as cli
    from swtpu_torch.io.fasta import read_fasta
    from swtpu_torch.ops.column import column_chained_cuda, column_scores_cuda
    from swtpu_torch.ops.common import sentinel_pad_batch
    from swtpu_torch.oracle import sw_score_batch
    from swtpu_torch.parallel.mesh import make_mesh
    from swtpu_torch.parallel.sharded import make_sharded_stream_scorer, make_sharded_topk
    from swtpu_torch.testing.regress import run_multihost

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[torch.device("cuda:0")] * SHARDS)
    one_bank = ScoreBank(SWConfig(), device="cuda")
    out = dict(shards=SHARDS, m=[], n=[], o={}, p=[])
    launches = {}

    # (m): pack, score and scatter, a call at a time
    m_launched = np.zeros(2, np.int64)
    for case in (main_cases[0], long_cases[0]):
        name, query, db, want = case["name"], case["query"], case["db"], case["scores"]
        K = -(-len(query) // 128)
        segments, rows, phys = stream_geometry(len(query), SWConfig(), "cuda")
        stages = []

        def call():
            t0 = time.perf_counter()
            b = pack_streams_sharded(query, db, SHARDS, n_streams=phys * segments,
                                     segments=segments, rows=rows)
            t1 = time.perf_counter()
            scorer = make_sharded_stream_scorer(mesh, k=TOPK, segments=segments, rows=rows,
                                                emit_regular=b.emit_regular)
            s, top_s, top_ids = scorer(b.q, b.stream, b.emit_stream,
                                       b.emit_step.astype(np.int32), b.ids)
            scores = scatter_sharded_scores(s, b, len(db.lens))
            stages.append((t1 - t0, time.perf_counter() - t1))
            return scores, list(zip(top_s.tolist(), top_ids.tolist())), b.stream.shape

        (results, walls), launched = launches_of(lambda: walls_of(call))
        expect = (4 * SHARDS, 0) if K == 1 else (0, 4 * SHARDS)  # a B3 chain a shard
        if tuple(launched) != expect:
            fail(f"m {name}: (wavefront, chained) launched {launched} in 4 calls on "
                 f"{SHARDS} shards, want {expect}")
        top_want = ScoreResult(want, 0, 0, 1.0).top_k(TOPK)
        for scores, top, _ in results:
            if not np.array_equal(scores, want):
                k = int(np.flatnonzero(scores != want)[0])
                fail(f"m {name}: read {k} scored {scores[k]} sharded, {want[k]} by "
                     "score_database")
            if top != top_want:
                fail(f"m {name}: merged top-{TOPK} {top}, score_database's {top_want}")
        m_launched += launched
        wall = statistics.median(walls)
        pack = statistics.median(x[0] for x in stages[1:])
        rest = statistics.median(x[1] for x in stages[1:])
        shape = results[0][2]
        print(f"phase sharded: ok m {name} on {SHARDS} shards of cuda:0, streams "
              f"{list(shape)}: {len(want)} scores = score_database's, top-{TOPK} = its "
              f"top_k | launches wavefront={launched[0]} chained={launched[1]} in 4 calls | "
              f"wall median of 3 {wall*1e3:.2f} ms (runs {ms_list(walls)}; pack {pack*1e3:.2f}, "
              f"copy + kernels + merge + scatter {rest*1e3:.2f}) beside score_database's "
              f"{case['wall_s']*1e3:.2f} ms on {card}", flush=True)
        out["m"].append(dict(case=name, shards=SHARDS, shape=[int(x) for x in shape],
                             wall_ms=wall * 1e3, runs_ms=[w * 1e3 for w in walls],
                             pack_ms=pack * 1e3, rest_ms=rest * 1e3,
                             score_database_ms=case["wall_s"] * 1e3,
                             launches=[int(x) for x in launched]))

        # where the sharded call's time goes: its stages timed alone (the
        # four shard packs, the stack, the stacked stream's copy, then the
        # kernels, merge and scatter), in turns with one-device
        # score_database calls; a warm round, then medians of 3
        def staged():
            t0 = time.perf_counter()
            batches, groups = _pack_shards(query, db, SHARDS, phys * segments, segments, rows)
            t1 = time.perf_counter()
            b = _stack_shards(batches, groups, phys * segments, segments)
            t2 = time.perf_counter()
            stream = torch.from_numpy(b.stream).to("cuda:0")
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            scorer = make_sharded_stream_scorer(mesh, k=TOPK, segments=segments, rows=rows,
                                                emit_regular=b.emit_regular)
            s, _, _ = scorer(b.q, stream, b.emit_stream, b.emit_step.astype(np.int32), b.ids)
            scores = scatter_sharded_scores(s, b, len(db.lens))
            return scores, (t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3)

        stages, one_walls = [], []
        for _ in range(4):
            scores, st = staged()
            t0 = time.perf_counter()
            one = one_bank.score_database(query, db).scores
            one_walls.append(time.perf_counter() - t0)
            stages.append(st)
            if not (np.array_equal(scores, want) and np.array_equal(one, want)):
                fail(f"m {name}: the staged sharded call or score_database in turns "
                     "differs from score_database's scores")
        packs, stack, copy, rest = (statistics.median(x[i] for x in stages[1:])
                                    for i in range(4))
        one_wall = statistics.median(one_walls[1:])
        staged_walls = [sum(x) for x in stages[1:]]
        print(f"phase sharded: ok m {name} in turns with score_database, medians of 3: "
              f"4 shard packs {packs*1e3:.2f}, stack {stack*1e3:.2f}, copy of the "
              f"{int(np.prod(shape)) / 1e6:.2f} MB stream {copy*1e3:.2f}, kernels + merge + scatter "
              f"{rest*1e3:.2f} ms; staged wall {statistics.median(staged_walls)*1e3:.2f} ms "
              f"(runs {ms_list(staged_walls)}) | score_database {one_wall*1e3:.2f} ms (runs "
              f"{ms_list(one_walls[1:])}) on {card}", flush=True)
        out["m"][-1]["turns"] = dict(
            packs_ms=packs * 1e3, stack_ms=stack * 1e3, copy_ms=copy * 1e3, rest_ms=rest * 1e3,
            staged_runs_ms=[w * 1e3 for w in staged_walls],
            score_database_runs_ms=[w * 1e3 for w in one_walls[1:]])
    launches["m sharded"] = [int(x) for x in m_launched]

    # (n): the dense sharded top-k on the column path and on the scan
    rng = np.random.default_rng([seed, 9])
    col_total = np.zeros(2, np.int64)
    for backend, (count, qr, tr) in (("pallas", N_PAIRS), ("scan", N_SCAN)):
        ql = rng.integers(qr[0], qr[1] + 1, size=count)
        tl = rng.integers(tr[0], tr[1] + 1, size=count)
        q = rng.integers(0, 4, size=(count, qr[1])).astype(np.int8)
        t = rng.integers(0, 4, size=(count, tr[1])).astype(np.int8)
        t[1::97, : qr[1]] = q[1::97]  # some near-copies: ties at the top
        qp, tp = sentinel_pad_batch(q, ql, t, tl)
        ids = np.arange(count, dtype=np.int32)
        topk = make_sharded_topk(mesh, k=TOPK, backend=backend)
        column_scores_cuda.launches = column_chained_cuda.launches = 0
        (results, walls), stream_launched = launches_of(lambda: walls_of(lambda: [
            x.cpu().numpy() for x in topk(qp, tp, ids)]))
        col = (column_scores_cuda.launches, column_chained_cuda.launches)
        expect = (4 * SHARDS, 0) if backend == "pallas" else (0, 0)
        if col != expect or any(stream_launched):
            fail(f"n {backend}: column kernels launched {col}, wavefront {stream_launched} "
                 f"in 4 calls, want {expect}")
        t0 = time.perf_counter()
        want = sw_score_batch(q, t, ql, tl)
        oracle_s = time.perf_counter() - t0
        top_want = ScoreResult(want, 0, 0, 1.0).top_k(TOPK)
        for top_s, top_ids, scores in results:
            if not np.array_equal(scores, want) or list(zip(top_s.tolist(),
                                                            top_ids.tolist())) != top_want:
                fail(f"n {backend}: scores or top-{TOPK} differ from the oracle's")
        col_total += col
        wall = statistics.median(walls)
        print(f"phase sharded: ok n make_sharded_topk backend={backend} on {count} pairs "
              f"(queries {qr[0]}-{qr[1]}, targets {tr[0]}-{tr[1]}) over {SHARDS} shards: "
              f"scores and top-{TOPK} = the oracle's ({oracle_s:.1f} s) | B4 launches "
              f"{col[0]} in 4 calls | wall median of 3 {wall*1e3:.2f} ms (runs "
              f"{ms_list(walls)}) on {card}", flush=True)
        out["n"].append(dict(backend=backend, pairs=count, query_lens=list(qr),
                             target_lens=list(tr), wall_ms=wall * 1e3,
                             runs_ms=[w * 1e3 for w in walls], b4_launches=col[0]))
    out["column_launches"] = [int(x) for x in col_total]  # B4, B5

    # (o): (k)'s reads resident over the mesh
    k_in = serving[0].pop("_inputs")
    db, queries, wave, topk_one = k_in["db"], k_in["queries"], k_in["wave"], k_in["topk"]
    bank = ScoreBank(device="cuda")
    t0 = time.perf_counter()
    sdb, launched = launches_of(lambda: bank.load_database_sharded(db, mesh, max_query_len=256))
    load_s = time.perf_counter() - t0
    per_dispatch = SHARDS * dispatch_launches(queries)
    longest = max(queries, key=len)
    o_err, o_checks = resident_chain(f"o shard 0, query of {len(longest)} bases", longest,
                                     sdb.streams[0], sdb.rows)
    o_launched = np.zeros(2, np.int64)
    (waves, wave_walls), launched = launches_of(
        lambda: walls_of(lambda: bank.score_loaded_many_sharded(queries, sdb)))
    if list(launched) != (4 * per_dispatch).tolist():
        fail(f"o: score_loaded_many_sharded launched {launched}, want {4 * per_dispatch}")
    o_launched += launched
    for many in waves:
        for i, r in enumerate(many):
            if not np.array_equal(r.scores, wave[i]):
                fail(f"o: score_loaded_many_sharded of query {i} differs from score_loaded's")
    q_rows = []
    for i, q in enumerate(queries):
        (results, walls), launched = launches_of(
            lambda: walls_of(lambda: bank.score_loaded_sharded(q, sdb)))
        if list(launched) != (4 * SHARDS * dispatch_launches([q])).tolist():
            fail(f"o: score_loaded_sharded of query {i} ({len(q)} bases) launched {launched}")
        o_launched += launched
        if any(not np.array_equal(r.scores, wave[i]) for r in results):
            fail(f"o: score_loaded_sharded of query {i} differs from score_loaded's")
        q_rows.append(dict(qlen=len(q), ms=statistics.median(walls) * 1e3,
                           runs_ms=[w * 1e3 for w in walls],
                           one_device_ms=k_in["loaded_ms"][i]))
    top_rows = {}
    for i, want_top in topk_one.items():
        (results, walls), launched = launches_of(
            lambda: walls_of(lambda: bank.topk_loaded_sharded(queries[i], sdb, k=TOPK)))
        o_launched += launched
        if any(r != want_top for r in results):
            fail(f"o: topk_loaded_sharded of query {i} {results[0]}, topk_loaded's {want_top}")
        top_rows[i] = dict(qlen=len(queries[i]), ms=statistics.median(walls) * 1e3)
    launches["o sharded"] = [int(x) for x in o_launched]
    short = [r for r in q_rows if r["qlen"] <= 128]
    longer = [r for r in q_rows if r["qlen"] > 128]
    D, T, N = sdb.shape
    wave_s = statistics.median(wave_walls)
    print(f"phase sharded: ok o load_database_sharded of (k)'s {sdb.n_reads} reads over "
          f"{D} shards [{T}, {N}] each in {load_s*1e3:.2f} ms | score_loaded_many_sharded "
          f"(wave of {len(queries)}) median of 3 {wave_s*1e3:.2f} ms, score_loaded_sharded "
          f"median of 3: <= 128 bases {min(r['ms'] for r in short):.3f}-"
          f"{max(r['ms'] for r in short):.3f} ms (one device "
          f"{min(r['one_device_ms'] for r in short):.3f}-"
          f"{max(r['one_device_ms'] for r in short):.3f}), 129-256 bases "
          f"{min(r['ms'] for r in longer):.3f}-{max(r['ms'] for r in longer):.3f} ms (one "
          f"device {min(r['one_device_ms'] for r in longer):.3f}-"
          f"{max(r['one_device_ms'] for r in longer):.3f}); topk_loaded_sharded("
          f"{TOPK}) = topk_loaded's for queries {list(top_rows)} ("
          + ", ".join(f"{t['ms']:.3f}" for t in top_rows.values())
          + f" ms) | launches wavefront={o_launched[0]} chained={o_launched[1]} on {card}",
          flush=True)
    e, o_plain_ms, o_plain_on = resolve_plain(o_checks)
    if max(o_err, e):
        fail(f"o: the chain kernel on shard 0 differs by {max(o_err, e)}")
    print(f"phase sharded: ok o the {len(longest)}-base query's chain kernel on shard 0's "
          f"stream = the per-tile chain in full and the plain chain on its first "
          f"{CHECK_STEPS} steps ({o_plain_ms:.1f} ms on the {o_plain_on})", flush=True)
    out["o"] = dict(reads=sdb.n_reads, shape=[D, T, N], load_ms=load_s * 1e3,
                    wave_ms=wave_s * 1e3, wave_runs_ms=[w * 1e3 for w in wave_walls],
                    queries=q_rows, topk=top_rows, launches=launches["o sharded"],
                    chain_held=dict(qlen=len(longest), plain_ms=o_plain_ms,
                                    plain_on=o_plain_on))
    del sdb

    # (p): the localhost multi-process harness on the card
    c = main_cases[2]
    p_launched = np.zeros(2, np.int64)
    for label, kw in P_RUNS:
        t0 = time.perf_counter()
        res = run_multihost(c["query"], c["db"].mat, np.arange(len(c["db"].lens), dtype=np.int32),
                            nprocs=P_PROCS, topk=TOPK, mode="database", lens=c["db"].lens,
                            device="cuda", **kw)
        wall = time.perf_counter() - t0
        left = live_children()
        if left:
            fail(f"p {label}: processes still running after run_multihost: {left}")
        worker = {pid: [int(d["launches_wavefront"]), int(d["launches_chained"])]
                  for pid, d in res.worker_outputs.items()}
        if not np.array_equal(res.scores, c["scores"]):
            k = int(np.flatnonzero(res.scores != c["scores"])[0])
            fail(f"p {label}: read {k} scored {res.scores[k]}, score_database {c['scores'][k]}")
        top = list(zip(res.top_s.tolist(), res.top_ids.tolist()))
        if top != ScoreResult(c["scores"], 0, 0, 1.0).top_k(TOPK):
            fail(f"p {label}: merged top-{TOPK} {top}")
        if sorted(worker) != list(range(P_PROCS)) or any(w[0] <= 0 for w in worker.values()):
            fail(f"p {label}: workers' (wavefront, chained) launches {worker}")
        want = {"plain": (1, [], []), "kill": (2, [1], []), "liar": (1, [], [1])}[label]
        if (res.attempts, res.killed_pids, res.bad_shards) != want:
            fail(f"p {label}: attempts {res.attempts}, killed {res.killed_pids}, bad shards "
                 f"{res.bad_shards}")
        p_launched += np.sum(list(worker.values()), axis=0)
        print(f"phase sharded: ok p run_multihost {label}: {P_PROCS} processes on cuda:0 over "
              f"gloo, (c)'s {len(res.scores)} reads = score_database's, top-{TOPK} = its "
              f"top_k, attempts {res.attempts}, killed {res.killed_pids}, bad shards "
              f"{res.bad_shards}, workers' launches {worker} | wall {wall:.2f} s, no process "
              f"left on {card}", flush=True)
        out["p"].append(dict(run=label, wall_s=wall, attempts=res.attempts,
                             worker_launches=worker, bad_shards=res.bad_shards))
    launches["p sharded (workers)"] = [int(x) for x in p_launched]

    # serve --sharded through the CLI: the same lines as serve's
    n_reads, length = SERVE_SHARDED_READS
    with tempfile.TemporaryDirectory() as tmp:
        fa, cmds = Path(tmp) / "lib.fa", Path(tmp) / "cmds.txt"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli(["generate", "-n", str(n_reads + 1), "-L", str(length), "-o", str(fa)])
        seq = read_fasta(fa)[0].seq
        cmds.write_text(f"SEQ {seq}\nTOP {TOPK} {seq}\nQUIT\n")
        lines, serve_launched = {}, {}
        for flag in ("", "--sharded"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                got, serve_launched[flag] = launches_of(lambda: cli(
                    ["serve", "-l", str(fa), "--input", str(cmds), *([flag] if flag else [])]))
            rc = rc or got
            lines[flag] = [l.split("ns:", 1)[-1] for l in buf.getvalue().splitlines()]
    if rc or lines[""] != lines["--sharded"] or len(lines[""]) != n_reads + TOPK or any(
            list(x) != [2, 0] for x in serve_launched.values()):
        fail(f"serve --sharded: exit codes {rc}, {len(lines['--sharded'])} lines against "
             f"serve's {len(lines[''])}, launches {serve_launched}")
    launches["serve sharded"] = [int(x) for x in serve_launched["--sharded"]]
    print(f"phase sharded: ok serve --sharded ({n_reads} reads x {length}): SEQ and TOP "
          f"{TOPK} lines = serve's ({len(lines[''])} lines), one B1 a request", flush=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase sharded: ok in {out['seconds']:.1f} s", flush=True)
    return out


# the config-driven regression suites (phase "regress"): their files, the
# names swtpu reports SKIP when a suite turns multihost off, and the CLI
# subprocess's time limit
REGRESS_DEFAULT = "suites/default.json"
REGRESS_MULTIHOST = "suites/multihost.json"
REGRESS_SKIPS = ("multihost", "lying_device", "resume_cursor")
REGRESS_TIMEOUT_S = 300


def no_seconds(lines):
    """A suite report's lines without the summary's seconds."""
    import re

    return [re.sub(r"in \d+\.\ds$", "in s", line) for line in lines]


def phase_regress(card):
    """swtpu_torch.testing.suite through the user's entry points:
    suites/default.json in this process on cuda, then on cpu (the two
    outcome lists equal, each one passed or one of swtpu's skips, the
    stream corruptions caught on the card's wire path); then
    suites/multihost.json through main_cli on cuda with run_multihost
    wrapped to keep each worker's launch counts, and through `python -m
    swtpu_torch.cli regress` as a subprocess on the card in a session of
    its own, waited for or killed at REGRESS_TIMEOUT_S: 6 PASS lines, the
    lying worker's shard 1, both shards resumed, exit code 0, the same
    lines as main_cli's, and no process of its session left.  The workers'
    B1 launches are the path "regress (workers)"."""
    import contextlib
    import dataclasses
    import io
    from unittest import mock

    import numpy as np
    from swtpu_torch.ops.stream import stream_chain_cuda, stream_chained_cuda, stream_strip_cuda
    from swtpu_torch.testing import regress as regress_mod
    from swtpu_torch.testing.suite import main_cli, run_suite

    t_phase = time.perf_counter()
    out = dict(walls_s={})

    # the default suite on the card and on the CPU
    stream_strip_cuda.launches = stream_chain_cuda.launches = stream_chained_cuda.launches = 0
    rows = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        outcomes = run_suite(REPO / REGRESS_DEFAULT, device=device)
        out["walls_s"][f"default {device}"] = time.perf_counter() - t0
        rows[device] = [dataclasses.asdict(o) for o in outcomes]
        bad = [o for o in outcomes
               if not (o.passed and (not o.skipped or o.name in REGRESS_SKIPS))]
        if bad:
            fail(f"regress: {REGRESS_DEFAULT} on {device}: {bad}")
    in_process = [stream_strip_cuda.launches,
                  stream_chain_cuda.launches + stream_chained_cuda.launches]
    if rows["cuda"] != rows["cpu"]:
        fail(f"regress: {REGRESS_DEFAULT} on cuda {rows['cuda']}, on cpu {rows['cpu']}")
    stream = [r["detail"] for r in rows["cuda"] if r["name"] == "corruption_inject_stream"]
    if stream != ["stream codes: caught; stream scores: caught"] * 2:
        fail(f"regress: corruption_inject_stream on cuda: {stream}")
    print(f"phase regress: ok {REGRESS_DEFAULT}: {len(rows['cuda'])} outcomes on cuda = "
          f"cpu's ({sum(r['skipped'] for r in rows['cuda'])} skipped), corruption_inject_"
          f"stream caught on both datasets | wall cuda {out['walls_s']['default cuda']:.2f} "
          f"s, cpu {out['walls_s']['default cpu']:.2f} s on {card}", flush=True)

    # the multihost suite in this process, each run_multihost's workers' launches kept
    real_run = regress_mod.run_multihost
    runs = []

    def recording(*a, **kw):
        res = real_run(*a, **kw)
        runs.append(dict(mode=kw.get("mode", "pairs"), resumed=res.resumed_shards,
                         workers={pid: [int(d["launches_wavefront"]),
                                        int(d["launches_chained"])]
                                  for pid, d in res.worker_outputs.items()}))
        return res

    buf = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(regress_mod, "run_multihost", recording), \
            contextlib.redirect_stdout(buf):
        rc = main_cli(str(REPO / REGRESS_MULTIHOST), "cuda")
    out["walls_s"]["multihost cuda"] = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    left = live_children()
    if rc or left:
        fail(f"regress: main_cli({REGRESS_MULTIHOST}) exited {rc}, processes left {left}: "
             f"{lines}")
    workers = np.sum([w for r in runs for w in r["workers"].values()], axis=0)
    first_db = next((r for r in runs if r["mode"] == "database"), None)
    if first_db is None or sorted(first_db["workers"]) != [0, 1] or any(
            w[0] <= 0 for w in first_db["workers"].values()):
        fail(f"regress: the database-mode workers' (wavefront, chained) launches {runs}")
    print(f"phase regress: ok {REGRESS_MULTIHOST} through main_cli on cuda: "
          f"{len(runs)} run_multihost calls, workers' launches "
          f"{[r['workers'] for r in runs]} | wall {out['walls_s']['multihost cuda']:.2f} s "
          f"on {card}", flush=True)

    # the same suite through the CLI, a process of its own
    rc, cli_out, cli_err, out["walls_s"]["multihost cli"] = run_session(
        ["swtpu_torch.cli", "regress", "--suite", REGRESS_MULTIHOST], "regress: the CLI",
        REGRESS_TIMEOUT_S)
    cli_lines = cli_out.splitlines()
    passes = [l for l in cli_lines if l.startswith("PASS ")]
    if (rc or len(passes) != 6
            or "PASS ds-1 lying_device  (bad_shards=[1])" not in cli_lines
            or "PASS ds-1 resume_cursor  (rerun resumed shards [0, 1])" not in cli_lines
            or no_seconds(cli_lines) != no_seconds(lines) or live_children()):
        fail(f"regress: the CLI exited {rc}: {cli_lines} (main_cli's "
             f"{lines}); stderr {cli_err[-2000:]}")
    print(f"phase regress: ok python -m swtpu_torch.cli regress --suite {REGRESS_MULTIHOST}"
          f": {len(passes)} PASS, exit 0, lines = main_cli's, no process left | wall "
          f"{out['walls_s']['multihost cli']:.2f} s on {card}", flush=True)
    out.update(default=rows["cuda"], multihost_lines=cli_lines, runs=runs,
               in_process_launches=in_process,
               launches={"regress (workers)": [int(x) for x in workers]})
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase regress: ok in {out['seconds']:.1f} s (in-process launches wavefront="
          f"{in_process[0]} chained={in_process[1]}; workers' {workers.tolist()})",
          flush=True)
    return out


BENCH_TIMEOUT_S = 300  # each of the phase's subprocesses
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]  # swtpu's line, in its order
BENCH_METRIC = "GCUPS/chip (SW affine-gap scoring, 128x128)"
BENCH_AGREE = 0.10  # the headline against (a)'s cells over B1's float32 time
MULTIHOST_LINES = 8  # 3 counts x 2 modes, an efficiency line each


def start_session(argv):
    """`python -m <argv>` from the checkout in a session of its own, not
    waited for: its Popen, and the wall clock when it started."""
    import sys

    return subprocess.Popen([sys.executable, "-m", *argv], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True), time.perf_counter()


def finish_session(started, what, timeout=BENCH_TIMEOUT_S):
    """Waits for a start_session process, or kills its session at
    `timeout` s from its start; (exit code, stdout, stderr, wall s).  Fails
    if it was killed, or if a process of its session outlived it."""
    import os
    import signal

    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{what}: ran past {timeout} s and was killed")
    wall = time.perf_counter() - t0
    try:  # a process of its session (a worker) that outlived it
        os.killpg(proc.pid, 0)
        os.killpg(proc.pid, signal.SIGKILL)
        fail(f"{what}: a process of its session outlived it")
    except ProcessLookupError:
        pass
    return proc.returncode, out, err, wall


def run_session(argv, what, timeout=BENCH_TIMEOUT_S):
    """`python -m <argv>` from the checkout in a session of its own,
    waited for or killed at `timeout`; (exit code, stdout, stderr, wall s).
    Fails if it was killed, or if a process of its session outlived it."""
    return finish_session(start_session(argv), what, timeout)


def json_lines(what, out, n):
    """The n lines of `out`, each a JSON object with swtpu's four keys."""
    lines = out.splitlines()
    rows = []
    for line in lines:
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            fail(f"{what}: a stdout line is not JSON: {line!r}")
        if list(row) != BENCH_KEYS:
            fail(f"{what}: keys {list(row)}, not {BENCH_KEYS}")
        rows.append(row)
    if len(rows) != n:
        fail(f"{what}: {len(rows)} lines, not {n}: {lines}")
    return rows


def phase_bench(card):
    """swtpu's bench and bench_scaling on the card through the user's entry
    points.  `python -m swtpu_torch.cli bench` in a session of its own: exit
    code 0, the last stdout line swtpu's four keys with its metric and a
    value > 0, the stage lines on stderr only, no process left.  Then every
    stage of swtpu_torch.bench but `cpu` in this process, B1's and B4's
    launch counters set to 0 just before (the path "bench"; each stage
    holds every launch's window against the oracle).  Then `python -m
    swtpu_torch.bench_scaling` (a row a mesh size of the visible GPUs, the
    efficiency line past one) and `--multihost` (1, 2 and 4 gloo workers on
    the card, pairs and database mode, 8 lines), no process left."""
    import torch
    from swtpu_torch import bench
    from swtpu_torch.bench_scaling import MESH_SIZES
    from swtpu_torch.ops.column import column_scores_cuda
    from swtpu_torch.ops.stream import stream_chain_cuda, stream_chained_cuda, stream_strip_cuda

    t_phase = time.perf_counter()
    out = dict(walls_s={})
    rc, cli_out, cli_err, out["walls_s"]["cli bench"] = run_session(
        ["swtpu_torch.cli", "bench"], "bench: python -m swtpu_torch.cli bench")
    lines = cli_out.splitlines()
    stages = [l for l in cli_err.splitlines() if l.startswith("# stage ")]
    ok_stages = [l.split(":")[0][len("# stage "):] for l in stages if ": ok in " in l]
    if rc or not lines or ok_stages != list(bench.PLANS["cuda"]) or any(
            l.startswith("#") for l in lines):
        fail(f"bench: the CLI exited {rc}; stdout {lines}; stderr {cli_err[-3000:]}")
    line = json_lines("bench: the CLI's last line", lines[-1], 1)[0]
    # swtpu rounds the value to 0.1 and the ratio to 0.001, both from the
    # headline stage's unrounded number, which its stderr line gives
    g = float(re.search(r"'gcups': ([^,]+),", stages[-1]).group(1))
    if line["metric"] != BENCH_METRIC or line["unit"] != "GCUPS" or not g > 0 \
            or line["value"] != round(g, 1) or line["vs_baseline"] != round(g / 256.0, 3):
        fail(f"bench: the CLI's line {line}, its headline stage's {g} GCUPS")
    out["cli"] = dict(line=line, stages=stages, card=cli_err.splitlines()[0])
    print(f"phase bench: ok python -m swtpu_torch.cli bench: exit 0, {lines[-1]} | stages "
          f"{ok_stages} on stderr, no process left | wall {out['walls_s']['cli bench']:.2f} "
          f"s on {card}", flush=True)

    stream_strip_cuda.launches = stream_chain_cuda.launches = stream_chained_cuda.launches = 0
    column_scores_cuda.launches = 0
    out["stages"] = {}
    for name in bench.STAGES:
        if name == "cpu":
            continue
        t0 = time.perf_counter()
        res = bench.STAGES[name](torch.device("cuda"))
        out["walls_s"][name] = time.perf_counter() - t0
        out["stages"][name] = res
        print(f"phase bench: ok stage {name}: {res['gcups']:.1f} GCUPS (every launch's "
              f"window = the oracle) | " + ", ".join(
                  f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                  for k, v in res.items() if k != "gcups")
              + f" | {out['walls_s'][name]:.1f} s on {card}", flush=True)
    launches = [stream_strip_cuda.launches,
                stream_chain_cuda.launches + stream_chained_cuda.launches]
    out["column_launches"] = column_scores_cuda.launches
    if launches[0] == 0 or out["column_launches"] == 0:
        fail(f"bench: the stages launched the wavefront {launches[0]} and the column "
             f"kernel {out['column_launches']} times")
    out["launches"] = {"bench": launches}

    n_sizes = len([s for s in MESH_SIZES if s <= torch.cuda.device_count()])
    for args, n in ((["swtpu_torch.bench_scaling"], n_sizes + (n_sizes > 1)),
                    (["swtpu_torch.bench_scaling", "--multihost"], MULTIHOST_LINES)):
        what = "python -m " + " ".join(args)
        rc, sout, serr, wall = run_session(args, f"bench: {what}")
        if rc:
            fail(f"bench: {what} exited {rc}: {sout} {serr[-3000:]}")
        rows = json_lines(f"bench: {what}", sout, n)
        if any(r["unit"] == "reads/s" and not r["value"] > 0 for r in rows):
            fail(f"bench: {what}: {rows}")
        out["walls_s"][what] = wall
        out[what] = rows
        print(f"phase bench: ok {what}: {len(rows)} lines, exit 0, no process left | "
              + "; ".join(f"{r['metric']} {r['value']}" for r in rows)
              + f" | wall {wall:.2f} s on {card}", flush=True)
    if live_children():
        fail(f"bench: processes left {live_children()}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase bench: ok in {out['seconds']:.1f} s (launches wavefront={launches[0]} "
          f"column={out['column_launches']})", flush=True)
    return out


def check_bench_headline(bench, a_ms, card):
    """The bench headline (the in-process stream_chain stage's and the
    CLI's) within BENCH_AGREE of (a)'s cells over B1's float32 time at (a)
    in this run; the stage's cells must be (a)'s."""
    head = bench["stages"]["stream_chain"]
    cells = 262144 * 128 * 128  # (a): bench.py's headline shape
    if head["cells"] != cells or head["state_dtype"] != "float32":
        fail(f"bench: the headline stage ran {head['cells']} cells in {head['state_dtype']}")
    want = cells / (a_ms * 1e-3) / 1e9
    got = {"stage": head["gcups"], "cli": bench["cli"]["line"]["value"]}
    bad = {k: g for k, g in got.items() if abs(g / want - 1) > BENCH_AGREE}
    if bad:
        fail(f"bench: headline {got} GCUPS, not within {BENCH_AGREE:.0%} of (a)'s cells over "
             f"B1's float32 {a_ms:.4f} ms = {want:.1f}")
    bench["headline_check"] = dict(b1_float32_ms=a_ms, expected_gcups=want, **got)
    print(f"phase bench: ok headline {got['stage']:.1f} (stage), {got['cli']:.1f} (CLI) "
          f"GCUPS within {BENCH_AGREE:.0%} of {cells} cells / B1 float32 {a_ms:.4f} ms = "
          f"{want:.1f} on {card}", flush=True)


COLUMN_OUTS = ("h", "ms", "is_")  # a chained column tile's outputs
# the bucketed column path's cases beside (g), which reuses case (e):
# (name, reads or pairs, length range, query length or score width)
F_CASE = ("f_bucketed_q128", 262144, (24, 256), 128)  # buckets 32/128/512
H_CASE = ("h_pairs_w12", 65536, (24, 512), 12)  # the RTL's register width
SAMPLE = 2048  # reads of (f) held against the oracle
PAIR_SAMPLE = (128, 16)  # pairs of (h) held against the biased oracle: random, wrapping


def column_batch(rng, B, m, n):
    """[B, m] queries and [B, n] targets on the card, sentinel-padded
    ragged lengths (some zero), pair 0 identical over min(m, n) bases so
    that at score width 10 it wraps past 102 matches."""
    import numpy as np
    import torch
    from swtpu_torch.ops.common import Q_PAD, T_PAD

    q_lens = rng.integers(0, m + 1, size=B)
    t_lens = rng.integers(0, n + 1, size=B)
    q = rng.integers(0, 4, size=(B, m), dtype=np.int8)
    t = rng.integers(0, 4, size=(B, n), dtype=np.int8)
    k = min(m, n)
    t[0, :k] = q[0, :k]
    q_lens[0] = t_lens[0] = k
    q[np.arange(m)[None, :] >= q_lens[:, None]] = Q_PAD
    t[np.arange(n)[None, :] >= t_lens[:, None]] = T_PAD
    return torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()


def run_column_chain(q, t, width, tile, state_dtype="int32"):
    """The chained column path (``_chained_call``) in `state_dtype` with
    `tile` running each tile; returns its scores and every tile's (inputs,
    outputs)."""
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.column import _chained_call

    tiles = []

    def record(*args):
        outs = tile(*args)
        tiles.append((args, outs))
        return outs

    return _chained_call(q, t, DEFAULT_PENALTIES, width, tile=record,
                         state_dtype=state_dtype), tiles


def check_column_tiles(label, tiles, want_tiles) -> int:
    err = 0
    for p, ((_, outs), (_, wouts)) in enumerate(zip(tiles, want_tiles)):
        for name, g, w in zip(COLUMN_OUTS, outs, wouts):
            err = max(err, strip_error(f"{label} tile {p} {name}", g, w))
    return err


# the column kernels' state modes: (score width, state dtype); float32 and
# int16 carry the exact state, so their scores must also equal int32's
COLUMN_MODES = ((None, "int32"), (12, "int32"), (10, "int32"), (None, "float32"),
                (None, "int16"))
COLUMN_EXACT_STATES = ("float32", "int16")
# B4's query widths in phase 3: every geometry (lanes a pair in the one-value
# states, rows a lane in int16); 64 and 128 draw from a generator of their
# own, so the other widths' and the cases' data stay as they were
COLUMN_WIDTHS = (8, 32, 64, 128, 136, 256)
COLUMN_WIDTHS_OWN_RNG = (64, 128)
# the long-gap pairs (swtpu_torch/testing/gaps.py): query widths and modes
LONG_GAP_WIDTHS = (32, 128, 256)
LONG_GAP_MODES = ((None, "int32"), (12, "int32"), (None, "float32"))
# B5's long-gap chains (K = 2 and 3 tiles): cuts of 8-300 bases, each
# across a boundary between tiles; and small ragged batches of K = 2
# chains, so that a partly filled last block (4 pairs a block) runs too
CHAIN_GAP_CUT = (8, 300)
CHAIN_SMALL_BATCHES = (1, 33, 301)
# the one-value states of B5: (label, score width, state dtype)
B5_STATES = (("int32", None, "int32"), ("W=12", 12, "int32"), ("float32", None, "float32"))
# their operations a cell beside COLUMN_OPS: float32 unfuses the M update's
# and the I chain's add-max and gains nothing from A (its adds are apart:
# 3 more, the 11 of fp32_rates.CELLS); int16 none (its add wraps by itself,
# and its 16x2 add-max fuses as int32's)
COLUMN_EXTRA_OPS = {"float32": 3, "int16": 0}


def phase_column_vs_plain(rng, rng_odd, rng_gaps, B=4096, n=256):
    """B4 at each geometry (COLUMN_WIDTHS) and B5 over whole chains against
    their plain versions on B ragged pairs of n target columns, in each
    state mode; float32 and int16 also against the int32 kernel.  B4 on B
    long-gap pairs from `rng_gaps` (targets that are their queries with
    8-200 bases cut out, and self-pairs: the in-del chain crosses many
    lanes) at LONG_GAP_WIDTHS in LONG_GAP_MODES, the widths 64 and 128 from
    it too.  B5 on K = 2 and 3 chains of B long-gap pairs from `rng_gaps`
    (cuts of CHAIN_GAP_CUT bases across a tile boundary: the I seed
    crosses it, the lazy carry runs many lanes; self-pairs score 5 a base)
    and on small ragged batches (CHAIN_SMALL_BATCHES) in LONG_GAP_MODES,
    every tile's h/ms/is = its plain tile.  Then int16, two pairs a warp,
    at an odd B - 1 pairs from `rng_odd` (the last warp's high half dead):
    B4 at 2 and 8 rows a lane and a K = 2 chain."""
    import torch
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.column import (
        QUERY_TILE, column_chained_cuda, column_chained_reference,
        column_scores_cuda, column_scores_reference,
    )
    from swtpu_torch.testing.gaps import long_gap_pairs
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    scores, chains = [], []
    runs = ([(m, mode, False) for m in COLUMN_WIDTHS for mode in COLUMN_MODES]
            + [(m, mode, True) for m in LONG_GAP_WIDTHS for mode in LONG_GAP_MODES])
    for m, (width, dtype), long_gaps in runs:
        if long_gaps and (width, dtype) == LONG_GAP_MODES[0]:
            q, t = (torch.from_numpy(x).cuda() for x in long_gap_pairs(rng_gaps, B, m))
        elif not long_gaps and dtype == "int32":  # an exact state runs on the pairs of the mode before
            q, t = column_batch(rng_gaps if m in COLUMN_WIDTHS_OWN_RNG else rng, B, m, n)
        args = (q, t, DEFAULT_PENALTIES, width, dtype)
        got = column_scores_cuda(*args)
        want, plain_ms = cuda_once(lambda: column_scores_reference(*args))
        label = (f"column {'long gaps ' if long_gaps else ''}m={m} width={width}"
                 + (f" {dtype}" if dtype != "int32" else ""))
        err = strip_error(label, got, want)
        if dtype in COLUMN_EXACT_STATES:
            err = max(err, strip_error(label, got, column_scores_cuda(q, t), (dtype, "int32")))
        if long_gaps:  # every 8th pair is a query against itself: 5 a base
            err = max(err, strip_error(f"{label} self-pairs", got[::8],
                                       torch.full_like(got[::8], 5 * m), ("kernel", "5 m")))
        ms = cuda_ms(lambda: column_scores_cuda(*args), 10)
        print(f"phase kernel_vs_plain: ok {label} [{B} pairs, {t.shape[1]} columns] bit-equal"
              f"{' (= int32)' if dtype != 'int32' else ''} | kernel {ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms")
        scores.append(dict(m=m, n=t.shape[1], B=B, score_width=width, state_dtype=dtype,
                           long_gaps=long_gaps, max_abs_err=err, ms=ms, plain_ms=plain_ms))

    def chain(label, q, t, K, width, dtype, **rest):
        """A K-tile chain through B5 and through its plain tile: scores and
        every tile's h/ms/is equal (exact states also = int32's), timed."""
        got, tiles = run_column_chain(q, t, width, column_chained_cuda, dtype)
        (want, want_tiles), plain_ms = cuda_once(
            lambda: run_column_chain(q, t, width, column_chained_reference, dtype)
        )
        label += f" width={width}" + (f" {dtype}" if dtype != "int32" else "")
        err = max(strip_error(f"{label} scores", got, want),
                  check_column_tiles(label, tiles, want_tiles))
        if dtype in COLUMN_EXACT_STATES:
            exact, _ = run_column_chain(q, t, None, column_chained_cuda)
            err = max(err, strip_error(f"{label} scores", got, exact, (dtype, "int32")))
        ms = cuda_ms(lambda: run_column_chain(q, t, width, column_chained_cuda, dtype), 5)
        tile_ms = cuda_ms(lambda: column_chained_cuda(*tiles[0][0]), 10)
        (Bq, _), nq = q.shape, t.shape[1]
        print(f"phase kernel_vs_plain: ok {label} [{Bq} pairs, {nq} columns] "
              f"scores + h/ms/is of every tile bit-equal | chain {ms:.4f} ms "
              f"(kernel {tile_ms:.4f} ms per tile), plain chain {plain_ms:.1f} ms")
        chains.append(dict(tiles=K, n=nq, B=Bq, score_width=width, state_dtype=dtype,
                           max_abs_err=err, ms=ms, tile_ms=tile_ms, plain_ms=plain_ms,
                           **rest))
        return got

    for K in (2, 3):
        for width, dtype in ((None, "int32"), (10, "int32"), (None, "float32"),
                             (None, "int16")):
            if dtype == "int32":
                q, t = column_batch(rng, B, K * QUERY_TILE, n)
            chain(f"column chain K={K}", q, t, K, width, dtype)
    for K in (2, 3):
        m = K * QUERY_TILE
        q, t = (torch.from_numpy(x).cuda() for x in long_gap_pairs(
            rng_gaps, B, m, cut=CHAIN_GAP_CUT, across=QUERY_TILE))
        for width, dtype in LONG_GAP_MODES:
            label = f"column chain long gaps K={K}"
            got = chain(label, q, t, K, width, dtype, long_gaps=True)
            if width is None:  # every 8th pair a query against itself: 5 a base
                strip_error(f"{label} {dtype} self-pairs", got[::8],
                            torch.full_like(got[::8], 5 * m), ("kernel", "5 m"))
    for Bs in CHAIN_SMALL_BATCHES:
        q, t = column_batch(rng_gaps, Bs, 2 * QUERY_TILE, n)
        for width, dtype in LONG_GAP_MODES:
            chain(f"column chain K=2 small B={Bs}", q, t, 2, width, dtype)
    Bo = B - 1
    for m in (64, 256):
        q, t = column_batch(rng_odd, Bo, m, n)
        got = column_scores_cuda(q, t, state_dtype="int16")
        want, plain_ms = cuda_once(lambda: column_scores_reference(q, t, state_dtype="int16"))
        label = f"column m={m} int16 odd B"
        err = max(strip_error(label, got, want),
                  strip_error(label, got, column_scores_cuda(q, t), ("int16", "int32")))
        ms = cuda_ms(lambda: column_scores_cuda(q, t, state_dtype="int16"), 10)
        print(f"phase kernel_vs_plain: ok {label} [{Bo} pairs, {n} columns] bit-equal "
              f"(= int32) | kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
        scores.append(dict(m=m, n=n, B=Bo, score_width=None, state_dtype="int16",
                           max_abs_err=err, ms=ms, plain_ms=plain_ms))
    q, t = column_batch(rng_odd, Bo, 2 * QUERY_TILE, n)
    got, tiles = run_column_chain(q, t, None, column_chained_cuda, "int16")
    (want, want_tiles), plain_ms = cuda_once(
        lambda: run_column_chain(q, t, None, column_chained_reference, "int16"))
    label = "column chain K=2 int16 odd B"
    exact, _ = run_column_chain(q, t, None, column_chained_cuda)
    err = max(strip_error(f"{label} scores", got, want),
              check_column_tiles(label, tiles, want_tiles),
              strip_error(f"{label} scores", got, exact, ("int16", "int32")))
    ms = cuda_ms(lambda: run_column_chain(q, t, None, column_chained_cuda, "int16"), 5)
    print(f"phase kernel_vs_plain: ok {label} [{Bo} pairs, {n} columns] scores + h/ms/is of "
          f"every tile bit-equal (= int32) | chain {ms:.4f} ms, plain chain {plain_ms:.1f} ms")
    chains.append(dict(tiles=2, n=n, B=Bo, score_width=None, state_dtype="int16",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms))
    return scores, chains


def biased_oracle(pairs, width):
    """sw_score_single_biased on each (query, target) pair, spread over
    worker processes (the pure-Python oracle takes ~1 s a 450-base pair),
    each waited for (or killed) before this returns."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="swtpu_oracle_") as tmp:
        job = OracleJob(pairs, width, tmp, workers=8)
        try:
            return job.result()
        finally:
            job.kill()


def phase_bucketed_path(rng, card, case_e):
    """(f)-(h) through ScoreBank(backend="pallas", device="cuda")."""
    import numpy as np
    from swtpu_torch import SWConfig, ScoreBank, score_many_vs_one
    from swtpu_torch.ops.column import column_chained_cuda, column_scores_cuda

    bank = ScoreBank(SWConfig(), backend="pallas", device="cuda")
    cases = []

    def drive(name, run, ok_launches, want):
        """timed_runs of `run`, then (B4, B5) launches over its 4 calls
        must pass ok_launches; prints the case's line."""
        before = column_scores_cuda.launches, column_chained_cuda.launches
        res, wall, walls, peak = timed_runs(name, run)
        launched = (column_scores_cuda.launches - before[0],
                    column_chained_cuda.launches - before[1])
        if not ok_launches(*launched):
            fail(f"{name}: (B4, B5) launched {launched} times in 4 calls, want {want}")
        gcups = res.cells / wall / 1e9
        case = dict(name=name, wall_s=wall, gcups=gcups, cells=res.cells,
                    padded_cells=res.padded_cells, launches=launched, peak_gb=peak)
        line = (f"cells={res.cells} padded={res.padded_cells} launches "
                f"column={launched[0]} chained={launched[1]} peak device memory "
                f"{peak:.2f} GB | wall median of 3 {wall*1e3:.2f} ms (runs "
                f"{', '.join(f'{w*1e3:.2f}' for w in walls)}) -> {gcups:.2f} GCUPS "
                f"on {card}")
        return res, case, line

    # (f): three buckets (32, 128, 512) of SWConfig's ladder, one B4 each
    name, n, (lo, hi), qlen = F_CASE
    db = make_db(rng, n, lo, hi)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    res, case, line = drive(name, lambda: bank.score_database(query, db),
                            lambda b4, b5: (b4, b5) == (12, 0), "3 B4 per call")
    sample = np.sort(rng.choice(n, size=SAMPLE, replace=False))
    check_oracle(name, res, query, db, sample,
                 score_many_vs_one(query, [db.read(i) for i in sample]))
    print(f"phase main_path: ok {name} reads={n} sample {SAMPLE} + top-10 = "
          f"oracle | {line}", flush=True)
    cases.append(dict(case, query=query, db=db))

    # (g): case (e)'s reads and query on a B5 chain of two 256-row tiles
    name = "g_bucketed_q512"
    query, db = case_e["query"], case_e["db"]
    res, case, line = drive(name, lambda: bank.score_database(query, db),
                            lambda b4, b5: (b4, b5) == (0, 8), "2 B5 per call")
    if not np.array_equal(res.scores, case_e["scores"]):
        k = int(np.flatnonzero(res.scores != case_e["scores"])[0])
        fail(f"{name}: read {k} scored {res.scores[k]}, the stream path "
             f"{case_e['scores'][k]}")
    check_oracle(name, res, query, db, case_e["sample"], case_e["oracle"])
    print(f"phase main_path: ok {name} reads={len(db.lens)} all = case (e), its "
          f"oracle sample + top-10 = oracle | {line}", flush=True)
    cases.append(dict(case, query=query, db=db))

    # (h): pairs at the RTL's 12-bit width, 1 in 64 identical
    name, n, (lo, hi), width = H_CASE
    queries, targets = make_pairs(rng, n, lo, hi)
    wbank = ScoreBank(SWConfig(score_width=width), device="cuda")
    res, case, line = drive(name, lambda: wbank.score_pairs(queries, targets),
                            lambda b4, b5: min(b4, b5) >= 4, "both kernels")
    # an identical pair scores match x length exactly: past 2^(W-1) - 1 it wraps
    match = wbank.config.penalties.match
    wrapping = [i for i in range(0, n, 64) if match * len(queries[i]) >= 1 << (width - 1)]
    n_random, n_wrap = PAIR_SAMPLE
    picked = np.concatenate([
        rng.choice(n, size=n_random, replace=False),
        rng.choice(wrapping, size=n_wrap, replace=False),
    ])
    t0 = time.perf_counter()
    want = biased_oracle([(queries[i], targets[i]) for i in picked], width)
    oracle_s = time.perf_counter() - t0
    if res.scores[picked].tolist() != want:
        k = int(np.flatnonzero(res.scores[picked] != np.asarray(want))[0])
        fail(f"{name}: pair {picked[k]} scored {res.scores[picked[k]]}, biased "
             f"oracle {want[k]}")
    wrapped = sum(res.scores[i] < match * len(queries[i]) for i in picked[n_random:])
    if wrapped != n_wrap:
        fail(f"{name}: only {wrapped} of {n_wrap} identical pairs past the "
             f"{width}-bit ceiling wrapped")
    print(f"phase main_path: ok {name} pairs={n} score_width={width} {n_random} "
          f"sampled + {n_wrap} wrapping pairs = sw_score_single_biased "
          f"({oracle_s:.1f} s), all {n_wrap} wrapped | {line}", flush=True)
    cases.append(case)
    return bank, cases


def column_batches(bank, query, db):
    """A database's bucket batches as ScoreBank packs and pads them, on
    the card."""
    import torch
    from swtpu_torch.ops.column import T_CHUNK, pad_column_batch

    for b in bank._bucket_batches(query, db):
        yield pad_column_batch(torch.from_numpy(b.q).cuda(),
                               torch.from_numpy(b.t).cuda(), T_CHUNK)


def column_bound(peaks, B, m, n):
    """(least ms, what bounds it) of B4 on B pairs of m x n: the query and
    target read and the score written once, COLUMN_OPS a cell."""
    return peaks.bound(B * (m + n + 4), B * m * n * COLUMN_OPS)


def phase_column_at_main_shape(bank, f_case, g_case, e_chain_ms, peaks):
    """Every bucket batch of (f) through B4 and its plain version, and
    every tile of (g)'s chain through B5 and its plain version, in full
    (at W = 12 too); each B5 instantiation's registers, spills, resident
    blocks, tile times and share of its bound;
    kernel and plain times (a bucket's also from a CUDA graph of its calls:
    where the host's enqueue of a call outlasts the kernel, CUDA events
    around the calls time the host), each bucket's share of its bound and its
    instantiation's geometry, registers, spills and resident blocks; (g)'s
    chain against (e)'s stream chain."""
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.column import (
        column_chained_cuda, column_chained_reference, column_geometry, column_kernel_info,
        column_scores_cuda, column_scores_reference,
    )
    from swtpu_torch.utils.timing import cuda_ms, cuda_once, graph_ms

    batches = []
    for q, t in column_batches(bank, f_case["query"], f_case["db"]):
        (B, m), n = q.shape, t.shape[1]
        got = column_scores_cuda(q, t)
        want, plain_ms = cuda_once(lambda: column_scores_reference(q, t))
        err = strip_error(f"{f_case['name']} bucket {n}", got, want)
        ms = cuda_ms(lambda: column_scores_cuda(q, t), 5)
        device_ms = graph_ms(lambda: column_scores_cuda(q, t), 5)
        bound_ms, bound_by = column_bound(peaks, B, m, n)
        lanes, rows, pairs = column_geometry(m)
        regs, local, blocks = column_kernel_info(m)
        print(f"phase column_main_shape: ok {f_case['name']} bucket {n} [{B} pairs, "
              f"query {m}] bit-equal | kernel {ms:.4f} ms ({device_ms:.4f} ms in the kernel "
              f"itself) -> {B * m * n / ms / 1e6:.2f} padded GCUPS, bound {bound_ms:.4f} "
              f"ms ({bound_by}): {bound_ms / ms:.1%} ({bound_ms / device_ms:.1%} of the "
              f"kernel's own) | {lanes} lanes x {rows} rows a pair, {pairs} pairs a warp, "
              f"{regs} registers, {local} spill bytes, {blocks} blocks an SM | plain "
              f"{plain_ms:.1f} ms", flush=True)
        batches.append(dict(name=f_case["name"], B=B, m=m, n=n, max_abs_err=err,
                            ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, bound_share=bound_ms / ms,
                            device_bound_share=bound_ms / device_ms, lanes_per_pair=lanes,
                            rows_per_lane=rows, pairs_per_warp=pairs, registers=regs,
                            local_bytes=local, resident_blocks_per_sm=blocks))
    (q, t), = column_batches(bank, g_case["query"], g_case["db"])
    (B, m), n = q.shape, t.shape[1]
    _, tiles = run_column_chain(q, t, None, column_chained_cuda)
    err, ms, plain_ms = 0, [], []
    for p, (args, outs) in enumerate(tiles):
        want, t_plain = cuda_once(lambda: column_chained_reference(*args))
        err = max(err, check_column_tiles(f"{g_case['name']}", [(args, outs)],
                                          [(args, want)]))
        ms.append(cuda_ms(lambda: column_chained_cuda(*args), 5))
        plain_ms.append(t_plain)
    chain_ms = cuda_ms(lambda: run_column_chain(q, t, None, column_chained_cuda), 3)
    print(f"phase column_main_shape: ok {g_case['name']} tiles={len(tiles)} [{B} pairs, "
          f"{n} columns] h/ms/is of every tile bit-equal | chain {chain_ms:.3f} ms -> "
          f"{g_case['cells'] / chain_ms / 1e6:.2f} GCUPS in the chain "
          f"({chain_ms / (g_case['wall_s'] * 1e3):.1%} of the wall time); the "
          f"stream chain of case (e) on the same reads {e_chain_ms:.3f} ms | kernel "
          f"{', '.join(f'{x:.3f}' for x in ms)} ms, plain "
          f"{', '.join(f'{x:.1f}' for x in plain_ms)} ms per tile", flush=True)
    # each B5 instantiation (B4's template in tile mode, one state each):
    # its registers, spills, resident blocks, and its tiles at (g) beside
    # their bound with the state's operations; the W=12 tiles = the plain
    # ones in full (float32's are held in phase column_states)
    states = {}
    for label, width, dtype in B5_STATES:
        regs, local, blocks = column_kernel_info(state_dtype=dtype, score_width=width,
                                                 tile=True)
        s_tiles = tiles
        if label != "int32":
            _, s_tiles = run_column_chain(q, t, width, column_chained_cuda, dtype)
        if width is not None:
            for p, (args, outs) in enumerate(s_tiles):
                want = column_chained_reference(*args)
                err = max(err, check_column_tiles(f"{g_case['name']} {label}",
                                                  [(args, outs)], [(args, want)]))
        t_ms = ms if label == "int32" else [cuda_ms(lambda: column_chained_cuda(*args), 5)
                                            for args, _ in s_tiles]
        ops = COLUMN_OPS + (MODE_EXTRA_OPS["int32"] if width is not None
                            else COLUMN_EXTRA_OPS.get(dtype, 0))
        bound_ms, bound_by = peaks.bound(B * (256 + n + 8 + 16 * n), B * 256 * n * ops,
                                         cell_lanes("column", dtype, ops))
        states[label] = dict(registers=regs, local_bytes=local, ops=ops,
                             resident_blocks_per_sm=blocks, ms=t_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bound_share=bound_ms / statistics.median(t_ms))
        del s_tiles
    print(f"phase column_main_shape: ok {g_case['name']} B5 instantiations "
          f"(column_scores_kernel<32, state, tile>) | " + "; ".join(
              f"{k}: {v['registers']} registers, {v['local_bytes']} spill bytes, "
              f"{v['resident_blocks_per_sm']} blocks an SM, tiles "
              f"{', '.join(f'{x:.3f}' for x in v['ms'])} ms, bound {v['bound_ms']:.3f} ms "
              f"({v['bound_by']}, {v['ops']} ops a cell): {v['bound_share']:.1%}"
              for k, v in states.items()), flush=True)
    tile = dict(name=g_case["name"], tiles=len(tiles), B=B, n=n, max_abs_err=err,
                chain_ms=chain_ms, stream_chain_ms_e=e_chain_ms, ms=ms,
                plain_ms=plain_ms, instantiations=states)
    return batches, tile


def phase_column_states(bank, f_case, g_case):
    """The column kernels' exact float32 and int16 states at the main
    shapes, through sw_scores_column(state_dtype=...), the entry that takes
    them (ScoreBank keeps int32, as swtpu's does): every bucket batch of
    (f) and (g)'s chain, each path's launch counters set to 0 just before
    it and read just after; every score equal to the int32 kernel's, every
    (g) tile's h/ms/is too.  B4 at each bucket and B5 at each tile timed
    beside int32; the plain version in each state at (f)'s largest bucket
    and on (g)'s tile 0, bit-equal to the kernel."""
    from swtpu_torch.ops.column import (
        column_chained_cuda, column_chained_reference, column_kernel_info,
        column_scores_cuda, column_scores_reference, sw_scores_column,
    )
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    batches = list(column_batches(bank, f_case["query"], f_case["db"]))
    exact = [column_scores_cuda(q, t) for q, t in batches]
    f = dict(name=f_case["name"], buckets=[t.shape[1] for _, t in batches], modes={})
    (gq, gt), = column_batches(bank, g_case["query"], g_case["db"])
    g_exact, g_tiles = run_column_chain(gq, gt, None, column_chained_cuda)
    g = dict(name=g_case["name"], tiles=len(g_tiles), modes={})
    err = 0
    for dtype in COLUMN_EXACT_STATES:
        column_scores_cuda.launches = column_chained_cuda.launches = 0
        got = [sw_scores_column(q, t, state_dtype=dtype) for q, t in batches]
        launched = column_scores_cuda.launches, column_chained_cuda.launches
        if launched != (len(batches), 0):
            fail(f"{f['name']} {dtype}: (B4, B5) launched {launched} times, want "
                 f"({len(batches)}, 0)")
        for (q, t), x, w in zip(batches, got, exact):
            err = max(err, strip_error(f"{f['name']} {dtype} bucket {t.shape[1]}", x, w,
                                       (dtype, "int32")))
        q, t = batches[-1]
        want, plain_ms = cuda_once(lambda: column_scores_reference(q, t, state_dtype=dtype))
        err = max(err, strip_error(f"{f['name']} {dtype} bucket {t.shape[1]}", got[-1], want))
        f["modes"][dtype] = dict(
            launches=launched[0], plain_ms=plain_ms,
            registers=column_kernel_info(q.shape[1], dtype)[0], ms=[
                cuda_ms(lambda: column_scores_cuda(q, t, state_dtype=dtype), 5)
                for q, t in batches])
        del got

        column_scores_cuda.launches = column_chained_cuda.launches = 0
        scores = sw_scores_column(gq, gt, state_dtype=dtype)
        launched = column_scores_cuda.launches, column_chained_cuda.launches
        if launched != (0, len(g_tiles)):
            fail(f"{g['name']} {dtype}: (B4, B5) launched {launched} times, want "
                 f"(0, {len(g_tiles)})")
        err = max(err, strip_error(f"{g['name']} {dtype} scores", scores, g_exact,
                                   (dtype, "int32")))
        _, tiles = run_column_chain(gq, gt, None, column_chained_cuda, dtype)
        for p, ((_, outs), (_, wouts)) in enumerate(zip(tiles, g_tiles)):
            for name, x, w in zip(COLUMN_OUTS, outs, wouts):
                err = max(err, strip_error(f"{g['name']} {dtype} tile {p} {name}", x, w,
                                           (dtype, "int32")))
        args, outs = tiles[0]
        want, plain_ms = cuda_once(lambda: column_chained_reference(*args))
        err = max(err, check_column_tiles(f"{g['name']} {dtype}", [(args, outs)],
                                          [(args, want)]))
        g["modes"][dtype] = dict(
            launches=launched[1], plain_ms=plain_ms,
            registers=column_kernel_info(state_dtype=dtype, tile=True)[0],
            ms=[cuda_ms(lambda: column_chained_cuda(*a), 5) for a, _ in tiles])
        del tiles, outs, want
    f["int32_ms"] = [cuda_ms(lambda: column_scores_cuda(q, t), 5) for q, t in batches]
    g["int32_ms"] = [cuda_ms(lambda: column_chained_cuda(*a), 5) for a, _ in g_tiles]
    f["int32_registers"] = column_kernel_info(batches[-1][0].shape[1])[0]
    g["int32_registers"] = column_kernel_info(tile=True)[0]
    f["max_abs_err"] = g["max_abs_err"] = err
    for c, what in ((f, "bucket"), (g, "tile")):
        print(f"phase column_states: ok {c['name']} float32 and int16 = int32 (every score"
              f"{', and h/ms/is of every tile' if c is g else ''}), = the plain version at "
              f"{'the largest bucket' if c is f else 'tile 0'} | kernel per {what} int32 "
              f"{', '.join(f'{x:.3f}' for x in c['int32_ms'])} ms; " + "; ".join(
                  f"{k} {', '.join(f'{x:.3f}' for x in v['ms'])} ms (plain "
                  f"{v['plain_ms']:.1f} ms, launches {v['launches']})"
                  for k, v in c["modes"].items()), flush=True)
    return f, g


# phase "ladders": the top of SWConfig's length ladders (target_buckets to
# 2,048 bases, query_buckets to 4,096; the RTL's 4,095-base LEN_WIDTH
# envelope).  (q): (name, reads, read length, query length, a window of the
# query every so many reads); (r): (name, reads, read lengths, query
# length), all in the 2,048 bucket; (s): (name, distinct queries, targets
# each, query lengths, target lengths, a window of its query every so many
# targets, the windows' least length: 820 x 5 passes the 12-bit ceiling)
LADDER_Q = ("q_ladder_q4095", 65536, 128, 4095, 1024)
LADDER_R = ("r_ladder_reads2048", 16384, (513, 2048), 128)
LADDER_S = ("s_ladder_pairs_w12", 16, 64, (2049, 4095), (513, 2048), 16, 820)
LADDER_WIDTH = 12
LADDER_SAMPLE = 64  # random reads of (q) and (r) held against the oracle
LADDER_PAIRS = (8, 4)  # pairs of (s) held against the biased oracle: smallest, windows
LADDER_B3_TILES = (0, 15, 31)  # (q)'s per-tile B3 tiles timed alone
LADDER_CLI_READS = 4096  # (q)'s first reads through the CLI
LADDER_LOAD = 4096  # (t): load_database's max_query_len
LADDER_KERNELS = ("B1", "B3", "B4", "B5")

ORACLE_WORKER = """\
import json, sys
import numpy as np
from chip_smoke import pair_oracle
from swtpu_torch.config import DEFAULT_PENALTIES
from swtpu_torch.oracle import sw_score_single, sw_score_single_biased
with open(sys.argv[1]) as f:
    width, per_pair, pairs = json.load(f)
qs, ts = zip(*([np.frombuffer(s.encode(), np.uint8) - ord("0") for s in p] for p in pairs))
if width:
    out = [sw_score_single_biased(q, t, penalties=DEFAULT_PENALTIES, score_width=width)
           for q, t in zip(qs, ts)]
elif per_pair:
    out = [sw_score_single(q, t, DEFAULT_PENALTIES) for q, t in zip(qs, ts)]
else:
    out = pair_oracle(qs, ts, range(len(qs))).tolist()
print(json.dumps(out))
"""


class OracleJob:
    """The oracle of (query, target) pairs in worker processes started now
    and read by `result()`, so that the card's work can go on meanwhile:
    sw_score_single_biased a pair at `width`, else the exact batch oracle
    (pair_oracle, one worker: its loop runs over the cells of the longest
    pair whatever the batch), or with `per_pair` sw_score_single a pair
    (its loop runs over each pair's own cells).  The workers are plain subprocesses (a
    multiprocessing pool would also start a resource tracker process,
    which some Python releases leave running past the script's end);
    `kill()` ends any still running."""

    def __init__(self, pairs, width, tmp, workers=1, per_pair=False):
        import os
        import sys

        self.n, self.procs = len(pairs), []
        self.workers = max(1, min(workers, (os.cpu_count() or 1) - 1, len(pairs)))
        for k in range(self.workers):
            path = Path(tmp) / f"oracle_{id(self)}_{k}.json"
            path.write_text(json.dumps([width, per_pair, [
                ["".join(map(str, s.tolist())) for s in pair]
                for pair in pairs[k :: self.workers]]]))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", ORACLE_WORKER, str(path)], cwd=REPO,
                stdout=subprocess.PIPE, text=True))

    def result(self):
        outs = [p.communicate()[0] for p in self.procs]
        if any(p.returncode for p in self.procs):
            fail(f"oracle workers exited {[p.returncode for p in self.procs]}")
        scores = [json.loads(o) for o in outs]
        return [scores[i % self.workers][i // self.workers] for i in range(self.n)]

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def host_peak_mb(run):
    """(run(), the peak of the host memory it allocated through Python and
    numpy, MB; tracemalloc)."""
    import tracemalloc

    tracemalloc.start()
    try:
        out = run()
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return out, peak / 1e6


def phase_ladders(rng, card, peaks):
    """The top of swtpu's length ladders through the user's entry points,
    every check exact: (q) a 4,095-base query against 65,536 reads of 128
    bases (every 1,024th a window of the query) through score_database on
    the stream backend in int32 and float32 (a B3 chain of 32 tiles, one
    launch, a call) and on the column path (16 B5 tiles), all scores
    equal, the oracle on 64 sampled reads, the windows and the top-10; the
    chain kernel against the per-tile chain in full and the plain chain on
    its first CHECK_STEPS steps (hold_chain: every tile of the per-tile
    chain against the plain tile, fed the kernel's own strips from the tile
    above), every B5 tile against its plain tile in full.  (r) 16,384
    reads of 513-2,048 bases (the 2,048 bucket) against a
    128-base query: one B1 a stream call, one B4 a column call, equal, the
    oracle on 64 reads and the top-10, B4 in full and B1 on its first
    CHECK_STEPS steps against their plain versions.  (s) score_pairs at
    score width 12 on 1,024 pairs (16 queries of 2,049-4,095 bases, 64
    targets each of 513-2,048, every 16th a window of its query of at
    least 820 bases, which wraps): the stream backend's 16 biased B3 chains
    (a launch each; the longest query's held as (q)'s is, its plain chain
    on the streams that hold its reads and as many of pads, in full)
    = the column path's biased B5 chain on every pair, and
    sw_score_single_biased on the 8 smallest pairs and 4 windows; the same
    pairs exact on ScoreBank(device="cuda") (the default backend, int32
    B3) = the exact column path on every pair, the windows = 5 x their
    length times the match score, sw_score_single on the same 12 pairs.  On both, the stream
    backend's 16 jobs run side by side: each job's chain and span from its
    CUDA events, the call's device span beside the 383 tiles' padded and
    live bounds, the overlap (the jobs' spans summed over the device span)
    and the CUDA streams the jobs ran on (fewer than 2 fails).  (t)
    load_database(max_query_len=4096) on (q)'s reads: score_loaded = (q)'s
    scores on every read, topk_loaded(10) = its top_k(10).  The CLI's score
    in a session of its own on (q)'s query and first 4,096 reads: its lines
    = the bank's scores.  Each case's warm wall (median of 3), its kernels'
    times a tile beside their bounds, peak device memory; the launches of
    B1, B3, B4 and B5 over the phase's entry points ("ladders").  The
    oracles run in worker processes from the start and the CLI beside the
    plain versions; every kernel is timed before either starts."""
    import os
    import signal
    import tempfile

    import numpy as np
    import torch
    from swtpu_torch import DEFAULT_PENALTIES, SWConfig, ScoreBank
    from swtpu_torch.bank.scorebank import stream_geometry
    from swtpu_torch.bank.streams import STREAM_PAD, pack_streams_long
    from swtpu_torch.io.encode import decode_seq
    from swtpu_torch.io.fasta import FastaRecord, write_fasta
    from swtpu_torch.ops.column import (
        T_CHUNK, _chained_call, column_chained_cuda, column_chained_reference,
        column_scores_cuda, column_scores_reference, pad_column_batch,
    )
    from swtpu_torch.ops.stream import (
        _long_strip, stream_chained_cuda, stream_strip_cuda, wavefront_geometry,
    )
    from swtpu_torch.testing.goldens import _RTL_LINE
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    out = dict(cases={}, kernels={}, launches=dict.fromkeys(LADDER_KERNELS, 0))
    n = CHECK_STEPS
    plain = plain_jobs()
    jobs, cli = {}, None
    tmp = tempfile.TemporaryDirectory(prefix="swtpu_ladders_")

    def drive(name, run, want):
        """timed_runs of `run` with the four kernels' launch counters at 0
        just before; over its 4 calls they must have launched 4 x `want`
        (B1, B3, B4, B5) times.  (result, the case's record)."""
        (res, wall, walls, peak), launched = launches_of(lambda: timed_runs(name, run), column=True)
        if launched != tuple(4 * x for x in want):
            fail(f"{name}: (B1, B3, B4, B5) launched {launched} times in 4 calls, want "
                 f"4 x {want}")
        for k, x in zip(LADDER_KERNELS, launched):
            out["launches"][k] += x
        case = dict(wall_s=wall, walls_s=walls, peak_gb=peak, launches=launched,
                    cells=res.cells, padded_cells=res.padded_cells,
                    gcups=res.cells / wall / 1e9)
        out["cases"][name] = case
        print(f"phase ladders: ok {name} cells={res.cells} padded={res.padded_cells} "
              f"launches (B1, B3, B4, B5) {launched} in 4 calls, peak device memory "
              f"{peak:.2f} GB | wall median of 3 {wall*1e3:.2f} ms (runs "
              f"{', '.join(f'{w*1e3:.2f}' for w in walls)}) -> {case['gcups']:.2f} GCUPS "
              f"on {card}", flush=True)
        return res

    def kernel_row(key, ms, bound, live, skips=False, **rest):
        """A kernel's time beside its bound over the launch's padded shape
        and over its live cells alone, the share `live` of them: the bound
        is linear in the cells, so that one is bound x live.  A kernel
        that `skips` the streams with no read (B3's chain) needs only the
        live cells: its bound_ms is the live bound, the padded one a side
        field (padded_bound_ms, padded_share)."""
        b_live = bound[0] * live
        b = b_live if skips else bound[0]
        out["kernels"][key] = dict(ms=ms, bound_ms=b, bound_by=bound[1], bound_share=b / ms,
                                   live_fraction=live, live_bound_ms=b_live,
                                   live_share=b_live / ms, padded_bound_ms=bound[0],
                                   padded_share=bound[0] / ms, **rest)
        padded = f"bound {bound[0]:.3f} ms ({bound[1]}): {bound[0] / ms:.1%}"
        over = f"over the live cells ({live:.1%} of them) {b_live:.3f} ms: {b_live / ms:.1%}"
        if skips:
            return f"{ms:.3f} ms, bound {over}; over the padded shape {padded}"
        return f"{ms:.3f} ms, {padded}; {over}"

    def stream_live(sk, drain):
        """The share of a [T, N] strip's stream-steps that hold a read, or
        the drain after a stream's last read (reads lie back to back)."""
        fill = (torch.as_tensor(sk) != STREAM_PAD).sum(0)
        return float((fill + drain * (fill > 0)).sum()) / sk.numel()

    def b3_bound(T, N, extra=0):
        return peaks.bound(128 * N + T * N * (1 + 12 + 16),
                           128 * T * N * (WAVEFRONT_OPS + extra))

    def b5_bound(B, nt, extra=0):
        return peaks.bound(B * (256 + nt + 8 + 16 * nt), B * 256 * nt * (COLUMN_OPS + extra))

    def side_by_side(label, key, bank, queries, targets, extra, want):
        """One more score_pairs call of `bank` on (s), traced: a CUDA event
        on a job's stream just before and just after its dispatch
        (bank._dispatch_long wrapped: the job's span, from its copy in to
        its scores' copy back) and on the launching stream just before and
        just after each B3 launch (stream_chain_cuda wrapped, as
        experiments/torch_chain_b3.py wraps it).  Its scores must be
        `want`, and its B3 launches one a job (its chain).  Prints each job's chain
        (its first launch's start to its last launch's end) and span, the
        call's device span (the first job's start to the last job's end:
        copies, unpacks, shifts and gaps included), the overlap (the jobs'
        spans summed over the device span), the distinct CUDA streams (fewer
        than 2 for more than one job fails) and the host's dispatch a job.
        The kernel row `key`: B3's busy time, the union of its launches'
        intervals, against the sum over the jobs of K tiles x B3's bound on
        the live cells of the job's own strip, each job packed as the bank
        packs it (the padded bound beside it)."""
        from swtpu_torch.ops import stream as st

        real_tile, dispatch, jobs = st.stream_chain_cuda, bank._dispatch_long, []

        def event(stream=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            return ev

        def dispatch_long(*a, stream=None, **kw):
            t0 = time.perf_counter()
            job = dict(stream=stream, start=event(stream), marks=[])
            jobs.append(job)
            got = dispatch(*a, stream=stream, **kw)
            job.update(end=event(stream), host_ms=(time.perf_counter() - t0) * 1e3)
            return got

        def tile(*a, **kw):
            """stream_chain_cuda between two events; the wrapper counts its
            launch on this function, which takes its name in the module."""
            before = event()
            got = real_tile(*a, **kw)
            jobs[-1]["marks"].append((before, event()))
            return got

        tile.launches = 0
        bank._dispatch_long, st.stream_chain_cuda = dispatch_long, tile
        torch.cuda.synchronize()
        try:
            res = bank.score_pairs(queries, targets)
            torch.cuda.synchronize()
        finally:
            del bank._dispatch_long
            st.stream_chain_cuda = real_tile
            real_tile.launches += tile.launches
        first_difference(f"{label} traced call: pair", res.scores, want, "the timed calls")
        ref = jobs[0]["start"]
        spans = [(ref.elapsed_time(j["start"]), ref.elapsed_time(j["end"])) for j in jobs]
        span_ms = max(e for _, e in spans) - min(s for s, _ in spans)
        chain = [j["marks"][0][0].elapsed_time(j["marks"][-1][1]) for j in jobs]
        launches = [(ref.elapsed_time(x), ref.elapsed_time(y))
                    for j in jobs for x, y in j["marks"]]
        busy = union_ms(launches)
        streams = len({j["stream"].cuda_stream for j in jobs})
        if len(jobs) > 1 and streams < 2:
            fail(f"{label}: {len(jobs)} jobs ran on {streams} CUDA stream(s)")
        overlap = sum(e - s for s, e in spans) / span_ms
        bound = live_bound = tiles = 0
        owner = [q.tobytes() for q in queries]
        for key_q, q in {k: q for k, q in zip(owner, queries)}.items():
            _, rows, phys = stream_geometry(len(q), bank.config, bank.device)
            lb = pack_streams_long(q, [t for k, t in zip(owner, targets) if k == key_q],
                                   n_streams=phys, rows=rows)
            K = lb.q.shape[1] // 128
            N, T = lb.stream.shape
            b = b3_bound(T, N, extra)
            bound += K * b[0]
            live_bound += K * b[0] * stream_live(torch.from_numpy(lb.stream).T,
                                                 128 // rows - 1)
            tiles += K
        if tile.launches != len(jobs):
            fail(f"{label} traced call: {tile.launches} B3 launches for {len(jobs)} jobs "
                 f"({tiles} tiles)")
        peak = out["cases"][f"{label} stream"]["peak_gb"]
        host = [j["host_ms"] for j in jobs]
        line = kernel_row(key, busy, (bound, b[1]), live_bound / bound, True, jobs=len(jobs),
                          tiles=tiles, streams=streams, overlap=overlap,
                          device_span_ms=span_ms, launch_sum_ms=sum(y - x for x, y in launches),
                          job_chain_ms=chain, job_span_ms=[e - s for s, e in spans],
                          job_dispatch_ms=host, peak_gb=peak)
        print(f"phase ladders: ok {label} side by side: {len(jobs)} jobs on {streams} CUDA "
              f"streams, {tiles} B3 tiles in {tile.launches} chain launches | B3 busy (the "
              f"union of its launches' intervals) "
              f"{line}; job chains {', '.join(f'{x:.3f}' for x in chain)} ms (sum "
              f"{sum(chain):.2f}); the call's device span {span_ms:.3f} ms (copies, unpacks, "
              f"shifts and gaps too); overlap {overlap:.2f} (the jobs' spans summed over "
              f"the span); the host's dispatch {', '.join(f'{x:.2f}' for x in host)} ms a "
              f"job (sum {sum(host):.2f}); peak device memory {peak:.2f} GB", flush=True)

    try:
        # every case's data, and the oracle of the samples that do not
        # depend on a result, started now
        name_q, n_reads, L, qlen, every = LADDER_Q
        db = make_db(rng, n_reads, L, L)
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        windows = np.arange(0, n_reads, every)
        for r, off in zip(windows, rng.integers(0, qlen - L + 1, size=len(windows))):
            db.mat[r] = query[off : off + L]
        sample = np.unique(np.concatenate([
            rng.choice(n_reads, size=LADDER_SAMPLE, replace=False), windows]))
        name_r, n_r, (lo, hi), rlen = LADDER_R
        rdb = make_db(rng, n_r, lo, hi)
        rquery = rng.integers(0, 4, size=rlen).astype(np.int8)
        r_sample = np.sort(rng.choice(n_r, size=LADDER_SAMPLE, replace=False))
        name_s, nq, per, qr, tr, self_every, least = LADDER_S
        queries, targets = query_pairs(rng, nq, per, qr, tr, self_every, (least, tr[1]))
        is_window = np.array([len(t) >= least and t.tobytes() in q.tobytes()
                              for q, t in zip(queries, targets)])
        if is_window.sum() != nq * per // self_every:
            fail(f"{name_s}: {is_window.sum()} targets are windows of their query, want "
                 f"{nq * per // self_every}")
        n_small, n_win = LADDER_PAIRS
        order = np.argsort([len(q) * len(t) for q, t in zip(queries, targets)], kind="stable")
        picked = np.concatenate([order[~is_window[order]][:n_small],
                                 order[is_window[order]][:n_win]])
        jobs["q"] = OracleJob([(query, db.read(i)) for i in sample], None, tmp.name)
        jobs["r"] = OracleJob([(rquery, rdb.read(i)) for i in r_sample], None, tmp.name)
        jobs["s"] = OracleJob([(queries[i], targets[i]) for i in picked], LADDER_WIDTH,
                              tmp.name, workers=5)

        # (q): the 4,095-base query, 32 B3 tiles and 16 B5 tiles a call
        name = name_q
        K, Kc = -(-qlen // 128), -(-qlen // 256)
        q_res = {}
        for state in ("int32", "float32"):
            bank = ScoreBank(SWConfig(stream_state_dtype=state), backend="stream",
                             device="cuda")
            q_res[state] = drive(f"{name} stream {state}",
                                 lambda: bank.score_database(query, db), (0, 1, 0, 0))
        cbank = ScoreBank(backend="pallas", device="cuda")
        col = drive(f"{name} column", lambda: cbank.score_database(query, db), (0, 0, 0, Kc))
        for state, res in q_res.items():
            first_difference(f"{name} stream {state}: read", res.scores, col.scores,
                             "the column path")
        top = q_res["int32"].top_k(10)
        q_top = np.array(sorted({i for _, i in top} - set(sample.tolist())), np.int64)
        if len(q_top):
            jobs["q top"] = OracleJob([(query, db.read(i)) for i in q_top], None, tmp.name)

        # (q)'s chains: every B5 tile and B3 tiles 0, 15, 31 run and timed
        (pb,), host_mb = host_peak_mb(lambda: cbank._bucket_batches(query, db))
        cq, ct = pad_column_batch(torch.from_numpy(pb.q).cuda(),
                                  torch.from_numpy(pb.t).cuda(), T_CHUNK)
        c_live = pb.cells / (cq.numel() * ct.shape[1])
        del pb
        _, c_tiles = run_column_chain(cq, ct, None, column_chained_cuda)
        b5_ms = [cuda_ms(lambda: column_chained_cuda(*args), 3) for args, _ in c_tiles]
        c_chain_ms = cuda_ms(lambda: _chained_call(cq, ct, DEFAULT_PENALTIES, None), 3)
        B5shape = ct.shape
        del cq, ct
        _, rows, phys = stream_geometry(qlen, SWConfig(), "cuda")
        qd, sk = long_batch(query, db, rows, phys)
        _, s_tiles = run_chain(qd, sk, rows, stream_chained_cuda, keep=LADDER_B3_TILES)
        slices = stream_chained_cuda.slices
        b3_ms = [cuda_ms(lambda: stream_chained_cuda(*args), 3) for args, _ in s_tiles]
        _, q_chain_err, q_chain_checks = hold_chain(f"{name} B3", qd, sk, rows)
        s_chain_ms = cuda_ms(lambda: _long_strip(qd, sk, DEFAULT_PENALTIES, rows), 3)
        s_tiles_chain_ms = cuda_ms(lambda: _long_strip(qd, sk, DEFAULT_PENALTIES, rows,
                                                       tile=stream_chained_cuda), 3)
        T, N = sk.shape
        q_facts = chain_facts(rows, T, K)
        s_live = stream_live(sk, 128 // rows - 1)
        del qd

        # the CLI in a session of its own beside the plain versions: (q)'s
        # query and its first reads
        qfa, lfa, cli_out = (Path(tmp.name) / f for f in ("q.fa", "lib.fa", "out.txt"))
        write_fasta(qfa, [FastaRecord("query_ladder", decode_seq(query))])
        write_fasta(lfa, [FastaRecord(db.names[i], decode_seq(db.read(i)))
                          for i in range(LADDER_CLI_READS)])
        cli = start_session(["swtpu_torch.cli", "score", "-q", str(qfa), "-l", str(lfa),
                             "-o", str(cli_out)])

        err, b5_plain = 0, []
        for p, (args, outs) in enumerate(c_tiles):
            want, t_plain = cuda_once(lambda: column_chained_reference(*args))
            for nm, g, w in zip(COLUMN_OUTS, outs, want):
                err = max(err, strip_error(f"{name} B5 tile {p} {nm}", g, w))
            b5_plain.append(t_plain)
        del c_tiles, want
        B, nt = B5shape
        line = kernel_row("B5 q", statistics.median(b5_ms), b5_bound(B, nt), c_live,
                          plain_ms=statistics.median(b5_plain), tiles=len(b5_ms), B=B, n=nt,
                          tile_ms=b5_ms, chain_ms=c_chain_ms, max_abs_err=err,
                          host_pack_mb=host_mb, plain_tile_ms=b5_plain)
        print(f"phase ladders: ok {name} B5 [{B} pairs, {Kc * 256} query rows, {nt} "
              f"columns]: h/ms/is of all {len(b5_ms)} tiles bit-equal to the plain tiles | "
              f"a tile (median) {line}; chain {c_chain_ms:.3f} ms; plain "
              f"{statistics.median(b5_plain):.1f} ms a tile | pack_many_vs_one's host "
              f"peak {host_mb:.1f} MB (the query shipped once a read)", flush=True)
        del s_tiles, sk
        shift_ms = (s_tiles_chain_ms - K * statistics.mean(b3_ms)) / (K - 1)
        q_b3 = dict(T=T, N=N, rows=rows, live=s_live, tile_ms=b3_ms, tile_slices=slices,
                    per_tile_chain_ms=s_tiles_chain_ms, shift_ms=shift_ms)
        print(f"phase ladders: ok {name} B3 rows={rows} strips [{T}, {N}], {K} tiles a "
              f"launch each in {slices} slices (every tile held against the plain tile on "
              f"its held steps, the chain's first {n}, with the chain kernel, below) | tiles "
              f"{', '.join(map(str, LADDER_B3_TILES))} (median) "
              f"{statistics.median(b3_ms):.3f} ms; chain of a launch a tile "
              f"{s_tiles_chain_ms:.3f} ms ({shift_ms:.3f} ms a boundary beyond the tiles); "
              f"the chain kernel {s_chain_ms:.3f} ms", flush=True)

        # (r): reads in the 2,048 bucket against a 128-base query
        name = name_r
        sbank = ScoreBank(device="cuda")
        r_res = drive(f"{name} stream", lambda: sbank.score_database(rquery, rdb),
                      (1, 0, 0, 0))
        r_col = drive(f"{name} column", lambda: cbank.score_database(rquery, rdb),
                      (0, 0, 1, 0))
        first_difference(f"{name} stream: read", r_res.scores, r_col.scores, "the column path")
        r_top = np.array(sorted({i for _, i in r_res.top_k(10)} - set(r_sample.tolist())),
                         np.int64)
        if len(r_top):
            jobs["r top"] = OracleJob([(rquery, rdb.read(i)) for i in r_top], None, tmp.name)
        (pb,), host_mb = host_peak_mb(lambda: cbank._bucket_batches(rquery, rdb))
        bq, bt = pad_column_batch(torch.from_numpy(pb.q).cuda(),
                                  torch.from_numpy(pb.t).cuda(), T_CHUNK)
        c_live = pb.cells / (bq.numel() * bt.shape[1])
        del pb
        b4_ms = cuda_ms(lambda: column_scores_cuda(bq, bt), 5)
        seg, rows, phys = stream_geometry(rlen, sbank.config, sbank.device)
        qk, sk = laid_out_batch(rquery, rdb, seg, rows, phys)
        r_longest = int(rdb.lens.max())  # the slices the bank's call takes
        b1_ms = cuda_ms(lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows,
                                                  longest_read=r_longest), 10)
        slices = stream_strip_cuda.slices
        b1_one = cuda_ms(
            lambda: stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows, slices=1), 3)
        got = column_scores_cuda(bq, bt)
        want, t_plain = cuda_once(lambda: column_scores_reference(bq, bt))
        err = strip_error(f"{name} B4 bucket {bt.shape[1]}", got, want)
        (B, m), nb = bq.shape, bt.shape[1]
        line = kernel_row("B4 r", b4_ms, column_bound(peaks, B, m, nb), c_live,
                          plain_ms=t_plain, B=B, m=m, n=nb, max_abs_err=err,
                          host_pack_mb=host_mb)
        print(f"phase ladders: ok {name} B4 [{B} pairs, query {m}, {nb} columns] bit-equal "
              f"to the plain version in full | kernel {line}; plain {t_plain:.1f} ms | "
              f"pack_many_vs_one's host peak {host_mb:.1f} MB", flush=True)
        del bq, bt, got, want
        got = stream_strip_cuda(qk, sk, DEFAULT_PENALTIES, seg, rows, longest_read=r_longest)
        cut = sk[:n].contiguous()
        err, t_plain, where = plain.check(
            "stream_strip_reference", (qk, cut, DEFAULT_PENALTIES, seg, rows),
            [(f"{name} B1 first {n} steps", 0, got[:n]),
             (f"{name} B1 first {n} steps in {CUT_SLICES} slices", 0,
              stream_strip_cuda(qk, cut, DEFAULT_PENALTIES, seg, rows, slices=CUT_SLICES))],
        ).result()
        T, N = sk.shape
        line = kernel_row("B1 r", b1_ms,
                          peaks.bound(128 * N + T * N * 5, 128 * T * N * WAVEFRONT_OPS),
                          stream_live(sk, 128 // (rows * seg) - 1), plain_ms=t_plain, T=T,
                          N=N, segments=seg, rows=rows, slices=slices,
                          lanes_a_stream=wavefront_geometry(rows, seg).lanes,
                          sublanes_a_thread=wavefront_geometry(rows, seg).sublanes,
                          longest_read=r_longest, ms_one_slice=b1_one, check_steps=n,
                          max_abs_err=err, plain_on=where)
        print(f"phase ladders: ok {name} B1 seg={seg} rows={rows} strip [{T}, {N}] in "
              f"{slices} slices: bit-equal to the plain version on the first {n} steps (the "
              f"full run's, and the cut in {CUT_SLICES} slices) | kernel {line}; in one "
              f"slice {b1_one:.3f} ms; plain {t_plain:.1f} ms on {n} steps (on the {where})",
              flush=True)
        del qk, sk, got, cut

        # (s): pairs at the RTL's 12-bit width and exact, queries to 4,095
        # bases; the stream backend's jobs side by side
        name = name_s
        distinct = {q.tobytes(): q for q in queries}
        Ks = sum(-(-len(q) // 128) for q in distinct.values())
        wcfg = SWConfig(score_width=LADDER_WIDTH)
        wbank = ScoreBank(wcfg, backend="stream", device="cuda")
        s_res = drive(f"{name} stream", lambda: wbank.score_pairs(queries, targets),
                      (0, len(distinct), 0, 0))  # a B3 chain a job
        side_by_side(name, "B3 s side by side", wbank, queries, targets,
                     MODE_EXTRA_OPS["int32"], s_res.scores)
        ebank = ScoreBank(device="cuda")
        if ebank.backend != "stream":
            fail(f"{name}: ScoreBank(device='cuda') took the {ebank.backend} backend")
        name_e = f"{name} exact"
        e_res = drive(f"{name_e} stream", lambda: ebank.score_pairs(queries, targets),
                      (0, len(distinct), 0, 0))
        side_by_side(name_e, "B3 s exact side by side", ebank, queries, targets, 0,
                     e_res.scores)
        e_tiles = sum(-(-g.q.shape[1] // 256) for g in cbank._pair_batches(queries, targets))
        e_col = drive(f"{name_e} column", lambda: cbank.score_pairs(queries, targets),
                      (0, 0, 0, e_tiles))
        first_difference(f"{name_e} stream: pair", e_res.scores, e_col.scores,
                         "the column path")
        windows_e = np.flatnonzero(is_window)
        first_difference(f"{name_e} stream: window", e_res.scores[windows_e],
                         [ebank.config.penalties.match * len(targets[i]) for i in windows_e],
                         "the match score x its length", at=windows_e)
        # started after the timed calls, whose walls the host's packing
        # holds, when the oracles started with the phase have ended
        jobs["s exact"] = OracleJob([(queries[i], targets[i]) for i in picked], None,
                                    tmp.name, workers=len(picked), per_pair=True)
        wcol = ScoreBank(wcfg, device="cuda")
        groups = list(wcol._pair_batches(queries, targets))
        s_col = drive(f"{name} column", lambda: wcol.score_pairs(queries, targets),
                      (0, 0, 0, sum(-(-g.q.shape[1] // 256) for g in groups)))
        first_difference(f"{name} stream: pair", s_res.scores, s_col.scores,
                         "the column path")
        match = wcfg.penalties.match
        wrapped = [i for i in np.flatnonzero(is_window)
                   if s_res.scores[i] != match * len(targets[i])]
        if len(wrapped) != is_window.sum():
            fail(f"{name}: {len(wrapped)} of {is_window.sum()} windows past the "
                 f"{LADDER_WIDTH}-bit ceiling wrapped")
        # the biased kernels a tile: the column group's chain, the longest
        # query's stream chain
        g = max(groups, key=lambda g: g.q.shape[0] * g.t.shape[1])
        gq, gt = pad_column_batch(torch.from_numpy(g.q).cuda(), torch.from_numpy(g.t).cuda(),
                                  T_CHUNK)
        Kg = gq.shape[1] // 256
        chain_ms = cuda_ms(lambda: _chained_call(gq, gt, DEFAULT_PENALTIES, LADDER_WIDTH), 3)
        B, nt = gt.shape
        b5_line = kernel_row("B5 s", chain_ms / Kg,
                             b5_bound(B, nt, MODE_EXTRA_OPS["int32"]),
                             g.cells / (gq.numel() * nt), tiles=Kg, B=B, n=nt,
                             chain_ms=chain_ms, groups=len(groups))
        longest = max(distinct.values(), key=len)
        own = [t for q, t in zip(queries, targets) if q.tobytes() == longest.tobytes()]
        _, rows, phys = stream_geometry(len(longest), wcfg, "cuda")
        lb = pack_streams_long(longest, own, n_streams=phys, rows=rows)
        lq = torch.from_numpy(lb.q).cuda()
        lsk = torch.from_numpy(lb.stream.T.copy()).cuda()
        Kl = lq.shape[1] // 128
        # the plain chain on the streams that hold the job's reads (the
        # greedy packer's first ones) and as many of pads
        live = int((lsk != STREAM_PAD).any(0).nonzero().max()) + 1
        held = slice(0, min(lsk.shape[1], 2 * live))
        _, s_chain_err, s_chain_checks = hold_chain(f"{name} B3 longest job", lq, lsk, rows,
                                                    streams=held, score_width=LADDER_WIDTH)
        chain_ms = cuda_ms(lambda: _long_strip(lq, lsk, DEFAULT_PENALTIES, rows,
                                               score_width=LADDER_WIDTH), 3)
        tiles_chain_ms = cuda_ms(lambda: _long_strip(lq, lsk, DEFAULT_PENALTIES, rows,
                                                     tile=stream_chained_cuda,
                                                     score_width=LADDER_WIDTH), 3)
        T, N = lsk.shape
        s_b3 = dict(T=T, N=N, K=Kl, live=stream_live(lsk, 128 // rows - 1), reads=len(own),
                    plain_streams=held.stop,
                    per_tile_chain_ms=tiles_chain_ms, chain_ms=chain_ms,
                    facts=chain_facts(rows, T, Kl, score_width=LADDER_WIDTH))
        print(f"phase ladders: ok {name} at W={LADDER_WIDTH}: {len(groups)} column group(s) "
              f"({', '.join(f'{x.q.shape[1]} x {x.t.shape[1]}' for x in groups)}), "
              f"{len(distinct)} stream jobs of {Ks} B3 tiles; every pair = the column path; "
              f"all {is_window.sum()} windows wrapped | biased B5 a tile (the group's chain "
              f"/ {Kg}) {b5_line}; the biased B3 chain kernel {chain_ms:.3f} ms (the "
              f"{len(longest)}-base query's {Kl} tiles over its {len(own)} reads, T {T}; "
              f"= the per-tile chain, {tiles_chain_ms:.3f} ms, in full; its plain check "
              f"below)", flush=True)
        del gq, gt, lq, lsk

        # (t): (q)'s reads resident for a 4,096-base query
        name = "t_ladder_loaded4096"
        bank = ScoreBank(device="cuda")
        loaded, launched = launches_of(
            lambda: bank.load_database(db, max_query_len=LADDER_LOAD), column=True)
        if launched != (0, 0, 0, 0) or loaded.k_max != -(-LADDER_LOAD // 128):
            fail(f"{name}: load launched {launched}, k_max {loaded.k_max}")
        t_res = drive(name, lambda: bank.score_loaded(query, loaded), (0, 1, 0, 0))
        first_difference(f"{name}: read", t_res.scores, q_res["int32"].scores,
                         "score_database")
        tops, launched = launches_of(
            lambda: walls_of(lambda: bank.topk_loaded(query, loaded, 10)), column=True)
        if launched != (0, 4, 0, 0):  # a B3 chain a call
            fail(f"{name}: topk_loaded launched (B1, B3, B4, B5) {launched} in 4 calls")
        for k, x in zip(LADDER_KERNELS, launched):
            out["launches"][k] += x
        if any(t != top for t in tops[0]):
            fail(f"{name}: topk_loaded(10) {tops[0][0]} vs top_k(10) {top}")
        out["cases"][name].update(load_s=loaded.load_s, T=int(loaded.stream.shape[0]),
                                  topk_walls_s=tops[1],
                                  topk_wall_s=statistics.median(tops[1]))
        print(f"phase ladders: ok {name} load_database(max_query_len={LADDER_LOAD}): k_max "
              f"{loaded.k_max}, stream [{loaded.stream.shape[0]}, {loaded.stream.shape[1]}], "
              "load " + ", ".join(f"{k} {v*1e3:.2f} ms" for k, v in loaded.load_s.items())
              + f" | score_loaded = score_database on all {n_reads} reads, topk_loaded(10) "
              f"= its top_k(10) (median of 3 {statistics.median(tops[1])*1e3:.2f} ms)",
              flush=True)
        del loaded

        rc, _, err_text, wall = finish_session(cli, "ladders: the CLI")
        cli = None
        lines = [_RTL_LINE.search(x) for x in cli_out.read_text().splitlines()] if rc == 0 else []
        got = {m.group(1): int(m.group(2)) for m in lines if m}
        want = {db.names[i]: int(q_res["int32"].scores[i]) for i in range(LADDER_CLI_READS)}
        if rc or got != want:
            bad = next((k for k in want if got.get(k) != want[k]), None)
            fail(f"ladders: the CLI exited {rc}, {len(got)} score lines; first "
                 f"difference {bad}: {got.get(bad)} vs {want.get(bad)}; "
                 f"{err_text.strip()[-400:]}")
        out["cli"] = dict(reads=LADDER_CLI_READS, wall_s=wall)
        print(f"phase ladders: ok the CLI's score in a session of its own: "
              f"{LADDER_CLI_READS} score lines = the bank's ({wall:.1f} s with the "
              f"interpreter's start)", flush=True)

        # the chain kernel's rows: its plain chains, computed meanwhile
        t0 = time.perf_counter()
        e, q_plain_ms, q_plain_on = resolve_plain(q_chain_checks)
        K, (T, N) = -(-qlen // 128), (q_b3["T"], q_b3["N"])
        b = b3_bound(T, N)
        line = kernel_row("B3 q", s_chain_ms, (K * b[0], b[1]), q_b3["live"], True,
                          plain_ms=q_plain_ms, plain_on=q_plain_on, tiles=K, T=T, N=N,
                          rows=q_b3["rows"], chain=q_facts, check_steps=min(n, T),
                          max_abs_err=max(q_chain_err, e),
                          per_tile_chain_ms=q_b3["per_tile_chain_ms"], tile_ms=q_b3["tile_ms"],
                          tile_slices=q_b3["tile_slices"], shift_ms=q_b3["shift_ms"],
                          timed_tiles=list(LADDER_B3_TILES))
        print(f"phase ladders: ok {name_q} B3 chain kernel [{T}, {N}], {K} tiles in one "
              f"launch (ring {q_facts['ring']}, {q_facts['slices']} slices, "
              f"{q_facts['registers']} registers, {q_facts['shared_bytes']} shared bytes a "
              f"block) = the per-tile chain ({q_b3['per_tile_chain_ms']:.3f} ms) in full, "
              f"whose {K} tiles (4 strips) = the plain tiles on their held steps: the plain "
              f"chain on its first {min(n, T)} steps ({q_plain_ms:.1f} ms summed over its jobs, on "
              f"the {q_plain_on}) | {line}", flush=True)
        e, s_plain_ms, s_plain_on = resolve_plain(s_chain_checks)
        b = b3_bound(s_b3["T"], s_b3["N"], MODE_EXTRA_OPS["int32"])
        line = kernel_row("B3 s", s_b3["chain_ms"], (s_b3["K"] * b[0], b[1]), s_b3["live"],
                          True, plain_ms=s_plain_ms, plain_on=s_plain_on, tiles=s_b3["K"],
                          plain_streams=s_b3["plain_streams"],
                          T=s_b3["T"], N=s_b3["N"], reads=s_b3["reads"], chain=s_b3["facts"],
                          check_steps=min(n, s_b3["T"]), max_abs_err=max(s_chain_err, e),
                          per_tile_chain_ms=s_b3["per_tile_chain_ms"])
        print(f"phase ladders: ok {name_s} biased B3 chain kernel of the longest job "
              f"[{s_b3['T']}, {s_b3['N']}], {s_b3['K']} tiles = the per-tile chain, whose "
              f"tiles = the plain tiles on their first {min(n, s_b3['T'])} steps of streams "
              f"0-{s_b3['plain_streams'] - 1} (its reads' and as many of pads): the plain "
              f"chain there ({s_plain_ms:.1f} ms summed, on the {s_plain_on}) | {line} "
              f"(waited {time.perf_counter() - t0:.1f} s for the plain chains)", flush=True)

        # the oracles, computed meanwhile
        t0 = time.perf_counter()
        for nm, res, idx, keys in ((name_q, q_res["int32"], (sample, q_top), ("q", "q top")),
                                   (name_r, r_res, (r_sample, r_top), ("r", "r top"))):
            for k, i in zip(keys, idx):
                if k in jobs:
                    first_difference(f"{nm}: {k} read", res.scores[i], jobs[k].result(),
                                     "the oracle")
        first_difference(f"{name_s}: picked pair", s_res.scores[picked],
                         jobs["s"].result(), "sw_score_single_biased")
        first_difference(f"{name_s} exact: picked pair", e_res.scores[picked],
                         jobs["s exact"].result(), "sw_score_single")
        print(f"phase ladders: ok oracles: (q) {len(sample) + len(q_top)} reads "
              f"({LADDER_SAMPLE} sampled, {len(windows)} windows, the top-10), (r) "
              f"{len(r_sample) + len(r_top)} reads (the top-10 too) = the oracle; (s) the "
              f"{n_small} smallest pairs and {n_win} windows = sw_score_single_biased, "
              "exact = sw_score_single "
              f"(waited {time.perf_counter() - t0:.1f} s for them)", flush=True)
        out["oracle"] = dict(q=len(sample) + len(q_top), r=len(r_sample) + len(r_top),
                             s=len(picked))
    finally:
        for job in jobs.values():
            job.kill()
        if cli is not None and cli[0].poll() is None:
            os.killpg(cli[0].pid, signal.SIGKILL)
            cli[0].communicate()
        tmp.cleanup()
    return out


LANE_CHECKS = ((1, 1001), (1, 40, 128), (1, 150, 300))  # pairs, query and target widths
E2_CHECK = (128, 256)  # streams, steps of the strip with read starts
E2_STREAMS = 512  # the E2 table's streams


def phase_lane_vs_plain(rng):
    """B6 against its plain version on ragged sentinel-padded pairs, padded
    as sw_scores_lane pads them."""
    from swtpu_torch.ops.lane import lane_scores_cuda, lane_scores_reference, pad_lane_batch
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    results = []
    Bs, ms, ns = LANE_CHECKS
    for B in Bs:
        for m in ms:
            for n in ns:
                qp, tp = pad_lane_batch(*column_batch(rng, B, m, n))
                got = lane_scores_cuda(qp, tp)
                want, plain_ms = cuda_once(lambda: lane_scores_reference(qp, tp))
                err = strip_error(f"lane B={B} m={m} n={n}", got, want)
                ms_ = cuda_ms(lambda: lane_scores_cuda(qp, tp), 10)
                results.append(dict(B=B, m=m, n=n, padded=list(tp.shape), max_abs_err=err,
                                    ms=ms_, plain_ms=plain_ms))
    print(f"phase kernel_vs_plain: ok lane (B6) at {len(results)} shapes (pairs "
          f"{Bs}, query {ms}, target {ns}) bit-equal | kernel "
          f"{min(r['ms'] for r in results):.4f}-{max(r['ms'] for r in results):.4f} ms, "
          f"plain {min(r['plain_ms'] for r in results):.1f}-"
          f"{max(r['plain_ms'] for r in results):.1f} ms")
    return results


def phase_microbench_vs_plain(rng):
    """E1 at every (dtype, pattern) and E2 at every (variant, dtype)
    against their plain versions; tolerance 0.  E1 on its script's input
    at the table's shorter run (2,000 steps).  E2 on a small strip with
    read starts (the boundary selects), then on its script's inputs at
    E2_STREAMS streams: the kernel at both of the table's lengths, each
    held against the plain version on the shorter length's steps (a strip
    is causal in t, so the longer run's first steps are exactly what the
    shorter input gives)."""
    import numpy as np
    import torch
    from experiments import torch_kernel_ablate, torch_microbench_ops
    from swtpu_torch.ops.microbench import (
        DTYPES, LANES, PATTERNS, STEP_CHUNK, VARIANTS, microbench_ops_cuda,
        microbench_ops_reference, stream_ablate_cuda, stream_ablate_reference,
    )
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    e1, e2, e2_main = [], [], []
    steps = torch_microbench_ops.LO
    for name in DTYPES:
        x = torch_microbench_ops.inputs(name)
        for pattern in PATTERNS:
            args = (x, pattern, steps)
            got = microbench_ops_cuda(*args)
            want, plain_ms = cuda_once(lambda: microbench_ops_reference(*args))
            err = strip_error(f"E1 {name} {pattern}", got, want)
            e1.append(dict(dtype=name, pattern=pattern, steps=steps, max_abs_err=err,
                           ms=cuda_ms(lambda: microbench_ops_cuda(*args), 5),
                           plain_ms=plain_ms))
    S, T = E2_CHECK
    qT = torch.from_numpy(rng.integers(0, 4, (LANES, S)).astype(np.int8)).cuda()
    sk = rng.integers(0, 4, (T, S)).astype(np.int8)
    sk[rng.random(sk.shape) < 0.02] |= 8  # read starts: the boundary selects
    sk = torch.from_numpy(sk).cuda()
    for variant in VARIANTS:
        for name, dtype in DTYPES.items():
            args = (qT, sk, variant, dtype)
            got = stream_ablate_cuda(*args)
            want, plain_ms = cuda_once(lambda: stream_ablate_reference(*args))
            err = strip_error(f"E2 {variant} {name}", got, want)
            e2.append(dict(variant=variant, dtype=name, S=S, T=T, max_abs_err=err,
                           ms=cuda_ms(lambda: stream_ablate_cuda(*args), 10),
                           plain_ms=plain_ms))
    S = E2_STREAMS
    T_lo, T_hi = (c * STEP_CHUNK for c in torch_kernel_ablate.CHUNKS)
    small, big = torch_kernel_ablate.inputs(S, T_lo), torch_kernel_ablate.inputs(S, T_hi)
    if not (torch.equal(small[0], big[0]) and torch.equal(small[1], big[1][:T_lo])):
        fail(f"E2's inputs at {T_lo} steps are not the first steps of those at {T_hi}")
    for variant in VARIANTS:
        for name, dtype in DTYPES.items():
            got, got_hi = (stream_ablate_cuda(*x, variant, dtype) for x in (small, big))
            want, plain_ms = cuda_once(lambda: stream_ablate_reference(*small, variant, dtype))
            err = max(strip_error(f"E2 {variant} {name} [{T_lo}, {S}]", got, want),
                      strip_error(f"E2 {variant} {name} [{T_hi}, {S}] first {T_lo} steps",
                                  got_hi[:T_lo], want))
            e2_main.append(dict(variant=variant, dtype=name, S=S, T=T_lo, T_long=T_hi,
                                max_abs_err=err, plain_ms=plain_ms,
                                ms=cuda_ms(lambda: stream_ablate_cuda(*small, variant, dtype), 10)))
    print(f"phase kernel_vs_plain: ok E1 {len(e1)} (dtype, pattern) cases at {steps} "
          f"steps bit-equal | kernel {min(r['ms'] for r in e1):.3f}-"
          f"{max(r['ms'] for r in e1):.3f} ms, plain {min(r['plain_ms'] for r in e1):.1f}-"
          f"{max(r['plain_ms'] for r in e1):.1f} ms")
    for rows, shape in ((e2, f"[{E2_CHECK[1]}, {E2_CHECK[0]}] with read starts"),
                        (e2_main, f"[{T_lo}, {S}] and the first {T_lo} steps of [{T_hi}, {S}]")):
        print(f"phase kernel_vs_plain: ok E2 {len(rows)} (variant, dtype) cases at {shape} "
              f"bit-equal | kernel {min(r['ms'] for r in rows):.4f}-"
              f"{max(r['ms'] for r in rows):.4f} ms, plain "
              f"{min(r['plain_ms'] for r in rows):.1f}-{max(r['plain_ms'] for r in rows):.1f} ms")
    return e1, e2, e2_main


def phase_shootout(card, seed):
    """The shootout's main path through experiments/torch_shootout.py's own
    functions, then B6 against its plain version at that shape, the
    wavefront's strip at 512 streams (B2 at rows 1) against its plain
    version, and E2's full strip against the wavefront kernel at rows 1."""
    import numpy as np
    import torch
    from experiments import torch_shootout as so
    from swtpu_torch import DEFAULT_PENALTIES
    from swtpu_torch.ops.lane import lane_scores_cuda, lane_scores_reference, pad_lane_batch
    from swtpu_torch.ops.microbench import LANES, stream_ablate_cuda
    from swtpu_torch.ops.stream import (
        _to_kernel_layout, stream_strip_cuda, stream_strip_reference,
    )
    from swtpu_torch.utils.timing import cuda_ms, cuda_once

    q, t = so.make_pairs(seed)
    lane_scores_cuda.launches = stream_strip_cuda.launches = 0
    race = so.race(q, t, card, reps=5)
    covered = so.check_like_with_like(q, t)
    launches, b2_launches = lane_scores_cuda.launches, stream_strip_cuda.launches
    if launches == 0 or b2_launches == 0:
        fail(f"the shootout never launched the lane-major kernel (B6) or the wavefront "
             f"(B2) (launches {launches}, {b2_launches})")
    print(f"phase shootout: ok B4 == B6 on all {covered['b4_b6_pairs']} pairs, the "
          f"wavefront == B4 on (q[0], t[i]) for all {covered['wavefront_pairs']} targets "
          f"at S = {', '.join(map(str, so.STREAMS))}; B6 launched {launches} times, B2 "
          f"{b2_launches} | "
          + "; ".join(f"{r['name']} {r['big_ms']:.4f} ms ({r['gcups_big']:.1f} GCUPS)"
                      for r in race) + f" | {card}", flush=True)
    qp, tp = pad_lane_batch(q, t)
    got = lane_scores_cuda(qp, tp)
    want, plain_ms = cuda_once(lambda: lane_scores_reference(qp, tp))
    err = strip_error("lane at the shootout shape", got, want)
    ms = cuda_ms(lambda: lane_scores_cuda(qp, tp), 5)
    B, n = tp.shape
    print(f"phase shootout: ok lane (B6) [{B} pairs, 128 x {n}] bit-equal to its plain "
          f"version | kernel {ms:.4f} ms ({B * 128 * n / ms / 1e6:.1f} GCUPS), plain "
          f"{plain_ms:.1f} ms", flush=True)
    lane = dict(B=B, m=128, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                launches=launches, race=race, covered=covered)
    S = max(so.STREAMS)
    _, d = so.wavefront_batches(q, t, so.BIG)[S]
    args = (*_to_kernel_layout(d.q, d.stream, 1, 1), DEFAULT_PENALTIES, 1, 1)
    got = stream_strip_cuda(*args)
    slices = stream_strip_cuda.slices
    ms = cuda_ms(lambda: stream_strip_cuda(*args), 10)
    want, plain_ms = cuda_once(lambda: stream_strip_reference(*args))
    err = strip_error(f"the shootout's wavefront strip at S = {S}", got, want)
    del want
    ms_after = cuda_ms(lambda: stream_strip_cuda(*args), 10)
    T = args[1].shape[0]
    print(f"phase shootout: ok wavefront (B2, rows 1) strip [{T}, {S}] in {slices} "
          f"slices bit-equal to its plain version | kernel {ms:.4f} ms ({ms_after:.4f} "
          f"ms after the plain version ran), plain {plain_ms:.1f} ms", flush=True)
    b2 = dict(T=T, N=S, rows=1, slices=slices, max_abs_err=err, ms=ms,
              ms_after_plain=ms_after, plain_ms=plain_ms, launches=b2_launches)
    rng = np.random.default_rng([seed, 4])
    S, T = 512, 4096
    qT = torch.from_numpy(rng.integers(0, 4, (LANES, S)).astype(np.int8)).cuda()
    sk = rng.integers(0, 4, (T, S)).astype(np.int8)
    sk[rng.random(sk.shape) < 0.01] |= 8
    sk = torch.from_numpy(sk).cuda()
    got = stream_ablate_cuda(qT, sk, "full")
    want = stream_strip_cuda(qT, sk, DEFAULT_PENALTIES, 1, 1)
    err_full = strip_error("E2 full vs the wavefront kernel", got, want)
    e2_ms = cuda_ms(lambda: stream_ablate_cuda(qT, sk, "full"), 10)
    b2_ms = cuda_ms(lambda: stream_strip_cuda(qT, sk, DEFAULT_PENALTIES, 1, 1), 10)
    print(f"phase shootout: ok E2 full int32 strip [{T}, {S}] bit-equal to the wavefront "
          f"kernel at rows 1 | E2 full {e2_ms:.4f} ms, B2 {b2_ms:.4f} ms", flush=True)
    return lane, b2, dict(S=S, T=T, max_abs_err=err_full, e2_full_ms=e2_ms, b2_ms=b2_ms)


def phase_microbench(card):
    """E1's and E2's timing tables, as their scripts print them, at their
    step counts; E2 at 512 streams in each of the four dtypes."""
    from experiments import torch_kernel_ablate, torch_microbench_ops
    from swtpu_torch.ops.microbench import DTYPES, microbench_ops_cuda, stream_ablate_cuda

    microbench_ops_cuda.launches = stream_ablate_cuda.launches = 0
    e1 = torch_microbench_ops.run(card)
    e2 = [row for name in DTYPES for row in torch_kernel_ablate.run(card, 512, name)]
    launches = microbench_ops_cuda.launches, stream_ablate_cuda.launches
    if min(launches) == 0:
        fail(f"the microbenchmarks never launched E1 or E2 (launches {launches})")
    print(f"phase microbench: ok E1 {len(e1)} cases, E2 {len(e2)} cases | launches "
          f"E1 {launches[0]}, E2 {launches[1]} | {card}", flush=True)
    return e1, e2, launches


T0 = time.perf_counter()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    seconds = {}  # each phase's wall

    def timed(name, phase, *a):
        t0 = time.perf_counter()
        got = phase(*a)
        seconds[name] = time.perf_counter() - t0
        print(f"phase seconds: {name} {seconds[name]:.1f} s", flush=True)
        return got

    card, peaks = timed("device", phase_device)
    import numpy as np
    import torch

    # the short cases draw from `rng` exactly as before the long path was
    # added; the long-path checks and cases have generators of their own
    rng = np.random.default_rng(args.seed)
    rng_long = np.random.default_rng([args.seed, 1])
    rng_col = np.random.default_rng([args.seed, 2])  # the column path's own
    rng_lane = np.random.default_rng([args.seed, 3])  # B6, E1 and E2's own
    rng_modes = np.random.default_rng([args.seed, 5])  # the state modes' and pairs' own
    timed("build", phase_build)
    checks = timed("kernel_vs_plain", phase_kernel_vs_plain, rng)
    checks += timed("ripple_vs_plain", phase_ripple_vs_plain, rng_long)
    chains = timed("chained_vs_plain", phase_chained_vs_plain, rng_long)
    mode_checks = timed("modes_vs_plain", phase_modes_vs_plain, rng_modes)
    chain_mode_checks = timed("chain_modes_vs_plain", phase_chain_modes_vs_plain, rng_modes)
    rng_16 = np.random.default_rng([args.seed, 6])  # the 16-bit states' own
    checks_16, chains_16 = timed("16bit_vs_plain", phase_16bit_vs_plain, rng_16)
    col_checks, col_chains = timed(
        "column_vs_plain", phase_column_vs_plain,
        rng_col, np.random.default_rng([args.seed, 7]),  # odd B: its own
        np.random.default_rng([args.seed, 9]))  # widths 64 and 128, the long gaps: theirs
    lane_checks = timed("lane_vs_plain", phase_lane_vs_plain, rng_lane)
    e1_checks, e2_checks, e2_mains = timed("microbench_vs_plain", phase_microbench_vs_plain,
                                           rng_lane)
    from swtpu_torch.ops.stream import (
        chained_launches as b3_launches, stream_chain_cuda, stream_chained_cuda,
        stream_kernel_info, stream_strip_cuda,
    )

    stream_strip_cuda.launches = 0
    bank, cases = timed("main_path a-c", phase_main_path, rng, card, MAIN_CASES)
    launches = stream_strip_cuda.launches
    if launches == 0:
        fail("the main path never launched the wavefront kernel")
    stream_chain_cuda.launches = stream_chained_cuda.launches = 0
    _, long_cases = timed("main_path d-e", phase_main_path, rng_long, card, LONG_CASES)
    chained_launches = b3_launches()
    if chained_launches == 0:
        fail("the long-query path never launched the chained kernel")
    pair_cases = timed("pairs_path", phase_pairs_path, rng_modes, card)
    mode_dbs = timed("mode_databases", phase_mode_databases, card, cases, long_cases)
    dbs_16 = timed("16bit_databases", phase_16bit_databases, card, cases[2], long_cases[1])
    serving = timed("serving", phase_serving, np.random.default_rng([args.seed, 8]), card,
                    cases)
    from swtpu_torch.ops.column import column_chained_cuda, column_scores_cuda

    column_scores_cuda.launches = column_chained_cuda.launches = 0
    col_bank, col_cases = timed("bucketed_path", phase_bucketed_path, rng_col, card,
                                long_cases[1])
    column_launches = column_scores_cuda.launches
    column_chained_launches = column_chained_cuda.launches
    if column_launches == 0 or column_chained_launches == 0:
        fail("the bucketed path never launched the column kernels "
             f"({column_launches}, {column_chained_launches})")
    jobs = timed("jobs", phase_jobs, card, cases, col_cases[0])
    faults_launches = jobs["launches"].pop("f jobs faults")
    sharded = timed("sharded", phase_sharded, card, cases, long_cases, serving, args.seed)
    regress = timed("regress", phase_regress, card)
    bench = timed("bench", phase_bench, card)
    mains = timed("kernel_main_shape", phase_kernel_at_main_shape, bank, cases)
    long_mains = timed("chained_main_shape", phase_chained_at_main_shape, bank, long_cases)
    mode_a, mode_d = timed("modes_main_shape", phase_modes_at_main_shape, bank, cases[0],
                           long_cases[0])
    check_bench_headline(bench, mode_a["ms"]["float32"], card)
    b1_16, b3_16 = timed("16bit_main_shape", phase_16bit_at_main_shape, cases, long_cases,
                         peaks)
    col_batches, col_tile = timed(
        "column_main_shape", phase_column_at_main_shape,
        col_bank, col_cases[0], col_cases[1], long_mains[1]["chain_ms"], peaks)
    f_states, g_states = timed("column_states", phase_column_states, col_bank, col_cases[0],
                               col_cases[1])
    ladders = timed("ladders", phase_ladders, np.random.default_rng([args.seed, 10]), card,
                    peaks)
    lane, b2, e2_full = timed("shootout", phase_shootout, card, args.seed)
    e1_table, e2_table, (e1_launches, e2_launches) = timed("microbench", phase_microbench,
                                                           card)
    head = mains[0]  # case (a): the headline shape, segments 1, rows 16
    lhead = long_mains[0]  # case (d), tile 0
    chead = col_batches[-1]  # case (f)'s largest bucket, 512 columns
    e1_head = e1_checks[0]  # int32 addmax at the E1 table's 2,000 steps
    e2_head = e2_mains[0]  # full int32 at the E2 table's [2048, 512]
    # each bound: the inputs read once and the outputs written once, and
    # the recurrence's operations on the cells the kernel computes
    T, N = head["T"], head["N"]
    b_wave = peaks.bound(128 * N + T * N * 5, 128 * T * N * WAVEFRONT_OPS)
    for m in mains:  # each of (a)-(c): its bound and its share of it
        S = m["N"] // m["segments"]  # physical streams, 128 query rows each
        m["bound_ms"], m["bound_by"] = peaks.bound(
            128 * S + m["T"] * m["N"] * 5, 128 * m["T"] * S * WAVEFRONT_OPS)
        m["bound_share"] = m["bound_ms"] / m["ms"]
    b2["bound_ms"], b2["bound_by"] = peaks.bound(
        128 * b2["N"] + b2["T"] * b2["N"] * 5, 128 * b2["T"] * b2["N"] * WAVEFRONT_OPS)
    # a chained tile reads 1 + 12 bytes and writes 16 a stream-step
    Tl, Nl, Tc = lhead["T"], lhead["N"], lhead["check_steps"]
    b_chain = peaks.bound(128 * Nl + Tl * Nl * (1 + 12 + 16), 128 * Tl * Nl * WAVEFRONT_OPS)
    Tc0 = lhead["check_held"][0]  # tile 0's held steps, its cut run's
    b_cut = peaks.bound(128 * Nl + Tc0 * Nl * (1 + 12 + 16), 128 * Tc0 * Nl * WAVEFRONT_OPS)
    # the chain kernel at (d): every tile's register and the stream read
    # once, the last strip written once, K tiles' operations: K x the tile's
    # bound where the operations bound it
    Kd = lhead["tiles"]
    b_fused = peaks.bound(Kd * 128 * Nl + Tl * Nl * (1 + 4), Kd * 128 * Tl * Nl * WAVEFRONT_OPS)
    B, m, n = chead["B"], chead["m"], chead["n"]
    b_col = chead["bound_ms"], chead["bound_by"]
    Bt, nt = col_tile["B"], col_tile["n"]
    b_tile = peaks.bound(Bt * (256 + nt + 8 + 16 * nt), Bt * 256 * nt * COLUMN_OPS)
    Bl, nl = lane["B"], lane["n"]
    b_lane = peaks.bound(Bl * (128 * 4 + nl + 4), Bl * 128 * nl * COLUMN_OPS)
    elems = 512 * 128
    for row in e1_checks:  # the array read and written once, `steps` steps of ops
        row["bound_ms"], row["bound_by"] = peaks.bound(
            2 * elems * (4 if row["dtype"] in ("int32", "float32") else 2),
            row["steps"] * elems * (8 * e1_ops(row["pattern"], row["dtype"]) + E1_MOD_OPS),
            e1_lanes(row["pattern"], row["dtype"]))
    for row in e2_mains:  # qT and the stream read, the int32 strip written
        S2, T2 = row["S"], row["T"]
        row["bound_ms"], row["bound_by"] = peaks.bound(
            128 * S2 + T2 * S2 * 5, S2 * T2 * e2_ops(row["variant"], row["dtype"]),
            e2_lanes(row["variant"], row["dtype"]))
    for row in mode_checks:  # the wavefront's bytes and its mode's operations
        S3, T3, dtype = row["N"] // row["segments"], row["T"], MODE_DTYPES[row["mode"]]
        row["bound_ms"], row["bound_by"] = peaks.bound(
            128 * S3 + T3 * row["N"] * 5,
            128 * T3 * S3 * (WAVEFRONT_OPS + MODE_EXTRA_OPS[dtype]),
            cell_lanes("wavefront", dtype, WAVEFRONT_OPS + MODE_EXTRA_OPS[dtype]))
    for row in checks_16:  # the same, with the 16-bit state's operations and lanes
        S3, T3, dtype = row["N"] // row["segments"], row["T"], MODE_DTYPES_16[row["mode"]]
        row["bound_ms"], row["bound_by"] = peaks.bound(
            128 * S3 + T3 * row["N"] * 5,
            128 * T3 * S3 * (WAVEFRONT_OPS + SIXTEEN_EXTRA_OPS[dtype]),
            cell_lanes("wavefront", dtype, WAVEFRONT_OPS + SIXTEEN_EXTRA_OPS[dtype]))
        row["bound_share"] = row["bound_ms"] / row["ms"]
    for row in chains_16:  # every tile of the chain: a chained tile's bytes
        T3, N3, K3, dtype = row["T"], row["N"], row["tiles"], MODE_DTYPES_16[row["mode"]]
        row["bound_ms"], row["bound_by"] = peaks.bound(
            K3 * (128 * N3 + T3 * N3 * (1 + 12 + 16)),
            K3 * 128 * T3 * N3 * (WAVEFRONT_OPS + SIXTEEN_EXTRA_OPS[dtype]),
            cell_lanes("wavefront", dtype, WAVEFRONT_OPS + SIXTEEN_EXTRA_OPS[dtype]))
        row["bound_share"] = row["bound_ms"] / row["ms"]
    b_e1 = e1_head["bound_ms"], e1_head["bound_by"]
    b_e2 = e2_head["bound_ms"], e2_head["bound_by"]
    for row in e1_table:  # the least time of one op over the array: card, its SMs
        per_op = elems * (e1_ops(row["pattern"], row["dtype"]) + E1_MOD_OPS / 8)
        lanes = e1_lanes(row["pattern"], row["dtype"])
        row["bound_ns_per_op"] = peaks.bound(0, per_op, lanes)[0] * 1e6
        row["bound_ns_per_op_on_its_sms"] = peaks.bound(
            0, per_op, lanes, E1_SMS[row["dtype"]])[0] * 1e6
    for row in e2_table:  # the least time of one step over S streams
        row["bound_ns_per_step"] = peaks.bound(
            0, row["S"] * e2_ops(row["variant"], row["dtype"]),
            e2_lanes(row["variant"], row["dtype"]))[0] * 1e6
    no_library = ("no single PyTorch call computes Smith-Waterman scores, the "
                  "microbenchmarks' op chains or the ablated wavefront step")

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bound, **rest):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None, "library_note": no_library, **rest}

    def mode_rows(at, bound_of, plain, plain_note):
        """Each of MAIN_MODES at a main shape: its time beside int32's in
        the same call, its bound with the mode's operations, slices and
        registers."""
        rows = {}
        for label, _, dtype in MAIN_MODES:
            ops = WAVEFRONT_OPS + MODE_EXTRA_OPS[dtype]
            b = bound_of(ops, cell_lanes("wavefront", dtype, ops))
            rows[label] = dict(at["modes"][label], ms=at["ms"][label],
                               int32_ms=at["ms"]["int32"], bound_ms=b[0], bound_by=b[1],
                               plain_ms=plain[label], plain_note=plain_note)
        return rows

    def column_states(at, bound_of, k):
        """The column kernels' float32 and int16 states at a main shape:
        time per batch beside int32's, the bound at the plain version's
        shape (batch k: (f)'s largest bucket, (g)'s tile 0) with the
        state's operations on its lanes and its share there, registers, the
        pairs a warp holds, and the plain version's time there."""
        rows = {}
        for dtype in COLUMN_EXACT_STATES:
            ops = COLUMN_OPS + COLUMN_EXTRA_OPS[dtype]
            b = bound_of(ops, cell_lanes("column", dtype, ops))
            m = at["modes"][dtype]
            rows[dtype] = dict(m, int32_ms=at["int32_ms"],
                               int32_registers=at["int32_registers"], bound_ms=b[0],
                               bound_by=b[1], bound_share=b[0] / m["ms"][k],
                               pairs_per_warp=2 if dtype == "int16" else 1)
        return rows

    # the 16-bit rows (phase 16bit_main_shape): B1 at (a) rows 8 and 4 and
    # at (c), B3's chain in one launch at (d) and (e), rows 8; each with its
    # time, bound, share, slices, registers and spill bytes
    modes_b1_16 = {f"{r['shape']} {r['name']}": r for r in b1_16}
    modes_b3_16 = {f"{r['name']} rows {r['rows']}": r for r in b3_16}
    modes_f = column_states(f_states, lambda ops, lanes: peaks.bound(
        B * (m + n + 4), B * m * n * ops, lanes), -1)
    modes_g = column_states(g_states, lambda ops, lanes: peaks.bound(
        Bt * (256 + nt + 8 + 16 * nt), Bt * 256 * nt * ops, lanes), 0)
    # per path, (wavefront, chained) launches on the main path: the exact
    # cases, the pairs and the state modes' score_database runs
    by_path = {"a-c int32": [launches, 0], "d-e int32": [0, chained_launches],
               **{c["name"]: c["launches"] for c in pair_cases + mode_dbs + dbs_16 + serving},
               **jobs["launches"], **sharded["launches"], **regress["launches"],
               **bench["launches"],
               "ladders": [ladders["launches"]["B1"], ladders["launches"]["B3"]]}
    launches_total = [sum(x[k] for x in by_path.values()) for k in (0, 1)]
    plain_a = {"biased W=12": mode_a["plain_ms"]["biased W=8"],
               "float32": mode_a["plain_ms"]["float32"]}
    modes_a = mode_rows(
        mode_a, lambda ops, lanes: peaks.bound(128 * N + T * N * 5, 128 * T * N * ops, lanes),
        plain_a, f"the first {mode_a['check_steps']} steps (biased: at W = 8, the same "
        "operations)")
    plain_d = {k.removesuffix(" chain"): x for k, p, x in mode_d["plain_ms"] if p < 0}
    modes_d = mode_rows(
        dict(mode_d, ms=mode_d["chain_ms"],
             modes={k: dict(v["chain"], tile_slices=v["slices"], tile_registers=v["registers"])
                    for k, v in mode_d["modes"].items()}),
        lambda ops, lanes: peaks.bound(Kd * 128 * Nl + Tl * Nl * (1 + 4),
                                       Kd * 128 * Tl * Nl * ops, lanes),
        plain_d, f"the plain chain's first {mode_d['check_steps']} steps (on the CPU)")
    regs, _, blocks_sm = stream_kernel_info(head["rows"])
    regs_tile, _, blocks_sm_tile = stream_kernel_info(lhead["rows"], chained=True)
    # B1's instantiations at the main paths' rows: registers, spill bytes
    # and resident blocks an SM, a thread holding 16 query rows at each
    b1_instantiations = {
        f"rows {r} {label}": dict(zip(("registers", "spill_bytes", "resident_blocks_per_sm"),
                                      stream_kernel_info(r, score_width=w, state_dtype=d)))
        for r in (4, 8, 16)
        for label, w, d in (("int32", None, "int32"), *MAIN_MODES)}
    for label, info in b1_instantiations.items():
        if info["spill_bytes"]:
            fail(f"B1 {label} spills {info['spill_bytes']} bytes a thread")
    kernels = [
        entry("stream_wavefront", "swtpu_torch/ops/csrc/stream_wavefront.cu",
              "swtpu/ops/pallas_stream.py:193", launches_total[0],
              max(c["max_abs_err"] for c in checks + mains + [b2] + mode_checks + [mode_a]
                  + checks_16 + b1_16 + [ladders["kernels"]["B1 r"]]),
              head["ms"], head["plain_ms"], b_wave,
              plain_note=f"(a)'s first {head['check_steps']} steps",
              launches_by_path={k: v[0] for k, v in by_path.items()},
              modes=modes_a, mode_configs=mode_checks, modes_16bit=modes_b1_16,
              configs_16bit=checks_16,
              also_replaces="swtpu/ops/pallas_stream.py:57 (tail-accumulator and "
                            "ripple-H forms)",
              shape=[head["T"], head["N"]], slices=head["slices"],
              slice_steps=head["slice_steps"], registers=regs,
              resident_blocks_per_sm=blocks_sm, ms_one_slice=head["ms_one_slice"],
              instantiations=b1_instantiations, long_reads=ladders["kernels"]["B1 r"],
              main_shapes=mains, shootout_rows1=b2, configs=checks),
        entry("stream_chained", "swtpu_torch/ops/csrc/stream_wavefront.cu",
              "swtpu/ops/pallas_stream.py:314", launches_total[1],
              max(c["max_abs_err"] for c in chains + long_mains + chain_mode_checks
                  + [mode_d] + chains_16 + b3_16 + [ladders["kernels"]["B3 q"]]),
              lhead["chain_ms"], lhead["chain_plain_ms"], b_fused,
              plain_note=f"the plain chain ({Kd} tiles) on (d)'s first {Tc} steps, on the "
                         f"{lhead['chain_plain_on']}",
              launches_by_path={k: v[1] for k, v in by_path.items()},
              tiles=Kd, tile_bound_ms=b_chain[0], per_tile_chain_ms=lhead["per_tile_chain_ms"],
              modes=modes_d, mode_tile_ms=mode_d["tile_ms"], mode_configs=chain_mode_checks,
              modes_16bit=modes_b3_16, configs_16bit=chains_16,
              shape=[Tl, Nl], plain_shape=[Tc, Nl], ring=lhead["chain"]["ring"],
              slices=lhead["chain"]["slices"], registers=lhead["chain"]["registers"],
              spill_bytes=lhead["chain"]["spill_bytes"],
              shared_bytes_per_block=lhead["chain"]["shared_bytes"],
              resident_blocks_per_sm=lhead["chain"]["resident_blocks_per_sm"],
              one_tile=dict(ms=lhead["tile_ms"][0], plain_ms=lhead["plain_ms"][0],
                            bound_ms=b_chain[0], bound_by=b_chain[1],
                            slices=lhead["slices"], slice_steps=lhead["slice_steps"],
                            registers=regs_tile, resident_blocks_per_sm=blocks_sm_tile,
                            ms_one_slice=lhead["tile_ms_one_slice"][0]),
              check_cut=dict(steps=Tc0, slices=lhead["check_slices"],
                             ms=lhead["check_ms"][0], plain_ms=lhead["plain_ms"][0],
                             bound_ms=b_cut[0], bound_by=b_cut[1]),
              main_shapes=long_mains, configs=chains,
              side_by_side={k: ladders["kernels"][k]
                            for k in ("B3 s side by side", "B3 s exact side by side")},
              ladders={k: ladders["kernels"][k] for k in ("B3 q", "B3 s")}),
        entry("column", "swtpu_torch/ops/csrc/column.cu", "swtpu/ops/pallas_kernel.py:54",
              column_launches + faults_launches[0] + sharded["column_launches"][0]
              + bench["column_launches"] + ladders["launches"]["B4"],
              max(c["max_abs_err"] for c in col_checks + col_batches
                  + [f_states, ladders["kernels"]["B4 r"]]),
              chead["ms"], chead["plain_ms"], b_col,
              shape=[chead["B"], chead["m"], chead["n"]], main_shapes=col_batches,
              configs=col_checks, modes=modes_f,
              launches_by_path={"f-h int32": column_launches,
                                "f jobs faults": faults_launches[0],
                                "n sharded": sharded["column_launches"][0],
                                "bench": bench["column_launches"],
                                "ladders": ladders["launches"]["B4"],
                                **{f"f {k}": v["launches"]
                                   for k, v in f_states["modes"].items()}}),
        entry("column_chained", "swtpu_torch/ops/csrc/column.cu",
              "swtpu/ops/pallas_kernel.py:137",
              column_chained_launches + sharded["column_launches"][1]
              + ladders["launches"]["B5"],
              max(c["max_abs_err"] for c in col_chains
                  + [col_tile, g_states, ladders["kernels"]["B5 q"]]),
              col_tile["ms"][0], col_tile["plain_ms"][0], b_tile,
              shape=[col_tile["B"], 256, col_tile["n"]], main_shapes=[col_tile],
              configs=col_chains, modes=modes_g,
              launches_by_path={"f-h int32": column_chained_launches,
                                "n sharded": sharded["column_launches"][1],
                                "ladders": ladders["launches"]["B5"],
                                **{f"g {k}": v["launches"]
                                   for k, v in g_states["modes"].items()}}),
        entry("lane", "swtpu_torch/ops/csrc/lane.cu", "swtpu/ops/pallas_lane.py:37",
              lane["launches"], max(c["max_abs_err"] for c in lane_checks + [lane]),
              lane["ms"], lane["plain_ms"], b_lane, shape=[lane["B"], 128, lane["n"]],
              shootout=lane["race"], configs=lane_checks),
        entry("microbench_ops", "swtpu_torch/ops/csrc/microbench.cu",
              "experiments/microbench_ops.py:23", e1_launches,
              max(c["max_abs_err"] for c in e1_checks), e1_head["ms"], e1_head["plain_ms"],
              b_e1, shape=[512, 128, e1_head["steps"]],
              case=[e1_head["dtype"], e1_head["pattern"]], table=e1_table,
              configs=e1_checks),
        entry("stream_ablate", "swtpu_torch/ops/csrc/microbench.cu",
              "experiments/kernel_ablate.py:44", e2_launches,
              max(c["max_abs_err"] for c in e2_checks + e2_mains + [e2_full]),
              e2_head["ms"], e2_head["plain_ms"], b_e2, shape=[e2_head["T"], e2_head["S"]],
              case=[e2_head["variant"], e2_head["dtype"]], table=e2_table,
              full_vs_wavefront=e2_full, main_shapes=e2_mains, configs=e2_checks),
    ]
    left = live_children(plain=True)
    if left:
        fail(f"processes this script started are still running: {left}")
    print(card)
    print(json.dumps({"kernels": kernels, "bucketed_cases": [
        {k: (list(v) if isinstance(v, tuple) else v) for k, v in c.items()
         if k not in ("query", "db")} for c in col_cases
    ], "pair_cases": pair_cases, "mode_databases": mode_dbs + dbs_16, "serving": serving,
        "jobs": jobs, "sharded": sharded, "regress": regress, "bench": bench,
        "ladders": ladders, "phase_seconds": seconds, "seconds": time.perf_counter() - T0}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

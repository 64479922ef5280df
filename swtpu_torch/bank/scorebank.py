"""ScoreBank — the batched many-vs-one scoring engine on torch.

The port of ``swtpu.bank.scorebank``'s ``score_database`` and
``score_pairs`` on two backends:

- ``stream``: the host packs the reads into flagged char streams
  (``swtpu_torch.bank.streams``), the streams cross to the device (2-bit
  packed on CUDA), the wavefront writes its [T, N] strip and the emission
  gather returns the scores in read order.  A query longer than 128 bases
  chains K tiles of 128 query rows over the same streams.  ``score_pairs``
  packs pair streams (one query register per stream) for the queries of
  up to 128 bases, and runs each distinct longer query's pairs as a
  chained many-vs-one job.  It carries ``SWConfig.score_width`` and every
  ``stream_state_dtype`` of swtpu's (int32, float32, int16, uint16,
  bfloat16; the 16-bit ones at rows of at most 8, so ``stream_rows`` must
  be set for a segments-1 query on CUDA, where the geometry picks 16).
  ``load_database`` packs a database once and leaves its stream resident
  on the device (``LoadedDatabase``); ``score_loaded``,
  ``score_loaded_many`` and ``topk_loaded`` then ship only each query's
  register and run the same wavefront entries on the resident stream;
  ``load_database_sharded`` and its ``*_sharded`` entries do the same on
  every shard of a mesh (``swtpu_torch.bank.serving``).
  ``SWConfig.stream_chunk_reads`` splits a short query's database into
  chunks: the host packs chunk i+1 while chunk i's copy and kernels run
  (``_score_database_stream``, whose call without chunks is one chunk).
- ``pallas`` (the bucketed column path; swtpu's name for it is kept): the
  host packs the reads into dense length buckets
  (``swtpu_torch.bank.packer``) and each bucket batch is scored by the
  column kernels (``swtpu_torch.ops.column``), chained 256-row tiles for a
  query over 256 bases.  It carries ``SWConfig.score_width``, the RTL's
  W-bit wrap-parity arithmetic.  A callable backend ``fn(q, t,
  penalties)`` takes the column kernels' place on the same batches, and
  ``scan`` runs them through ``swtpu_torch.ops.scan`` (torch's own ops).

On a CUDA device the kernels are the hand-written ones; on the CPU they
are the plain PyTorch versions, with the settings swtpu uses in interpret
mode, so both packages pack the same batches there.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from swtpu_torch.bank.buckets import plan_buckets
from swtpu_torch.bank.packer import pack_many_vs_one, pack_pairs
from swtpu_torch.bank.streams import (
    LANES, batch_to_device, dedupe_queries, pack_pair_streams, pack_stream_wire,
    pack_streams, pack_streams_long,
)
from swtpu_torch.config import SWConfig
from swtpu_torch.io.loader import EncodedDB
from swtpu_torch.ops.column import sw_scores_column
from swtpu_torch.ops.common import Q_PAD
from swtpu_torch.ops.scan import sw_scores_scan
from swtpu_torch.ops.stream import (
    _q_kernel_layout, _validate_config, sw_scores_stream,
    sw_scores_stream_kernel_layout, sw_scores_stream_long,
    sw_scores_stream_long_kernel_layout, sw_scores_stream_long_packed,
    reads_up_to, sw_scores_stream_packed, unpack_stream_wire,
)
from swtpu_torch.parallel.topk import _local_topk
from swtpu_torch.utils.metrics import BatchEvent


# A pair set's long-query jobs on CUDA run side by side: job u's chain on
# CUDA stream u mod JOB_STREAMS (8, the card's default number of hardware
# queues, CUDA_DEVICE_MAX_CONNECTIONS: more streams would share them), and
# at most JOB_WINDOW jobs are dispatched and not yet finished, so that a
# set of tens of thousands of distinct long queries holds a fixed number
# of jobs' buffers
JOB_STREAMS = 8
JOB_WINDOW = 2 * JOB_STREAMS


def _dense_form(targets):
    """(mat, lens) if `targets` is an EncodedDB or (mat, lens) tuple."""
    if isinstance(targets, EncodedDB):
        return targets.mat, targets.lens
    if (
        isinstance(targets, tuple)
        and len(targets) == 2
        and isinstance(targets[0], np.ndarray)
        and targets[0].ndim == 2
    ):
        return targets[0], np.asarray(targets[1], np.int32)
    return None, None


def _put(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a torch tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _put_query(query: np.ndarray, device) -> torch.Tensor:
    """A query's codes on `device` without waiting for the device: from
    pinned memory on CUDA, so a dispatch enqueues behind earlier work
    instead of synchronising with it."""
    t = torch.from_numpy(np.ascontiguousarray(query, np.int8))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


STAGE_ALIGN = 64  # bytes: each array's offset in a staging buffer


def _stage_layout(arrays) -> tuple:
    """(offsets, total bytes) of the contiguous numpy `arrays` laid out one
    after another in a staging buffer, each at a STAGE_ALIGN-byte offset."""
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // STAGE_ALIGN) * STAGE_ALIGN
    return offsets, total


def _fill_stage(buf: torch.Tensor, arrays, offsets) -> None:
    """Write `arrays` into the uint8 host buffer `buf` at `offsets`."""
    host = buf.numpy()
    for a, off in zip(arrays, offsets):
        host[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)


def _staged_views(dev: torch.Tensor, arrays, offsets) -> list:
    """The uint8 device buffer `dev` cut back into tensors of the arrays'
    dtypes and shapes."""
    return [
        dev[off : off + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
        for a, off in zip(arrays, offsets)
    ]


def _put_pinned(arrays, device) -> list:
    """The numpy `arrays` on the CUDA `device` without waiting for it: one
    pinned host buffer (PyTorch's caching host allocator, which keeps it
    until the copy has run) crosses in one copy on the current stream,
    queued behind the stream's earlier work while the host goes on."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = _stage_layout(arrays)
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    _fill_stage(buf, arrays, offsets)
    return _staged_views(buf.to(device, non_blocking=True), arrays, offsets)


class _PinnedStager:
    """Host-to-device copies of the stream path's chunks that never wait
    for the kernels: two pinned host buffers taken in turn, each filled by
    the host and copied on a stream of its own, made anew for each call.

    The compute stream waits on the event recorded after each copy; the
    host waits on that same event before it fills the buffer again, two
    chunks later, so it only ever waits for a copy and never for a
    kernel.  A copy from pageable memory would block the host until the
    kernels queued before it had run, and so serialise packing behind the
    device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.copy_stream = torch.cuda.Stream(self.device)
        self.buffers = [None, None]  # pinned uint8 host buffers
        self.copied = [None, None]  # event after each buffer's last copy
        self.turn = 0

    def put(self, *arrays):
        """The numpy `arrays` as tensors on the device, ready for the
        kernels that the current stream runs next."""
        slot, self.turn = self.turn, self.turn ^ 1
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offsets, total = _stage_layout(arrays)
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        buf = self.buffers[slot]
        if buf is None or buf.numel() < total:
            buf = self.buffers[slot] = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        _fill_stage(buf, arrays, offsets)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            dev.copy_(buf[:total], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self.copied[slot] = done
        compute.wait_event(done)
        # made on the copy stream, read on the compute stream: its memory
        # must not be reused before the compute stream is done with it
        dev.record_stream(compute)
        return _staged_views(dev, arrays, offsets)


def stream_geometry(query_len: int, config: SWConfig, device) -> tuple:
    """(segments, rows, phys) of the streamed wavefront for a query of
    `query_len` bases on `device`: swtpu's device settings on CUDA, its
    interpret settings on the CPU, so both packages pack the same batch.
    A query over 128 bases (the chained tiles) takes segments 1; for a
    pair set, `query_len` is its longest query."""
    # short queries pack 2 or 4 per column
    if query_len <= LANES // 4:
        segments = 4
    elif query_len <= LANES // 2:
        segments = 2
    else:
        segments = 1
    on_cuda = torch.device(device).type == "cuda"
    rows = config.stream_rows
    if rows == 0:
        rows = {1: 16, 2: 8, 4: 4}[segments] if on_cuda else 1
    phys = config.stream_phys if on_cuda else 8
    return segments, rows, phys


@dataclasses.dataclass
class ScoreResult:
    """Scores for one query against a database, in database read order."""

    scores: np.ndarray  # [n_reads] int32
    cells: int  # real DP cells scored (for GCUPS)
    padded_cells: int  # total padded cells dispatched
    elapsed_s: float

    @property
    def gcups(self) -> float:
        return self.cells / self.elapsed_s / 1e9 if self.elapsed_s > 0 else 0.0

    def top_k(self, k: int) -> List[tuple]:
        """(score, read_index) best hits; ties keep read order."""
        idx = np.argsort(-self.scores, kind="stable")[:k]
        return [(int(self.scores[i]), int(i)) for i in idx]


@dataclasses.dataclass
class LongJob:
    """One long-query job between its dispatch and its finish
    (:meth:`ScoreBank._dispatch_long`, :meth:`ScoreBank._finish_long`).
    On CUDA `done` is the event recorded after the scores' copy back into
    the pinned `scores`; on the CPU it is None and `scores` holds the
    result."""

    query: np.ndarray
    targets: object  # the reads, as given (verify_integrity's bound check)
    tlens: object  # their lengths in the dense forms, else None
    n_reads: int
    cells: int
    padded_cells: int
    note: str
    t0: float  # host clock at dispatch
    scores: torch.Tensor = None  # pinned host copy (CUDA) or the scores (CPU)
    done: object = None


@dataclasses.dataclass
class LoadedDatabase:
    """A packed database resident on the device across queries.

    Built once by :meth:`ScoreBank.load_database`; each
    :meth:`ScoreBank.score_loaded` then ships only the query register, and
    the stream stays in device memory in the kernel's layout."""

    stream: torch.Tensor  # [T, N] int8, contiguous: the kernel's layout
    emit_stream_dev: torch.Tensor  # [n_reads] int32 on the device
    emit_step_dev: torch.Tensor  # [n_reads] int32 on the device
    t_lens: np.ndarray  # per-read true lengths (cells + guard bounds)
    total_chars: int
    n_reads: int
    rows: int
    k_max: int  # query tiles the stream was drain-padded for
    segments: int = 1  # queries per lane column (short-query occupancy)
    emit_regular: object = None  # strided-extract pattern (streams.py)
    # host seconds of the load's stages: "pack", "wire" (0 without the
    # wire) and "device" (the copies, the unpack and the relayout, waited for)
    load_s: dict = dataclasses.field(default_factory=dict)


def longest_read(lengths):
    """The longest of the read lengths (an array or an iterable), 0 for
    none: what the wavefront's slice rule takes (ops.stream.reads_up_to)."""
    if isinstance(lengths, np.ndarray):
        return int(lengths.max(initial=0))
    return max(lengths, default=0)


class ScoreBank:
    """Batched many-vs-one scorer on one torch device.

    backend: 'stream' (the streamed wavefront), 'pallas' (the bucketed
    column kernels), 'scan' (the bucketed batches through
    ``swtpu_torch.ops.scan``, torch's own ops on the device), 'auto':
    'stream', or 'pallas' when ``config.score_width`` is set; or a
    callable ``fn(q, t, penalties)`` that scores the bucketed path's dense
    batches (q [B, m], t [B, n] int8 -> [B] scores) in the column kernels'
    place, as swtpu's does.  'stream' and 'pallas' carry
    ``config.score_width``; 'scan' and a callable refuse it, as swtpu's
    do.  device: where the kernels run — 'cuda' launches the CUDA kernels,
    'cpu' runs their plain PyTorch versions."""

    def __init__(
        self,
        config: SWConfig = SWConfig(),
        backend="auto",
        device="cuda",
        verify_integrity: bool = False,
    ):
        if not callable(backend) and backend not in ("auto", "stream", "pallas", "scan"):
            raise ValueError(f"unknown backend {backend!r}")
        if config.score_width is not None and backend not in ("auto", "pallas", "stream"):
            # wrap-parity lives in the stream and column kernels; an
            # explicitly named scan or callable backend is never overridden
            raise ValueError(
                "score_width requires the 'stream' or 'pallas' backend "
                f"(got {backend!r})"
            )
        if backend == "auto":
            # Wrap-parity runs on both backends; 'auto' sends it to the
            # column kernels, as swtpu does off the TPU.  A wrap-parity pair
            # set such as chip_smoke.py's case (h) (65,536 pairs of 24-512
            # bases) holds ~51,000 distinct queries over 128 bases, and the
            # stream backend runs one chained job for each.  PERF.md times
            # both backends on chip_smoke.py's pair cases.
            backend = "pallas" if config.score_width is not None else "stream"
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ScoreBank(device={str(self.device)!r}): no CUDA device "
                "is available"
            )
        self.config = config
        self.backend = backend
        # validate packed batches and score bounds; off by default
        self.verify_integrity = verify_integrity
        # the CUDA streams of the long-query jobs, made at first use and
        # kept: the caching allocator reuses a block only on the stream it
        # was made on, so fresh streams each call would allocate anew
        self._job_streams: list = []

    def _stream_dtype(self) -> str:
        """The wavefront's state type: int32 for "auto" (swtpu's "auto" is
        float32 on the TPU, where it measured faster; the scores are
        identical, and which is faster on this card is measured in
        PERF.md), and int32 whenever score_width is set (the wrap is
        integer bit arithmetic; float lanes cannot wrap); any other
        ``stream_state_dtype`` as it is, which the wavefront's checks
        accept or refuse with swtpu's errors."""
        if self.config.score_width is not None:
            return "int32"
        sdt = self.config.stream_state_dtype
        return "int32" if sdt == "auto" else sdt

    def _stream_modes(self) -> dict:
        """The state keywords of every wavefront entry, for this bank;
        raises before any packing for a state or width the wavefront does
        not take."""
        modes = dict(state_dtype=self._stream_dtype(), score_width=self.config.score_width)
        _validate_config(1, 1, penalties=self.config.penalties, **modes)
        return modes

    def score_database(self, query: np.ndarray, targets, event_log=None) -> ScoreResult:
        """Score every target read against `query`; returns read-order scores.

        targets: a sequence of 1-D code arrays, an
        :class:`swtpu_torch.io.loader.EncodedDB`, or a (mat, lens) tuple
        (the dense forms: the database stays one int8 matrix).

        event_log: optional :class:`swtpu_torch.utils.metrics.EventLog`
        receiving one "stream" record per call ("stream_pipelined" when
        ``stream_chunk_reads`` chunks it, "stream_long" for a query over 128
        bases), or on the pallas and callable backends one "batch" record
        per bucket batch."""
        tmat, tlens = _dense_form(targets)
        if self.backend != "stream":
            return self._score_database_bucketed(query, targets, event_log)
        if len(query) > LANES:
            # chained 128-row tiles carry the tail-row D/G/H strips from
            # tile to tile (the reference's reserved chaining ports)
            return self._score_database_stream_long(
                query, targets, event_log, tmat=tmat, tlens=tlens
            )
        return self._score_database_stream(
            query, targets, event_log, tmat=tmat, tlens=tlens
        )

    def _check_scores(self, scores, query, targets, tlens) -> None:
        """verify_integrity's bound check on one call's scores."""
        from swtpu_torch.utils.guards import check_scores

        t_lens = tlens if tlens is not None else np.fromiter(
            (len(t) for t in targets), np.int64, len(targets)
        )
        check_scores(
            scores, np.full(len(t_lens), len(query)), t_lens,
            self.config.penalties.match,
        )

    def _score_database_stream(
        self, query, targets, event_log=None, tmat=None, tlens=None
    ) -> ScoreResult:
        """Streamed wavefront path: ragged reads concatenate back-to-back
        per stream, no length buckets.  With ``SWConfig.stream_chunk_reads``
        below the read count it runs in chunks of that many reads: the host
        packs (and wire-packs) chunk i+1 while chunk i's copy, unpack,
        wavefront and gather run on the device, and nothing waits for the
        device until every chunk is dispatched.  The host holds about one
        chunk's packed buffers at a time.  A call without chunks is the
        loop's one chunk.

        On CUDA each of several chunks crosses from one of the call's two
        pinned staging buffers on a copy stream (:class:`_PinnedStager`);
        one chunk, with nothing to overlap, crosses from pageable memory,
        which took less host time than filling fresh pinned buffers
        (PERF.md, the chunked dispatch).  The query register crosses once;
        each chunk's scores stay on the device, and all of them are copied
        back in one transfer after the last dispatch.

        Each chunk keeps its own stream length T and its own emission
        pattern: swtpu pads T to a power-of-two ladder so that equal chunks
        reuse one compiled executable, which a CUDA kernel does not need.
        ``padded_cells`` therefore counts each chunk's real T and is at
        most swtpu's.  The scores and ``cells`` equal swtpu's."""
        from swtpu_torch.utils.guards import check_stream_batch

        t0 = time.perf_counter()
        n_reads = len(tlens) if tlens is not None else len(targets)
        segments, rows, phys = stream_geometry(len(query), self.config, self.device)
        C = self.config.stream_chunk_reads
        chunked = bool(C) and n_reads > C
        C = C if chunked else max(n_reads, 1)
        S = phys * segments
        on_cuda = self.device.type == "cuda"
        wire = self.config.wire_2bit and on_cuda
        kw = dict(penalties=self.config.penalties, segments=segments, rows=rows,
                  **self._stream_modes())
        if chunked and on_cuda:
            put = _PinnedStager(self.device).put
        else:
            def put(*arrays):
                return [_put(a, self.device) for a in arrays]
        dq = None
        pending = []  # each chunk's scores, on the device
        cells = padded = 0
        for lo in range(0, max(n_reads, 1), C):  # an empty database is one empty chunk
            hi = min(lo + C, n_reads)
            if tlens is not None:
                batch = pack_streams(query, tmat[lo:hi], n_streams=S, segments=segments,
                                     lens=tlens[lo:hi], rows=rows)
            else:
                batch = pack_streams(query, [targets[i] for i in range(lo, hi)],
                                     n_streams=S, segments=segments, rows=rows)
            if self.verify_integrity:
                check_stream_batch(batch)
            if dq is None:
                dq = _put_query(batch.q, self.device)
            arrays = tuple(pack_stream_wire(batch.stream)) if wire else (batch.stream,)
            arrays += (batch.emit_stream, batch.emit_step.astype(np.int32))
            score = sw_scores_stream_packed if wire else sw_scores_stream
            longest = longest_read(tlens[lo:hi] if tlens is not None
                                   else map(len, targets[lo:hi]))
            with reads_up_to(longest):
                pending.append(score(dq, *put(*arrays), emit_regular=batch.emit_regular,
                                     **kw))
            cells += batch.cells
            # physical wavefront capacity: LANES DP rows per lane column per
            # step, shared by `segments` queries
            padded += S * batch.stream.shape[1] * (LANES // segments)
        scores = torch.cat(pending).cpu().numpy()
        if self.verify_integrity:
            self._check_scores(scores, query, targets, tlens)
        elapsed = time.perf_counter() - t0
        if event_log is not None:
            if chunked:
                kind, note = "stream_pipelined", f"chunks={len(pending)} chunk_reads={C} streams={S}"
            else:
                kind, note = "stream", f"streams={S} T={batch.stream.shape[1]}"
            event_log.emit(
                BatchEvent(
                    kind, t_wall=time.time(), elapsed_s=elapsed, reads=n_reads,
                    cells=cells, padded_cells=padded, note=note,
                )
            )
        return ScoreResult(scores, cells, padded, elapsed)

    def _score_database_stream_long(
        self, query, targets, event_log=None, tmat=None, tlens=None
    ) -> ScoreResult:
        """Queries over 128 bases on the streamed wavefront: K-tile chaining
        (swtpu_torch.ops.stream.sw_scores_stream_long), up to the
        reference's 4,095-base LEN_WIDTH envelope and beyond.  Ignores
        ``stream_chunk_reads``, as swtpu's long path does.  One job,
        dispatched on the current stream and finished."""
        job = self._dispatch_long(query, targets, tmat=tmat, tlens=tlens)
        return self._finish_long(job, event_log)

    def _dispatch_long(self, query, targets, tmat=None, tlens=None, stream=None) -> LongJob:
        """The first half of a long-query job: pack the reads
        (pack_streams_long, the 2-bit wire on CUDA), and on CUDA enqueue on
        `stream` (None: the current stream) the batch's copy from pinned
        memory, the K chained tiles, their boundary shifts, the gather and
        the scores' copy back into pinned memory, then return without
        waiting for the device.  On the CPU the plain versions run here."""
        t0 = time.perf_counter()
        n_reads = len(tlens) if tlens is not None else len(targets)
        _, rows, phys = stream_geometry(len(query), self.config, self.device)
        modes = self._stream_modes()
        if tlens is not None:
            batch = pack_streams_long(query, tmat, n_streams=phys, rows=rows, lens=tlens)
        else:
            batch = pack_streams_long(query, targets, n_streams=phys, rows=rows)
        if self.verify_integrity:
            from swtpu_torch.utils.guards import check_stream_batch

            check_stream_batch(batch)
        K = batch.q.shape[1] // LANES
        N, T = batch.stream.shape
        job = LongJob(
            query=query, targets=targets, tlens=tlens, n_reads=n_reads, cells=batch.cells,
            padded_cells=N * T * LANES * K, note=f"streams={N} T={T} tiles={K}", t0=t0,
        )
        on_cuda = self.device.type == "cuda"
        wire = self.config.wire_2bit and on_cuda
        # the same 2.5 bits/char crossing as the short-query path
        arrays = (batch.q, *(pack_stream_wire(batch.stream) if wire else (batch.stream,)),
                  batch.emit_stream, batch.emit_step.astype(np.int32))
        score = sw_scores_stream_long_packed if wire else sw_scores_stream_long
        kw = dict(rows=rows, emit_regular=batch.emit_regular, **modes)
        if not on_cuda:
            job.scores = score(*(_put(a, self.device) for a in arrays),
                               self.config.penalties, **kw)
            return job
        # every tensor of the job is made and read on this one stream
        with torch.cuda.stream(stream):
            scores = score(*_put_pinned(arrays, self.device), self.config.penalties, **kw)
            job.scores = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
            job.scores.copy_(scores, non_blocking=True)
            job.done = torch.cuda.Event()
            job.done.record()
        return job

    def _finish_long(self, job: LongJob, event_log=None, since=None) -> ScoreResult:
        """The second half of a long-query job: wait for its scores, run
        verify_integrity's bound check and emit its "stream_long" record,
        whose ``elapsed_s`` is the host time from `since` (default: the
        job's dispatch) to now."""
        if job.done is not None:
            job.done.synchronize()
        scores = job.scores.numpy().copy()
        if self.verify_integrity:
            self._check_scores(scores, job.query, job.targets, job.tlens)
        job.scores = job.targets = job.tlens = None
        elapsed = time.perf_counter() - (job.t0 if since is None else since)
        if event_log is not None:
            event_log.emit(
                BatchEvent(
                    "stream_long", t_wall=time.time(), elapsed_s=elapsed,
                    reads=job.n_reads, cells=job.cells, padded_cells=job.padded_cells,
                    note=job.note,
                )
            )
        return ScoreResult(scores, job.cells, job.padded_cells, elapsed)

    def _score_batch(self, q: np.ndarray, t: np.ndarray) -> np.ndarray:
        """One dense bucket batch through the column kernels on the bank's
        device (or the scan, or a callable backend): q [B, m], t [B, n]
        int8 -> [B] int32 scores."""
        if callable(self.backend):
            return np.asarray(self.backend(q, t, self.config.penalties))
        if self.backend == "scan":
            return sw_scores_scan(
                _put(q, self.device), _put(t, self.device), self.config.penalties
            ).cpu().numpy()
        kw = {}
        if self.config.score_width is not None:
            kw = dict(state_dtype="int16_biased", score_width=self.config.score_width)
        s = sw_scores_column(
            _put(q, self.device), _put(t, self.device), self.config.penalties, **kw
        )
        return s.cpu().numpy()

    def _bucket_batches(self, query, targets) -> list:
        """score_database's dense batches on the pallas backend: the reads
        packed into ``SWConfig.target_buckets``, one PackedBatch per
        non-empty bucket, the query padded to a multiple of 8."""
        tmat, tlens = _dense_form(targets)
        return pack_many_vs_one(
            query,
            tmat if tlens is not None else targets,
            bucket_lens=self.config.target_buckets,
            q_width=max(8, -(-len(query) // 8) * 8),
            lens=tlens,
        )

    def _pair_batches(self, queries, targets):
        """score_pairs' dense batches: one PackedBatch per (query bucket,
        target bucket) group (``SWConfig.query_buckets``,
        ``target_buckets``), ids the pairs' submission indices."""
        cfg = self.config
        t_plan = plan_buckets([len(t) for t in targets], cfg.target_buckets)
        q_plan = plan_buckets([len(q) for q in queries], cfg.query_buckets)
        groups = {}
        for i in range(len(queries)):
            groups.setdefault((q_plan.assignments[i], t_plan.assignments[i]), []).append(i)
        for (qb, tb), idxs in groups.items():
            yield pack_pairs(
                [queries[i] for i in idxs],
                [targets[i] for i in idxs],
                q_width=q_plan.bucket_lens[qb],
                t_width=t_plan.bucket_lens[tb],
                ids=np.asarray(idxs, np.int32),
            )

    def _score_database_bucketed(self, query, targets, event_log=None) -> ScoreResult:
        """The bucketed column path: reads pack into dense length buckets,
        one column-kernel call per bucket, scores scattered back to read
        order."""
        cfg = self.config
        t0 = time.perf_counter()
        _, tlens = _dense_form(targets)
        n_reads = len(tlens) if tlens is not None else len(targets)
        scores = np.zeros((n_reads,), dtype=np.int32)
        cells = 0
        padded = 0
        for batch in self._bucket_batches(query, targets):
            tb = time.perf_counter()
            if self.verify_integrity:
                from swtpu_torch.utils.guards import (
                    check_packed_query, check_packed_target,
                )

                check_packed_query(batch.q, batch.q_lens)
                check_packed_target(batch.t, batch.t_lens)
            s = self._score_batch(batch.q, batch.t)
            if self.verify_integrity:
                from swtpu_torch.utils.guards import check_scores

                check_scores(s, batch.q_lens, batch.t_lens, cfg.penalties.match)
            live = batch.ids >= 0
            scores[batch.ids[live]] = s[live]
            cells += batch.cells
            padded += batch.padded_cells
            if event_log is not None:
                event_log.emit(
                    BatchEvent(
                        "batch", t_wall=time.time(),
                        elapsed_s=time.perf_counter() - tb,
                        reads=int(live.sum()), cells=batch.cells,
                        padded_cells=batch.padded_cells,
                        note=f"bucket_len={batch.t.shape[1]}",
                    )
                )
        return ScoreResult(scores, cells, padded, time.perf_counter() - t0)

    def score_pairs(self, queries, targets, event_log=None) -> ScoreResult:
        """Score explicit (query, target) pairs (many-vs-many workloads);
        results return in submission order.

        On the stream backend, the pairs whose query fits one wavefront
        tile (128 bases) ride pair streams, each distinct query in its own
        streams' query registers; each distinct longer query's pairs run
        as one chained many-vs-one job.  On the pallas backend, pairs are
        grouped by (query bucket, target bucket)
        (``SWConfig.query_buckets``, ``target_buckets``) and each group is
        one dense column-kernel call.

        event_log: optional :class:`swtpu_torch.utils.metrics.EventLog`
        receiving one "pair_stream" record per pair-stream call and one
        "stream_long" record per long query, or on the pallas backend one
        "pair_batch" record per group."""
        if len(queries) != len(targets):
            raise ValueError("queries and targets must pair up")
        if self.backend == "stream":
            if all(len(q) <= LANES for q in queries):
                return self._score_pairs_stream(queries, targets, event_log)
            return self._score_pairs_stream_mixed(queries, targets, event_log)
        t0 = time.perf_counter()
        scores = np.zeros((len(queries),), dtype=np.int32)
        cells = padded = 0
        tc = time.perf_counter()
        for batch in self._pair_batches(queries, targets):
            s = self._score_batch(batch.q, batch.t)
            scores[batch.ids] = s
            cells += batch.cells
            padded += batch.padded_cells
            if event_log is not None:
                event_log.emit(
                    BatchEvent(
                        "pair_batch", t_wall=time.time(),
                        elapsed_s=time.perf_counter() - tc,
                        reads=len(batch.ids), cells=batch.cells,
                        padded_cells=batch.padded_cells,
                        note=f"q_width={batch.q.shape[1]} t_width={batch.t.shape[1]}",
                    )
                )
            tc = time.perf_counter()
        return ScoreResult(scores, cells, padded, time.perf_counter() - t0)

    def _score_pairs_stream_mixed(self, queries, targets, event_log=None) -> ScoreResult:
        """Pair sets with a query longer than one wavefront tile: the pairs
        whose query fits one tile go through the pair streams together;
        each distinct long query's pairs become one many-vs-one job on the
        chained tiles (deduped, so pairs sharing a 500-base query share
        one pack and one chain).

        On CUDA the jobs run side by side: job u is dispatched on CUDA
        stream u mod JOB_STREAMS, so the host packs job u + 1 while the
        card runs the jobs before it, and the thin launches of several jobs
        share the card.  When JOB_WINDOW jobs are in flight, the oldest is
        finished before the next is dispatched.  Jobs finish, and emit
        their "stream_long" records, in job order; each record's
        ``elapsed_s`` is the host time from the previous job's finish (the
        first: from the first dispatch) to its own, so that a set's records
        add up to its long jobs' wall.  On the CPU the same loop runs
        without streams."""
        t0 = time.perf_counter()
        n = len(queries)
        short_idx = [i for i in range(n) if len(queries[i]) <= LANES]
        long_idx = [i for i in range(n) if len(queries[i]) > LANES]
        scores = np.zeros((n,), dtype=np.int32)
        cells = padded = 0
        if short_idx:
            res = self._score_pairs_stream(
                [queries[i] for i in short_idx], [targets[i] for i in short_idx],
                event_log,
            )
            scores[np.asarray(short_idx, np.int64)] = res.scores
            cells += res.cells
            padded += res.padded_cells
        qlist, uid = dedupe_queries([queries[i] for i in long_idx])
        groups: list = [[] for _ in qlist]
        for pos, i in enumerate(long_idx):
            groups[uid[pos]].append(i)
        streams = [None]
        if self.device.type == "cuda":
            while len(self._job_streams) < JOB_STREAMS:
                self._job_streams.append(torch.cuda.Stream(self.device))
            streams = self._job_streams
        in_flight = collections.deque()  # (job, its pairs)
        since = [time.perf_counter()]  # the last finish

        def finish_oldest():
            job, group = in_flight.popleft()
            res = self._finish_long(job, event_log, since=since[0])
            since[0] += res.elapsed_s
            scores[np.asarray(group, np.int64)] = res.scores

        for u, group in enumerate(groups):
            if len(in_flight) >= JOB_WINDOW:
                finish_oldest()
            job = self._dispatch_long(qlist[u], [targets[i] for i in group],
                                      stream=streams[u % len(streams)])
            in_flight.append((job, group))
            cells += job.cells
            padded += job.padded_cells
        while in_flight:
            finish_oldest()
        return ScoreResult(scores, cells, padded, time.perf_counter() - t0)

    def _score_pairs_stream(self, queries, targets, event_log=None) -> ScoreResult:
        """Many-vs-many on the streamed wavefront: distinct queries load
        into per-stream query registers (pack_pair_streams) and targets
        ride streams owned by their query.  A pair set with more distinct
        queries than logical streams (S = phys x segments) takes one
        wavefront call per S distinct queries."""
        t0 = time.perf_counter()
        n = len(queries)
        qmax = max((len(q) for q in queries), default=0)
        segments, rows, phys = stream_geometry(qmax, self.config, self.device)
        S = phys * segments
        modes = self._stream_modes()
        # group pair indices by distinct query (the packer's own dedup, so
        # the chunk bound and the packer's count always agree); chunk the
        # groups to <= S queries
        qlist, uid = dedupe_queries(queries)
        groups: list = [[] for _ in qlist]
        for i, u in enumerate(uid):
            groups[u].append(i)
        chunks = [groups[i : i + S] for i in range(0, len(groups), S)]
        scores = np.zeros((n,), dtype=np.int32)
        cells = padded = 0
        for chunk in chunks:
            tc = time.perf_counter()
            idxs = [i for g in chunk for i in g]
            batch = pack_pair_streams(
                [queries[i] for i in idxs], [targets[i] for i in idxs],
                n_streams=S, segments=segments, rows=rows,
            )
            if self.verify_integrity:
                from swtpu_torch.utils.guards import check_stream_batch

                check_stream_batch(batch)
            d = batch_to_device(batch, self.device)
            with reads_up_to(longest_read(len(targets[i]) for i in idxs)):
                s = sw_scores_stream(
                    d.q, d.stream, d.emit_stream, d.emit_step, self.config.penalties,
                    segments=segments, rows=rows, emit_regular=batch.emit_regular,
                    **modes,
                ).cpu().numpy()
            if self.verify_integrity:
                from swtpu_torch.utils.guards import check_scores

                check_scores(
                    s,
                    np.fromiter((len(queries[i]) for i in idxs), np.int64),
                    np.fromiter((len(targets[i]) for i in idxs), np.int64),
                    self.config.penalties.match,
                )
            scores[np.asarray(idxs, np.int64)] = s
            cells += batch.cells
            # the same accounting as score_database's: stream rows x steps
            # x wavefront rows a lane column
            chunk_padded = batch.stream.shape[0] * batch.stream.shape[1] * (LANES // segments)
            padded += chunk_padded
            if event_log is not None:
                event_log.emit(
                    BatchEvent(
                        "pair_stream", t_wall=time.time(),
                        elapsed_s=time.perf_counter() - tc,
                        reads=len(idxs), cells=batch.cells,
                        padded_cells=chunk_padded,
                        note=f"streams={batch.stream.shape[0]} "
                        f"T={batch.stream.shape[1]} queries={len(chunk)}",
                    )
                )
        return ScoreResult(scores, cells, padded, time.perf_counter() - t0)

    def load_database(self, targets, max_query_len: int = 128) -> LoadedDatabase:
        """Pack `targets` once and leave the stream resident on the device.

        The stream crosses to the device once (the 2.5-bit wire on CUDA
        with ``wire_2bit``) and is laid out there as the kernel reads it,
        [T, N]; every later :meth:`score_loaded` ships only the query
        register and reads back n_reads int32 scores.  `max_query_len`
        sets the query capacity: past 128 bases the stream gains the
        chained tiles' extra drain steps (pack once, serve any length up
        to it); at 32 or fewer bases the database packs segments=4 (64:
        segments=2), as score_database does for such a query.

        Requires the stream backend."""
        if self.backend != "stream":
            raise ValueError(
                f"load_database requires the stream backend (got {self.backend!r})"
            )
        segments, rows, phys = stream_geometry(max_query_len, self.config, self.device)
        tmat, tlens = _dense_form(targets)
        k_max = max(1, -(-int(max_query_len) // LANES))
        src = targets if tlens is None else tmat
        t0 = time.perf_counter()
        # a probe query: the stream layout and the emission coordinates do
        # not depend on the query (drain = 128//(rows*segments) - 1); for a
        # multi-tile capacity pack_streams_long adds the extra drain
        if k_max > 1:
            batch = pack_streams_long(np.zeros(k_max * LANES, np.int8), src,
                                      n_streams=phys, rows=rows, lens=tlens)
        else:
            batch = pack_streams(np.zeros(1, np.int8), src, n_streams=phys * segments,
                                 segments=segments, lens=tlens, rows=rows)
        t_lens = (np.asarray(tlens, np.int64) if tlens is not None
                  else np.fromiter((len(t) for t in targets), np.int64, len(targets)))
        # the probe's cell count means nothing: _finish_loaded counts the
        # served query's cells
        batch.cells = 0
        if self.verify_integrity:
            from swtpu_torch.utils.guards import check_stream_batch

            check_stream_batch(batch)
        t1 = t2 = time.perf_counter()
        on_cuda = self.device.type == "cuda"
        if self.config.wire_2bit and on_cuda:
            codes, flags = pack_stream_wire(batch.stream)
            t2 = time.perf_counter()
            stream = unpack_stream_wire(
                _put(codes, self.device), _put(flags, self.device)
            ).t().contiguous()
        else:
            stream = _put(batch.stream.T, self.device)
        emit = [_put(a.astype(np.int32), self.device)
                for a in (batch.emit_stream, batch.emit_step)]
        if on_cuda:
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        return LoadedDatabase(
            stream=stream,
            emit_stream_dev=emit[0],
            emit_step_dev=emit[1],
            t_lens=t_lens,
            total_chars=int(t_lens.sum()),
            n_reads=len(t_lens),
            rows=rows,
            k_max=k_max,
            segments=segments,
            emit_regular=batch.emit_regular,
            load_s={"pack": t1 - t0, "wire": t2 - t1, "device": t3 - t2},
        )

    def _dispatch_loaded(self, query: np.ndarray, db: LoadedDatabase) -> torch.Tensor:
        """Enqueue one query against a loaded database; returns the scores
        [n_reads] int32 on the device, without waiting for them."""
        query = np.asarray(query, np.int8)
        N = db.stream.shape[1]
        qcap = LANES // db.segments
        kw = dict(penalties=self.config.penalties, rows=db.rows,
                  emit_regular=db.emit_regular, **self._stream_modes())
        short = len(query) <= qcap
        if short:
            width = qcap
        elif db.segments > 1:
            raise ValueError(
                f"query of {len(query)} bases exceeds the segmented "
                f"capacity {qcap} this database was loaded for — reload "
                "with a larger max_query_len"
            )
        else:
            K = -(-len(query) // LANES)
            if K > db.k_max:
                raise ValueError(
                    f"query of {len(query)} bases needs {K} tiles; database "
                    f"was loaded with max_query_len for {db.k_max} — reload "
                    "with a larger max_query_len"
                )
            width = K * LANES
        # the register: the query in every stream, sentinel-padded
        q = torch.full((N, width), Q_PAD, dtype=torch.int8, device=self.device)
        q[:, : len(query)] = _put_query(query, self.device)
        if short:
            with reads_up_to(longest_read(db.t_lens)):
                return sw_scores_stream_kernel_layout(
                    _q_kernel_layout(q, db.segments, db.rows), db.stream,
                    db.emit_stream_dev, db.emit_step_dev, segments=db.segments, **kw,
                )
        # the chained tiles read the resident [T, N] stream as it is
        return sw_scores_stream_long_kernel_layout(
            q, db.stream, db.emit_stream_dev, db.emit_step_dev, **kw,
        )

    def _finish_loaded(self, dev_scores, query, db: LoadedDatabase, t0,
                       elapsed_override=None, event_log=None, kind="loaded") -> ScoreResult:
        """Copy a dispatched query's scores to the host (waiting for
        them) and account for them."""
        scores = dev_scores.cpu().numpy()
        if self.verify_integrity:
            from swtpu_torch.utils.guards import check_scores

            check_scores(
                scores, np.full(db.n_reads, len(query)), db.t_lens,
                self.config.penalties.match,
            )
        cells = int(len(query)) * db.total_chars
        # K query tiles each sweep the wavefront's capacity (128//segments
        # rows a logical stream position), as on the database paths
        K = max(1, -(-len(query) // LANES))
        T, N = db.stream.shape
        padded = int(T) * int(N) * (LANES // db.segments) * K
        elapsed = (
            elapsed_override if elapsed_override is not None
            else time.perf_counter() - t0
        )
        if event_log is not None:
            event_log.emit(
                BatchEvent(
                    kind, t_wall=time.time(), elapsed_s=elapsed,
                    reads=db.n_reads, cells=cells, padded_cells=padded,
                    note=f"qlen={len(query)} resident_reads={db.n_reads}",
                )
            )
        return ScoreResult(scores, cells, padded, elapsed)

    def score_loaded(self, query: np.ndarray, db: LoadedDatabase,
                     event_log=None) -> ScoreResult:
        """Score `query` against a device-resident database: only the
        query register crosses to the device; the stream stays there.
        event_log receives one "loaded" record."""
        t0 = time.perf_counter()
        return self._finish_loaded(
            self._dispatch_loaded(query, db), query, db, t0, event_log=event_log,
        )

    def score_loaded_many(self, queries: Sequence[np.ndarray], db: LoadedDatabase,
                          event_log=None) -> List[ScoreResult]:
        """Score a batch of queries against one loaded database: every
        query is enqueued before any result is copied back, so the host's
        work on one query overlaps the device's on the ones before.

        Each result's `elapsed_s` is the batch's wall time divided evenly
        (a single query's time is not observable here); their sum is the
        batch's time.  event_log receives one "loaded_many" record a
        query."""
        t0 = time.perf_counter()
        devs = [self._dispatch_loaded(q, db) for q in queries]
        devs = [d.cpu() for d in devs]  # copied back in dispatch order
        share = (time.perf_counter() - t0) / max(len(queries), 1)
        return [
            self._finish_loaded(d, q, db, t0, elapsed_override=share,
                                event_log=event_log, kind="loaded_many")
            for d, q in zip(devs, queries)
        ]

    def _dispatch_topk_loaded(self, query, db: LoadedDatabase, k: int):
        """Enqueue a query and its top-k cut on the device; returns the
        (scores [k], ids [k]) device tensors without waiting for them."""
        dev = self._dispatch_loaded(query, db)
        ids = torch.arange(db.n_reads, dtype=torch.int32, device=self.device)
        return _local_topk(dev, ids, min(k, db.n_reads))

    def _finish_topk_loaded(self, devs, query, db: LoadedDatabase, t0,
                            event_log=None) -> List[tuple]:
        """Copy a dispatched top-k to the host; event_log receives one
        "loaded_topk" record."""
        fs, fids = devs[0].cpu().numpy(), devs[1].cpu().numpy()
        if event_log is not None:
            event_log.emit(
                BatchEvent(
                    "loaded_topk", t_wall=time.time(),
                    elapsed_s=time.perf_counter() - t0, reads=db.n_reads,
                    cells=int(len(query)) * db.total_chars, padded_cells=0,
                    note=f"qlen={len(query)} k={len(fs)}",
                )
            )
        return [(int(s), int(i)) for s, i in zip(fs, fids)]

    def topk_loaded(self, query: np.ndarray, db: LoadedDatabase, k: int = 10,
                    event_log=None) -> List[tuple]:
        """The best k (score, read index) hits of `query` against a loaded
        database, cut on the device: only 2k values are copied back.  The
        order is ScoreResult.top_k's: score descending, then read index
        ascending."""
        t0 = time.perf_counter()
        devs = self._dispatch_topk_loaded(query, db, k)
        return self._finish_topk_loaded(devs, query, db, t0, event_log=event_log)

    def load_database_sharded(self, targets, mesh, max_query_len: int = 128,
                              axis: str = "data"):
        """Mesh-wide :meth:`load_database`: one resident stream shard a
        mesh shard, each on its device (``swtpu_torch.bank.serving``)."""
        from swtpu_torch.bank.serving import load_database_sharded

        return load_database_sharded(self, targets, mesh, max_query_len=max_query_len,
                                     axis=axis)

    def score_loaded_sharded(self, query, db, event_log=None) -> ScoreResult:
        """Score one query against a mesh-resident database: the full
        read-order score vector."""
        from swtpu_torch.bank.serving import score_loaded_sharded

        return score_loaded_sharded(self, query, db, event_log=event_log)

    def score_loaded_many_sharded(self, queries, db, event_log=None) -> List[ScoreResult]:
        """Many queries over the mesh, every one enqueued before any result
        is copied back."""
        from swtpu_torch.bank.serving import score_loaded_many_sharded

        return score_loaded_many_sharded(self, queries, db, event_log=event_log)

    def topk_loaded_sharded(self, query, db, k: int = 10, event_log=None) -> List[tuple]:
        """Mesh-wide best hits: each shard's cut, the merge over the mesh;
        only 2k values are copied back."""
        from swtpu_torch.bank.serving import topk_loaded_sharded

        return topk_loaded_sharded(self, query, db, k=k, event_log=event_log)

"""ScoreBank — the batched many-vs-one scoring engine on torch.

The port of ``swtpu.bank.scorebank``'s main path: ``score_database`` on the
streamed wavefront.  The host packs the reads into flagged char streams
(``swtpu_torch.bank.streams``), the streams cross to the device (2-bit
packed on CUDA), the wavefront writes its [T, N] strip and the emission
gather returns the scores in read order.  A query longer than 128 bases
chains K tiles of 128 query rows over the same streams.  On a CUDA device
the wavefront is the hand-written kernel; on the CPU it is the plain
PyTorch version, with the settings swtpu uses in interpret mode, so both
packages pack the same batch there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from swtpu.config import SWConfig
from swtpu.io.loader import EncodedDB
from swtpu_torch.bank.streams import (
    LANES, batch_to_device, pack_stream_wire, pack_streams, pack_streams_long,
)
from swtpu_torch.ops.stream import (
    sw_scores_stream, sw_scores_stream_long, sw_scores_stream_long_packed,
    sw_scores_stream_packed,
)


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


def stream_geometry(query_len: int, config: SWConfig, device) -> tuple:
    """(segments, rows, phys) of the streamed wavefront for a query of
    `query_len` bases on `device`: swtpu's device settings on CUDA, its
    interpret settings on the CPU, so both packages pack the same batch.
    A query over 128 bases (the chained tiles) takes segments 1."""
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


class ScoreBank:
    """Batched many-vs-one scorer on one torch device.

    backend: 'auto' or 'stream' (the streamed wavefront; the port's only
    backend so far).  device: where the wavefront runs — 'cuda' launches
    the CUDA kernel, 'cpu' runs its plain PyTorch version."""

    def __init__(
        self,
        config: SWConfig = SWConfig(),
        backend: str = "auto",
        device="cuda",
        verify_integrity: bool = False,
    ):
        if backend not in ("auto", "stream"):
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet (ROADMAP: scan "
                "backend; B4/B5 column kernels); use 'stream'"
            )
        if config.score_width is not None:
            raise NotImplementedError(
                "score_width is not ported yet (ROADMAP: score_width "
                "through the CUDA kernel)"
            )
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ScoreBank(device={str(self.device)!r}): no CUDA device "
                "is available"
            )
        self.config = config
        self.backend = "stream"
        # validate packed batches and score bounds; off by default
        self.verify_integrity = verify_integrity

    def _stream_dtype(self) -> str:
        sdt = self.config.stream_state_dtype
        if sdt in ("auto", "int32"):
            # swtpu's "auto" is float32 on the TPU, where it measured
            # faster on the VPU; the scores are identical, and the port's
            # kernel carries int32 state
            return "int32"
        raise NotImplementedError(
            f"stream_state_dtype={sdt!r} is not ported yet (ROADMAP: "
            "float32 state on CUDA); the port carries int32 state"
        )

    def score_database(self, query: np.ndarray, targets, event_log=None) -> ScoreResult:
        """Score every target read against `query`; returns read-order scores.

        targets: a sequence of 1-D code arrays, an
        :class:`swtpu.io.loader.EncodedDB`, or a (mat, lens) tuple (the
        dense forms: the database stays one int8 matrix).

        event_log: optional swtpu.utils.EventLog receiving one "stream"
        record per call ("stream_long" for a query over 128 bases)."""
        tmat, tlens = _dense_form(targets)
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
        per stream, no length buckets."""
        t0 = time.perf_counter()
        n_reads = len(tlens) if tlens is not None else len(targets)
        segments, rows, phys = stream_geometry(len(query), self.config, self.device)
        on_cuda = self.device.type == "cuda"
        chunk_reads = self.config.stream_chunk_reads
        if chunk_reads and n_reads > chunk_reads:
            raise NotImplementedError(
                "stream_chunk_reads is not ported yet (ROADMAP: chunked "
                "overlap/resume)"
            )
        self._stream_dtype()
        if tlens is not None:
            batch = pack_streams(
                query, tmat, n_streams=phys * segments, segments=segments,
                lens=tlens, rows=rows,
            )
        else:
            batch = pack_streams(
                query, targets, n_streams=phys * segments, segments=segments,
                rows=rows,
            )
        if self.verify_integrity:
            from swtpu_torch.utils.guards import check_stream_batch

            check_stream_batch(batch)
        pen = self.config.penalties
        if self.config.wire_2bit and on_cuda:
            # the stream crosses at 2.5 bits/char and expands on the device
            codes, flags = pack_stream_wire(batch.stream)
            scores = sw_scores_stream_packed(
                *(_put(a, self.device) for a in (
                    batch.q, codes, flags, batch.emit_stream,
                    batch.emit_step.astype(np.int32),
                )), pen,
                segments=segments, rows=rows, emit_regular=batch.emit_regular,
            )
        else:
            d = batch_to_device(batch, self.device)
            scores = sw_scores_stream(
                d.q, d.stream, d.emit_stream, d.emit_step, pen,
                segments=segments, rows=rows, emit_regular=batch.emit_regular,
            )
        scores = scores.cpu().numpy()
        if self.verify_integrity:
            self._check_scores(scores, query, targets, tlens)
        elapsed = time.perf_counter() - t0
        # physical wavefront capacity: LANES DP rows per lane column per
        # step, shared by `segments` queries
        padded = batch.stream.shape[0] * batch.stream.shape[1] * (LANES // segments)
        if event_log is not None:
            from swtpu.utils.metrics import BatchEvent

            event_log.emit(
                BatchEvent(
                    "stream", t_wall=time.time(), elapsed_s=elapsed,
                    reads=n_reads, cells=batch.cells, padded_cells=padded,
                    note=f"streams={batch.stream.shape[0]} T={batch.stream.shape[1]}",
                )
            )
        return ScoreResult(scores, batch.cells, padded, elapsed)

    def _score_database_stream_long(
        self, query, targets, event_log=None, tmat=None, tlens=None
    ) -> ScoreResult:
        """Queries over 128 bases on the streamed wavefront: K-tile chaining
        (swtpu_torch.ops.stream.sw_scores_stream_long), up to the
        reference's 4,095-base LEN_WIDTH envelope and beyond.  Ignores
        ``stream_chunk_reads``, as swtpu's long path does."""
        t0 = time.perf_counter()
        n_reads = len(tlens) if tlens is not None else len(targets)
        _, rows, phys = stream_geometry(len(query), self.config, self.device)
        self._stream_dtype()
        if tlens is not None:
            batch = pack_streams_long(query, tmat, n_streams=phys, rows=rows, lens=tlens)
        else:
            batch = pack_streams_long(query, targets, n_streams=phys, rows=rows)
        if self.verify_integrity:
            from swtpu_torch.utils.guards import check_stream_batch

            check_stream_batch(batch)
        pen = self.config.penalties
        q = _put(batch.q, self.device)
        emit = (
            _put(batch.emit_stream, self.device),
            _put(batch.emit_step.astype(np.int32), self.device),
        )
        if self.config.wire_2bit and self.device.type == "cuda":
            # the same 2.5 bits/char crossing as the short-query path
            codes, flags = pack_stream_wire(batch.stream)
            scores = sw_scores_stream_long_packed(
                q, _put(codes, self.device), _put(flags, self.device), *emit,
                pen, rows=rows, emit_regular=batch.emit_regular,
            )
        else:
            scores = sw_scores_stream_long(
                q, _put(batch.stream, self.device), *emit, pen, rows=rows,
                emit_regular=batch.emit_regular,
            )
        scores = scores.cpu().numpy()
        if self.verify_integrity:
            self._check_scores(scores, query, targets, tlens)
        elapsed = time.perf_counter() - t0
        K = batch.q.shape[1] // LANES
        padded = batch.stream.shape[0] * batch.stream.shape[1] * LANES * K
        if event_log is not None:
            from swtpu.utils.metrics import BatchEvent

            event_log.emit(
                BatchEvent(
                    "stream_long", t_wall=time.time(), elapsed_s=elapsed,
                    reads=n_reads, cells=batch.cells, padded_cells=padded,
                    note=f"streams={batch.stream.shape[0]} "
                    f"T={batch.stream.shape[1]} tiles={K}",
                )
            )
        return ScoreResult(scores, batch.cells, padded, elapsed)

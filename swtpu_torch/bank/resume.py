"""Resumable scoring jobs: a long database scan that survives a crash.

The port of ``swtpu.bank.resume``.  The reference's WED (work element
descriptor) is a restartable job record with status and progress fields;
here a job state file holds a fingerprint of the inputs, a bitmap of the
finished work units and the scores so far, written atomically after every
unit.  A rerun with the same inputs adopts it and scores only the units
still open.

On the stream backend a unit is a chunk of reads scored through
``ScoreBank.score_database`` at the wavefront's speed; on the other
backends it is one bucket batch of ``pack_many_vs_one``.

The state file is the one thing the two packages share: its version, its
fingerprint and its ``.npz`` fields are swtpu's byte for byte, so a job
that one package started, the other finishes.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np

from swtpu_torch.bank.scorebank import ScoreBank, ScoreResult, _dense_form

STATE_VERSION = 2
# reads a stream-backend unit holds unless the caller says: on the card
# about 33.6 MB of stream at 128 bases (a [512, 65,568] int8 stream);
# swtpu's interpret-mode size on the CPU
CHUNK_READS_CUDA = 1 << 18
CHUNK_READS_CPU = 8


def _fingerprint(query: np.ndarray, targets, config, extra: str = "") -> str:
    """The job's identity: the query, every read and whatever changes a
    score (the penalties, the buckets, ``score_width``), plus `extra` (the
    stream backend's unit size).  Equal to swtpu's on the same inputs."""
    h = hashlib.sha256()
    h.update(np.asarray(query, np.int8).tobytes())
    tmat, tlens = _dense_form(targets)
    if tlens is not None:
        # a dense database hashes as two flat buffers
        h.update(np.int64(len(tlens)).tobytes())
        h.update(np.asarray(tlens, np.int64).tobytes())
        h.update(np.ascontiguousarray(tmat, dtype=np.int8).tobytes())
    else:
        h.update(np.int64(len(targets)).tobytes())
        for t in targets:
            h.update(np.int64(len(t)).tobytes())
            h.update(np.asarray(t, np.int8).tobytes())
    h.update(
        json.dumps(
            [
                config.penalties.astuple(), list(config.target_buckets),
                # wrap-parity changes every score, so it must void prior state
                config.score_width, extra,
            ]
        ).encode()
    )
    return h.hexdigest()[:32]


def _load_state(state_path: Path, fp: str, n_units: int, scores, done, padded=None):
    """Adopt a matching earlier job's progress into (scores, done, padded)
    in place; a missing file or another job's leaves them as they are."""
    if not state_path.exists():
        return
    st = np.load(state_path, allow_pickle=False)
    if (
        st["version"] == STATE_VERSION
        and st["fingerprint"] == fp
        and st["n_batches"] == n_units
    ):
        scores[:] = st["scores"]
        done[:] = st["done"]
        if padded is not None and "padded" in st.files:
            padded[:] = st["padded"]


def _save_state(state_path: Path, fp: str, n_units: int, scores, done, padded=None):
    """Write the job's state next to `state_path` and move it into place,
    so a crash leaves either the old state or the new one."""
    tmp = state_path.with_suffix(".tmp.npz")
    extra = {} if padded is None else {"padded": padded}
    np.savez(
        tmp, version=STATE_VERSION, fingerprint=fp,
        n_batches=n_units, scores=scores, done=done, **extra,
    )
    os.replace(tmp, state_path)


def score_database_resumable(
    bank: ScoreBank,
    query: np.ndarray,
    targets,
    state_path: Union[str, Path],
    chunk_reads: Optional[int] = None,
) -> ScoreResult:
    """ScoreBank.score_database that saves its progress after each work
    unit to `state_path`; if that file already holds this job, its
    finished units are not scored again.

    On the stream backend a unit is a chunk of `chunk_reads` reads (default
    2^18 on CUDA, 8 on the CPU); on the other backends it is one bucket
    batch."""
    state_path = Path(state_path)
    if bank.backend == "stream":
        return _resumable_stream(bank, query, targets, state_path, chunk_reads)
    fp = _fingerprint(query, targets, bank.config)
    t0 = time.perf_counter()
    batches = bank._bucket_batches(query, targets)
    n_batches = len(batches)
    _, tlens = _dense_form(targets)
    scores = np.zeros((len(tlens) if tlens is not None else len(targets),), dtype=np.int32)
    done = np.zeros((n_batches,), dtype=bool)
    _load_state(state_path, fp, n_batches, scores, done)

    cells = padded = 0
    for bi, batch in enumerate(batches):
        cells += batch.cells
        padded += batch.padded_cells
        if done[bi]:
            continue
        s = bank._score_batch(batch.q, batch.t)
        live = batch.ids >= 0
        scores[batch.ids[live]] = s[live]
        done[bi] = True
        _save_state(state_path, fp, n_batches, scores, done)
    return ScoreResult(scores, cells, padded, time.perf_counter() - t0)


def _resumable_stream(
    bank: ScoreBank, query: np.ndarray, targets, state_path: Path,
    chunk_reads: Optional[int],
) -> ScoreResult:
    """The stream backend's units: read-range chunks, each scored by the
    bank's own stream dispatch (packing, wire, guards).  Each chunk's padded
    cells are kept in the state too, so a resumed job reports the totals
    of an uninterrupted one."""
    t0 = time.perf_counter()
    if chunk_reads is None:
        chunk_reads = CHUNK_READS_CUDA if bank.device.type == "cuda" else CHUNK_READS_CPU
    tmat, tlens = _dense_form(targets)
    n_reads = len(tlens) if tlens is not None else len(targets)
    fp = _fingerprint(query, targets, bank.config, extra=f"stream/{chunk_reads}")
    n_chunks = max(1, -(-n_reads // chunk_reads))
    scores = np.zeros((n_reads,), dtype=np.int32)
    done = np.zeros((n_chunks,), dtype=bool)
    chunk_padded = np.zeros((n_chunks,), dtype=np.int64)
    _load_state(state_path, fp, n_chunks, scores, done, chunk_padded)

    cells = 0
    for ci in range(n_chunks):
        lo, hi = ci * chunk_reads, min((ci + 1) * chunk_reads, n_reads)
        if done[ci]:
            # the chunk's real cells, without packing it again
            if tlens is not None:
                cells += int(len(query)) * int(np.asarray(tlens[lo:hi], np.int64).sum())
            else:
                cells += len(query) * sum(len(targets[i]) for i in range(lo, hi))
            continue
        chunk = (
            (tmat[lo:hi], tlens[lo:hi]) if tlens is not None
            else [targets[i] for i in range(lo, hi)]
        )
        res = bank.score_database(query, chunk)
        scores[lo:hi] = res.scores
        cells += res.cells
        chunk_padded[ci] = res.padded_cells
        done[ci] = True
        _save_state(state_path, fp, n_chunks, scores, done, chunk_padded)
    return ScoreResult(scores, cells, int(chunk_padded.sum()), time.perf_counter() - t0)
